// A JPEG decoder whose output is bit for bit libjpeg-turbo's (jpeg-6b API,
// the defaults a plain jpeg_read_header / jpeg_start_decompress gives):
// JDCT_ISLOW as its SIMD code computes it (jidctint-avx2.asm, which differs
// from jidctint.c at the extremes: see idct_islow), fancy upsampling (jdsample.c: h2v1, h2v2 with context rows,
// h1v2, int_upsample and the box upsamplers it falls back to below three
// samples a row) and the table-driven YCbCr -> RGB of jdcolor.c.
//
// Reads SOF0, SOF1 and SOF2 at 8-bit precision with 1, 3 or 4
// components, sampling factors 1-4, DQT (8- and 16-bit), DHT, DRI /
// RST0-7 and every progressive scan kind (spectral selection, successive
// approximation of DC and AC, EOB runs). Four components are CMYK, or
// YCCK (an Adobe marker with a transform other than 0) taken to CMYK by
// jdcolor.c's ycck_cmyk_convert. Integer arithmetic only.
//
// C interface (ctypes, utils/jpeg.py):
//   int gpt_jpeg_info(data, n, dims[3], err, errlen)  -> height, width,
//       components of the frame;
//   int gpt_jpeg_decode(data, n, out, h, w, colour, err, errlen) -> out
//       [h, w, 3] uint8 RGB, grey replicated, or [h, w, 4] CMYK for four
//       components (as libjpeg gives it: PIL's "CMYK;I" inverts it after).
//       colour 0 picks three components' colour space as libjpeg does
//       (JFIF, Adobe, component ids), 1 keeps the components as they are
//       (libtiff's JCS_UNKNOWN), 2 reads them as YCbCr.
// Both return 0, 1 for corrupt data or what libjpeg itself refuses
// (ValueError), 2 for what this decoder does not read (NotImplementedError),
// with a message in err.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Corrupt {
  std::string msg;
};
struct Unsupported {
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw Corrupt{m}; }
[[noreturn]] void unsupported(const std::string& m) { throw Unsupported{m}; }

// jutils.c jpeg_natural_order, with the 16 extra entries libjpeg keeps so
// that a run past coefficient 63 in corrupt data lands on 63.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool defined = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t vals[256];
  uint8_t look_len[512];  // 9-bit lookahead: code length, 0 = longer
  uint8_t look_val[512];
};

struct Comp {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int bw, bh;        // allocated blocks (MCU-padded)
  int wib, hib;      // width / height in blocks (jdinput.c)
  int dw, dh;        // downsampled width / height
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  int coef_bits[64];
  int last_dc = 0;
};

struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int nbits = 0;
  int zeros = 0;       // zero bytes fed past a marker or the end of data
  bool stopped = false;

  void fill() {
    while (nbits <= 56) {
      int b = 0;
      if (!stopped) {
        if (pos >= n) {
          stopped = true;
        } else if (d[pos] == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) q++;  // fill bytes
          if (q < n && d[q] == 0) {
            b = 0xFF;
            pos = q + 1;
          } else {
            stopped = true;  // a marker: pos stays on its first 0xFF
          }
        } else {
          b = d[pos++];
        }
      }
      if (stopped) zeros++;
      acc |= uint64_t(b) << (56 - nbits);
      nbits += 8;
    }
  }
  int peek(int k) {
    if (nbits < k) fill();
    return int(acc >> (64 - k));
  }
  void skip(int k) {
    acc <<= k;
    nbits -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  int bit() { return get(1); }
  // More bits consumed than the segment held: corrupt or truncated data.
  void check(const char* what) {
    if (nbits < zeros * 8) {
      if (pos >= n) corrupt(std::string("truncated data in ") + what);
      corrupt(std::string("premature end of the entropy-coded data in ") +
              what);
    }
  }
  void reset() {
    acc = 0;
    nbits = 0;
    zeros = 0;
  }
};

int decode_huff(BitReader& br, const Huff& h) {
  if (br.nbits < 16) br.fill();
  int look = int(br.acc >> 55);
  int len = h.look_len[look];
  if (len) {
    br.skip(len);
    return h.look_val[look];
  }
  int l = 10;
  int code = int(br.acc >> 54);
  while (code > h.maxcode[l]) {
    l++;
    if (l > 16) corrupt("bad Huffman code");
    code = int(br.acc >> (64 - l));
  }
  br.skip(l);
  return h.vals[code + h.valoffset[l]];
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + int((~0u) << s) + 1 : v;
}

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, sof = -1;
  bool progressive = false;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  int qt_defined[4] = {0, 0, 0, 0};
  uint16_t qt[4][64];  // natural order
  Huff dc[4], ac[4];
  Comp comp[4];
  int maxh = 1, maxv = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  int scans = 0;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  int u8() {
    if (pos >= n) corrupt("truncated file");
    return d[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // jdmarker.c next_marker: skip to the next 0xFF, then past fill bytes.
  int next_marker() {
    for (;;) {
      while (pos < n && d[pos] != 0xFF) pos++;
      if (pos >= n) corrupt("truncated file (no EOI marker)");
      while (pos < n && d[pos] == 0xFF) pos++;
      if (pos >= n) corrupt("truncated file (no EOI marker)");
      int m = d[pos++];
      if (m != 0) return m;
    }
  }

  void read_dqt() {
    int len = u16() - 2;
    size_t end = pos + len;
    while (len > 0) {
      int pq = u8();
      int prec = pq >> 4, t = pq & 15;
      if (t > 3) corrupt("bad DQT table number");
      if (prec > 1) corrupt("bad DQT precision");
      int count = prec ? 129 : 65;
      if (len < count) corrupt("short DQT segment");
      for (int i = 0; i < 64; i++)
        qt[t][kNatural[i]] = uint16_t(prec ? u16() : u8());
      qt_defined[t] = 1;
      len -= count;
    }
    pos = end;
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 16) {
      int tc = u8();
      int cls = tc >> 4, t = tc & 15;
      if (cls > 1 || t > 3) corrupt("bad DHT table number");
      int counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; l++) {
        counts[l] = u8();
        total += counts[l];
      }
      len -= 17;
      if (total > 256 || total > len) corrupt("bad Huffman table");
      Huff& h = cls ? ac[t] : dc[t];
      for (int i = 0; i < total; i++) h.vals[i] = uint8_t(u8());
      len -= total;
      // jdhuff.c jpeg_make_d_derived_tbl: canonical codes, checked.
      int code = 0, k = 0;
      std::memset(h.look_len, 0, sizeof h.look_len);
      for (int l = 1; l <= 16; l++) {
        h.valoffset[l] = k - code;
        for (int i = 0; i < counts[l]; i++, k++, code++) {
          if (l <= 9) {
            int shift = 9 - l;
            for (int j = 0; j < (1 << shift); j++) {
              h.look_len[(code << shift) | j] = uint8_t(l);
              h.look_val[(code << shift) | j] = h.vals[k];
            }
          }
        }
        h.maxcode[l] = counts[l] ? code - 1 : -1;
        if (code >= (1 << l)) corrupt("bad Huffman table");
        code <<= 1;
      }
      h.maxcode[17] = 0x7FFFFFFF;
      if (!cls)
        for (int i = 0; i < total; i++)
          if (h.vals[i] > 15) corrupt("bad Huffman table (DC symbol > 15)");
      h.defined = true;
    }
    if (len != 0) corrupt("bad DHT segment length");
  }

  void read_sof(int m) {
    int len = u16();
    size_t end = pos + len - 2;
    int prec = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (prec != 8)
      unsupported(std::to_string(prec) + "-bit precision (only 8-bit "
                  "samples are read)");
    if (height == 0 || width == 0)
      corrupt("empty image (a DNL height is not read by libjpeg either)");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      corrupt(std::to_string(ncomp) + " components");
    if (len != 8 + 3 * ncomp) corrupt("bad SOF length");
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        corrupt("bad sampling factors");
      if (c.tq > 3) corrupt("bad quantization table number");
      if (c.h > maxh) maxh = c.h;
      if (c.v > maxv) maxv = c.v;
    }
    pos = end;
    sof = m;
    progressive = (m == 0xC2);
    mcux = (width + 8 * maxh - 1) / (8 * maxh);
    mcuy = (height + 8 * maxv - 1) / (8 * maxv);
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.dw = int((int64_t(width) * c.h + maxh - 1) / maxh);
      c.dh = int((int64_t(height) * c.v + maxv - 1) / maxv);
      c.wib = (c.dw + 7) / 8;
      c.hib = (c.dh + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
  }

  void check_sof_kind(int m) {
    if (m == 0xC3) unsupported("lossless JPEG (SOF3)");
    if (m >= 0xC5 && m <= 0xC7)
      unsupported("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")");
    if (m >= 0xC9 && m <= 0xCB)
      unsupported("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) +
                  ")");
    if (m >= 0xCD && m <= 0xCF)
      unsupported("arithmetic-coded hierarchical JPEG (SOF" +
                  std::to_string(m - 0xC0) + ")");
  }

  bool is_sof(int m) {
    return m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC;
  }

  void read_app(int m) {
    int len = u16() - 2;
    if (len < 0) corrupt("bad marker length");
    size_t end = pos + len;
    if (end > n) corrupt("truncated file");
    const uint8_t* p = d + pos;
    if (m == 0xE0 && len >= 14 && !std::memcmp(p, "JFIF\0", 5)) jfif = true;
    if (m == 0xEE && len >= 12 && !std::memcmp(p, "Adobe", 5)) {
      adobe = true;
      adobe_transform = p[11];
    }
    pos = end;
  }

  void skip_segment() {
    int len = u16() - 2;
    if (len < 0) corrupt("bad marker length");
    pos += len;
    if (pos > n) corrupt("truncated file");
  }

  // Parse up to the frame header (for gpt_jpeg_info) or to the end.
  void headers_to_sof() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) corrupt("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (is_sof(m)) {
        check_sof_kind(m);
        read_sof(m);
        return;
      }
      segment(m);
    }
  }

  void segment(int m) {
    if (m == 0xC4) {
      read_dht();
    } else if (m == 0xDB) {
      read_dqt();
    } else if (m == 0xDD) {
      if (u16() != 4) corrupt("bad DRI length");
      restart_interval = u16();
    } else if (m >= 0xE0 && m <= 0xEF) {
      read_app(m);
    } else if (m == 0xD8) {
      corrupt("a second SOI marker");
    } else if (m == 0xD9) {
      corrupt("EOI before the image");
    } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      // a stray RST or TEM (no length): libjpeg notes it and goes on
    } else if (m == 0xFE || m == 0xDC || m == 0xCC) {
      skip_segment();  // COM; DNL and DAC, which libjpeg skips here too
    } else {
      // jdmarker.c read_markers: DHP, EXP, JPGn and RESn are fatal.
      char name[8];
      std::snprintf(name, sizeof name, "0x%02X", m);
      corrupt(std::string("unknown marker ") + name);
    }
  }

  // --- scans -------------------------------------------------------------

  int scomp[4], ns = 0, ss = 0, se = 0, ah = 0, al = 0;

  void read_sos() {
    int len = u16();
    ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) corrupt("bad SOS header");
    for (int i = 0; i < ns; i++) {
      int id = u8(), t = u8();
      int k = -1;
      for (int c = 0; c < ncomp; c++)
        if (comp[c].id == id) k = c;
      if (k < 0) corrupt("SOS names an unknown component");
      for (int j = 0; j < i; j++)
        if (scomp[j] == k) corrupt("SOS names a component twice");
      scomp[i] = k;
      comp[k].td = t >> 4;
      comp[k].ta = t & 15;
      if (comp[k].td > 3 || comp[k].ta > 3) corrupt("bad Huffman table number");
    }
    ss = u8();
    se = u8();
    int a = u8();
    ah = a >> 4;
    al = a & 15;
  }

  void need_tables() {
    for (int i = 0; i < ns; i++) {
      Comp& c = comp[scomp[i]];
      bool dcneed = !progressive || (ss == 0 && ah == 0);
      bool acneed = !progressive || ss > 0;
      if ((dcneed && !dc[c.td].defined) || (acneed && !ac[c.ta].defined))
        unsupported("a scan uses a Huffman table the file does not define "
                    "(libjpeg's built-in standard tables are not read)");
    }
  }

  void check_progression() {
    // jdphuff.c start_pass_phuff_decoder: errors; the warnings pass.
    bool bad = false;
    if (ss == 0) {
      if (se != 0) bad = true;
    } else {
      if (ss > se || se >= 64) bad = true;
      if (ns != 1) bad = true;
    }
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) corrupt("bad progression parameters");
    for (int i = 0; i < ns; i++) {
      Comp& c = comp[scomp[i]];
      for (int k = ss; k <= se; k++) c.coef_bits[k] = al;
    }
  }

  int16_t* block(Comp& c, int bx, int by) {
    return &c.coef[(size_t(by) * c.bw + bx) * 64];
  }

  int eobrun = 0;

  void decode_block_baseline(BitReader& br, Comp& c, int16_t* b) {
    int s = decode_huff(br, dc[c.td]);
    int diff = 0;
    if (s) diff = extend(br.get(s), s);
    c.last_dc = int(unsigned(c.last_dc) + unsigned(diff));
    b[0] = int16_t(c.last_dc);
    const Huff& h = ac[c.ta];
    for (int k = 1; k < 64; k++) {
      int rs = decode_huff(br, h);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        int v = extend(br.get(s), s);
        b[kNatural[k]] = int16_t(v);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_dc_first(BitReader& br, Comp& c, int16_t* b) {
    int s = decode_huff(br, dc[c.td]);
    int diff = 0;
    if (s) diff = extend(br.get(s), s);
    c.last_dc = int(unsigned(c.last_dc) + unsigned(diff));
    b[0] = int16_t(unsigned(c.last_dc) << al);
  }

  void decode_dc_refine(BitReader& br, int16_t* b) {
    if (br.bit()) b[0] = int16_t(b[0] | (1 << al));
  }

  void decode_ac_first(BitReader& br, Comp& c, int16_t* b) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Huff& h = ac[c.ta];
    for (int k = ss; k <= se; k++) {
      int rs = decode_huff(br, h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(br.get(s), s);
        b[kNatural[k]] = int16_t(unsigned(v) << al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          eobrun--;
          break;
        }
      }
    }
  }

  void decode_ac_refine(BitReader& br, Comp& c, int16_t* b) {
    int p1 = 1 << al;
    int m1 = int(~0u << al);
    int k = ss;
    const Huff& h = ac[c.ta];
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = decode_huff(br, h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* t = b + kNatural[k];
          if (*t != 0) {
            if (br.bit()) {
              if ((*t & p1) == 0) *t = int16_t(*t >= 0 ? *t + p1 : *t + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) b[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* t = b + kNatural[k];
        if (*t != 0) {
          if (br.bit()) {
            if ((*t & p1) == 0) *t = int16_t(*t >= 0 ? *t + p1 : *t + m1);
          }
        }
      }
      eobrun--;
    }
  }

  void decode_unit(BitReader& br, Comp& c, int16_t* b) {
    if (!progressive) {
      decode_block_baseline(br, c, b);
    } else if (ss == 0) {
      if (ah == 0)
        decode_dc_first(br, c, b);
      else
        decode_dc_refine(br, b);
    } else if (ah == 0) {
      decode_ac_first(br, c, b);
    } else {
      decode_ac_refine(br, c, b);
    }
  }

  // After a restart interval: the RSTn marker, then fresh state.
  void restart(BitReader& br, int& next_rst) {
    br.check("a restart interval");
    size_t p = br.pos;
    // Past any data the reader did not reach, to the marker.
    for (;;) {
      while (p < n && d[p] != 0xFF) p++;
      while (p < n && d[p] == 0xFF) p++;
      if (p >= n) corrupt("truncated data (missing RST marker)");
      if (d[p] != 0) break;
      p++;
    }
    int m = d[p];
    if (m != 0xD0 + next_rst) corrupt("missing or out-of-order RST marker");
    br.pos = p + 1;
    br.stopped = false;
    br.reset();
    next_rst = (next_rst + 1) & 7;
    for (int i = 0; i < ns; i++) comp[scomp[i]].last_dc = 0;
    eobrun = 0;
  }

  void decode_scan() {
    if (sof < 0) corrupt("SOS before SOF");
    read_sos();
    for (int i = 0; i < ns; i++)
      if (!qt_defined[comp[scomp[i]].tq]) corrupt("missing quantization table");
    if (progressive) check_progression();
    need_tables();
    if (ns > 1) {
      // jdinput.c per_scan_setup: D_MAX_BLOCKS_IN_MCU.
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += comp[scomp[i]].h * comp[scomp[i]].v;
      if (blocks > 10)
        corrupt("an MCU of more than 10 blocks (libjpeg refuses it too)");
    }
    scans++;
    BitReader br{d, n, pos};
    for (int i = 0; i < ns; i++) comp[scomp[i]].last_dc = 0;
    eobrun = 0;
    int next_rst = 0, todo = restart_interval;
    if (ns == 1) {
      Comp& c = comp[scomp[0]];
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++) {
          if (restart_interval && todo == 0) {
            restart(br, next_rst);
            todo = restart_interval;
          }
          decode_unit(br, c, block(c, bx, by));
          todo--;
        }
    } else {
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          if (restart_interval && todo == 0) {
            restart(br, next_rst);
            todo = restart_interval;
          }
          for (int i = 0; i < ns; i++) {
            Comp& c = comp[scomp[i]];
            for (int y = 0; y < c.v; y++)
              for (int x = 0; x < c.h; x++)
                decode_unit(br, c, block(c, mx * c.h + x, my * c.v + y));
          }
          todo--;
        }
    }
    br.check("the last interval of a scan");
    pos = br.pos;
  }

  void decode_all() {
    headers_to_sof();
    for (int i = 0; i < ncomp; i++)
        comp[i].coef.assign(size_t(comp[i].bw) * comp[i].bh * 64, 0);
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xDA) {
        decode_scan();
      } else if (is_sof(m)) {
        corrupt("a second frame header");
      } else {
        segment(m);
      }
    }
    if (scans == 0) corrupt("no scan before EOI");
    if (progressive) {
      // jdcoefct.c smoothing_ok: block smoothing runs where a component's
      // DC or one of its first 9 AC coefficients is not fully refined.
      for (int i = 0; i < ncomp; i++) {
        if (comp[i].coef_bits[0] < 0)
          unsupported("a progressive JPEG whose DC scan is missing (block "
                      "smoothing is not implemented)");
        for (int k = 1; k < 10; k++)
          if (comp[i].coef_bits[k] != 0)
            unsupported("a progressive JPEG whose scans do not refine every "
                        "low coefficient (block smoothing is not "
                        "implemented)");
      }
    }
  }
};

// --- the islow IDCT as libjpeg-turbo's SIMD code runs it -----------------------
//
// jsimd_idct_islow_avx2 / _sse2 (jidctint-avx2.asm), which jddctmgr.c picks
// over jidctint.c's C code wherever the CPU has SSE2: the same fixed-point
// rotations, regrouped for pmaddwd, on 16-bit lanes. So the dequantized
// coefficient is the low 16 bits of coef * quant (pmullw), the sums
// in0 +/- in4, in7 + in3 and in5 + in1 wrap at 16 bits (paddw), each pass
// ends saturated to 16 bits (packssdw), the output is clamped to -128..127
// before the +128 (packsswb), where the C code's range_limit table wraps
// under RANGE_MASK, and a block whose AC rows are all zero takes the DC
// shortcut in the first pass ((in0 * q0) << 2 in 16 bits, psllw). For
// coefficients of ordinary files the two agree; they part where a sample
// overshoots by more than 384 or a lane passes 16 bits.

constexpr int CONST_BITS = 13, PASS1_BITS = 2;
// The regrouped constants of jidctint-avx2.asm (jidctint.c's FIX_* values).
constexpr int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433,
                  F_0_765 = 6270, F_0_899 = 7373, F_1_175 = 9633,
                  F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069,
                  F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline int32_t wrap16(int32_t x) { return int16_t(uint16_t(uint32_t(x))); }
inline int32_t sat16(int32_t x) {
  return x < -32768 ? -32768 : (x > 32767 ? 32767 : x);
}

// One 1-D pass over 8 lanes in[k * step] (16-bit values), descaled by nb
// and saturated to 16 bits into out[k * ostep].
inline void idct_pass(const int32_t* in, int step, int32_t* out, int ostep,
                      int nb) {
  int32_t in0 = in[0], in1 = in[step], in2 = in[2 * step],
          in3 = in[3 * step], in4 = in[4 * step], in5 = in[5 * step],
          in6 = in[6 * step], in7 = in[7 * step];
  // Even part.
  int32_t tmp3 = in2 * (F_0_541 + F_0_765) + in6 * F_0_541;
  int32_t tmp2 = in6 * (F_0_541 - F_1_847) + in2 * F_0_541;
  int32_t tmp0 = wrap16(in0 + in4) * (1 << CONST_BITS);
  int32_t tmp1 = wrap16(in0 - in4) * (1 << CONST_BITS);
  int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  // Odd part.
  int32_t z3 = wrap16(in7 + in3), z4 = wrap16(in5 + in1);
  int32_t z3r = z3 * (F_1_175 - F_1_961) + z4 * F_1_175;
  int32_t z4r = z3 * F_1_175 + z4 * (F_1_175 - F_0_390);
  int32_t t0 = in7 * (F_0_298 - F_0_899) + in1 * (-F_0_899) + z3r;
  int32_t t1 = in5 * (F_2_053 - F_2_562) + in3 * (-F_2_562) + z4r;
  int32_t t2 = in5 * (-F_2_562) + in3 * (F_3_072 - F_2_562) + z3r;
  int32_t t3 = in7 * (-F_0_899) + in1 * (F_1_501 - F_0_899) + z4r;
  const int32_t rnd = int32_t(1) << (nb - 1);
  out[0] = sat16((tmp10 + t3 + rnd) >> nb);
  out[7 * ostep] = sat16((tmp10 - t3 + rnd) >> nb);
  out[1 * ostep] = sat16((tmp11 + t2 + rnd) >> nb);
  out[6 * ostep] = sat16((tmp11 - t2 + rnd) >> nb);
  out[2 * ostep] = sat16((tmp12 + t1 + rnd) >> nb);
  out[5 * ostep] = sat16((tmp12 - t1 + rnd) >> nb);
  out[3 * ostep] = sat16((tmp13 + t0 + rnd) >> nb);
  out[4 * ostep] = sat16((tmp13 - t0 + rnd) >> nb);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int32_t deq[64], ws[64];
  bool ac_zero = true;
  for (int k = 8; k < 64; k++) ac_zero &= in[k] == 0;
  if (ac_zero) {
    for (int c = 0; c < 8; c++) {
      int32_t dc = wrap16(wrap16(int32_t(in[c]) * int32_t(q[c])) * 4);
      for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
    }
  } else {
    for (int k = 0; k < 64; k++)
      deq[k] = wrap16(int32_t(in[k]) * int32_t(q[k]));
    for (int c = 0; c < 8; c++)
      idct_pass(deq + c, 8, ws + c, 8, CONST_BITS - PASS1_BITS);
  }
  int32_t row[8];
  for (int r = 0; r < 8; r++) {
    idct_pass(ws + 8 * r, 1, row, 1, CONST_BITS + PASS1_BITS + 3);
    uint8_t* o = out + size_t(r) * stride;
    for (int c = 0; c < 8; c++) {
      int32_t v = row[c] < -128 ? -128 : (row[c] > 127 ? 127 : row[c]);
      o[c] = uint8_t(v + 128);
    }
  }
}

// --- jdsample.c ---------------------------------------------------------------

// A component's samples at full size, width x height (the image's), from its
// IDCT plane (pw columns, the real dw x dh samples at its top left). Rows
// outside [0, dh) read the edge rows (jdmainct.c's context pointers).
void upsample(const Comp& c, const uint8_t* plane, int pw, int maxh, int maxv,
              int width, int height, uint8_t* out) {
  int hr = maxh / c.h, vr = maxv / c.v;
  auto row = [&](int y) {
    if (y < 0) y = 0;
    if (y >= c.dh) y = c.dh - 1;
    return plane + size_t(y) * pw;
  };
  // A row is upsampled at its full dw * hr width (as libjpeg does), then
  // cut to the image's width.
  int out_w = c.dw * hr;
  std::vector<uint8_t> line(out_w);
  if (hr == 1 && vr == 1) {
    for (int y = 0; y < height; y++)
      std::memcpy(out + size_t(y) * width, row(y), width);
    return;
  }
  bool h2v1 = hr == 2 && vr == 1, h2v2 = hr == 2 && vr == 2;
  bool h1v2 = hr == 1 && vr == 2;
  for (int y = 0; y < height; y++) {
    uint8_t* o = line.data();
    if ((h2v1 || h2v2) && c.dw > 2) {
      if (h2v1) {
        const uint8_t* in = row(y);
        int v = in[0];
        o[0] = uint8_t(v);
        o[1] = uint8_t((v * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < c.dw - 1; x++) {
          v = in[x] * 3;
          o[2 * x] = uint8_t((v + in[x - 1] + 1) >> 2);
          o[2 * x + 1] = uint8_t((v + in[x + 1] + 2) >> 2);
        }
        int x = c.dw - 1;
        v = in[x];
        o[2 * x] = uint8_t((v * 3 + in[x - 1] + 1) >> 2);
        o[2 * x + 1] = uint8_t(v);
      } else {
        int iy = y >> 1;
        const uint8_t* in0 = row(iy);
        const uint8_t* in1 = row((y & 1) ? iy + 1 : iy - 1);
        int this_s = in0[0] * 3 + in1[0];
        int next_s = in0[1] * 3 + in1[1];
        o[0] = uint8_t((this_s * 4 + 8) >> 4);
        o[1] = uint8_t((this_s * 3 + next_s + 7) >> 4);
        int last_s = this_s;
        this_s = next_s;
        for (int x = 1; x < c.dw - 1; x++) {
          next_s = in0[x + 1] * 3 + in1[x + 1];
          o[2 * x] = uint8_t((this_s * 3 + last_s + 8) >> 4);
          o[2 * x + 1] = uint8_t((this_s * 3 + next_s + 7) >> 4);
          last_s = this_s;
          this_s = next_s;
        }
        int x = c.dw - 1;
        o[2 * x] = uint8_t((this_s * 3 + last_s + 8) >> 4);
        o[2 * x + 1] = uint8_t((this_s * 4 + 7) >> 4);
      }
    } else if (h1v2) {
      int iy = y >> 1;
      const uint8_t* in0 = row(iy);
      bool below = y & 1;
      const uint8_t* in1 = row(below ? iy + 1 : iy - 1);
      int bias = below ? 2 : 1;
      for (int x = 0; x < c.dw; x++)
        o[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
    } else {
      // h2v1_upsample, h2v2_upsample and int_upsample: box replication.
      const uint8_t* in = row(y / vr);
      for (int x = 0; x < out_w; x++) o[x] = in[x / hr];
    }
    std::memcpy(out + size_t(y) * width, o, width);
  }
}

// --- jdcolor.c ------------------------------------------------------------------

struct YccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    const int SCALEBITS = 16;
    const int32_t ONE_HALF = int32_t(1) << (SCALEBITS - 1);
    auto fix = [](double x) { return int32_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      int32_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = int((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

int run(const uint8_t* data, int64_t n, uint8_t* out, int h, int w,
        int colour) {
  Decoder dec(data, size_t(n));
  dec.decode_all();
  if (dec.height != h || dec.width != w) corrupt("size changed");
  int nc = dec.ncomp;
  for (int i = 0; i < nc; i++) {
    Comp& c = dec.comp[i];
    if (dec.maxh % c.h || dec.maxv % c.v)
      corrupt("fractional sampling ratios (libjpeg refuses them too)");
    if (!dec.qt_defined[c.tq]) corrupt("missing quantization table");
  }
  std::vector<std::vector<uint8_t>> full(nc);
  for (int i = 0; i < nc; i++) {
    Comp& c = dec.comp[i];
    int pw = c.bw * 8;
    std::vector<uint8_t> plane(size_t(pw) * c.bh * 8);
    const uint16_t* q = dec.qt[c.tq];
    // Only the blocks that hold real samples (libjpeg's IDCT runs over
    // width_in_blocks x height_in_blocks; the MCU padding is dropped).
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++)
        idct_islow(dec.block(c, bx, by), q,
                   plane.data() + size_t(by) * 8 * pw + bx * 8, pw);
    full[i].resize(size_t(w) * h);
    upsample(c, plane.data(), pw, dec.maxh, dec.maxv, w, h, full[i].data());
  }
  size_t np = size_t(w) * h;
  if (nc == 1) {
    const uint8_t* g = full[0].data();
    for (size_t p = 0; p < np; p++) out[3 * p] = out[3 * p + 1] =
        out[3 * p + 2] = g[p];
    return 0;
  }
  if (nc == 4) {
    // jdapimin.c: an Adobe marker with transform 0 is CMYK, any other
    // YCCK; no Adobe marker is CMYK.
    const uint8_t *p0 = full[0].data(), *p1 = full[1].data(),
                  *p2 = full[2].data(), *p3 = full[3].data();
    bool ycck = colour == 0 && dec.adobe && dec.adobe_transform != 0;
    for (size_t p = 0; p < np; p++) {
      if (ycck) {
        int y = p0[p], cb = p1[p], cr = p2[p];
        out[4 * p] = clamp255(255 - (y + kYcc.cr_r[cr]));
        out[4 * p + 1] =
            clamp255(255 - (y + ((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
        out[4 * p + 2] = clamp255(255 - (y + kYcc.cb_b[cb]));
      } else {
        out[4 * p] = p0[p];
        out[4 * p + 1] = p1[p];
        out[4 * p + 2] = p2[p];
      }
      out[4 * p + 3] = p3[p];
    }
    return 0;
  }
  // jdapimin.c default_decompress_parms: the colour space of 3 components.
  bool rgb;
  if (colour == 1)
    rgb = true;
  else if (colour == 2)
    rgb = false;
  else if (dec.jfif)
    rgb = false;
  else if (dec.adobe)
    rgb = dec.adobe_transform == 0;
  else
    rgb = dec.comp[0].id == 82 && dec.comp[1].id == 71 && dec.comp[2].id == 66;
  const uint8_t *p0 = full[0].data(), *p1 = full[1].data(),
                *p2 = full[2].data();
  if (rgb) {
    for (size_t p = 0; p < np; p++) {
      out[3 * p] = p0[p];
      out[3 * p + 1] = p1[p];
      out[3 * p + 2] = p2[p];
    }
    return 0;
  }
  for (size_t p = 0; p < np; p++) {
    int y = p0[p], cb = p1[p], cr = p2[p];
    out[3 * p] = clamp255(y + kYcc.cr_r[cr]);
    out[3 * p + 1] = clamp255(y + ((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
    out[3 * p + 2] = clamp255(y + kYcc.cb_b[cb]);
  }
  return 0;
}

int fail(const std::string& m, char* err, int errlen, int code) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", m.c_str());
  return code;
}

}  // namespace

extern "C" {

int gpt_jpeg_info(const uint8_t* data, int64_t n, int32_t* dims, char* err,
                  int errlen) {
  try {
    Decoder dec(data, size_t(n));
    dec.headers_to_sof();
    dims[0] = dec.height;
    dims[1] = dec.width;
    dims[2] = dec.ncomp;
    return 0;
  } catch (const Corrupt& e) {
    return fail(e.msg, err, errlen, 1);
  } catch (const Unsupported& e) {
    return fail(e.msg, err, errlen, 2);
  } catch (...) {
    return fail("decoder error", err, errlen, 1);
  }
}

int gpt_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int32_t h,
                    int32_t w, int32_t colour, char* err, int errlen) {
  try {
    return run(data, n, out, h, w, colour);
  } catch (const Corrupt& e) {
    return fail(e.msg, err, errlen, 1);
  } catch (const Unsupported& e) {
    return fail(e.msg, err, errlen, 2);
  } catch (...) {
    return fail("decoder error", err, errlen, 1);
  }
}

}  // extern "C"
