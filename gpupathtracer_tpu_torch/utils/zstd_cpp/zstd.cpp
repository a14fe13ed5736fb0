// Zstandard (RFC 8878) decoding of one TIFF strip or tile, as libtiff's
// ZSTDDecode (tif_zstd.c) drives libzstd 1.5.7's ZSTD_decompressStream:
// the loop stops when the output is full, when the input is used up or
// when a frame ends, so only the first frame counts. Frames, blocks,
// literals (raw, RLE, Huffman with direct or FSE-coded weights, one or
// four streams, treeless), sequences (predefined, RLE, FSE-coded and
// repeat tables, the repeat offsets) and the XXH64 content checksum are
// decoded and checked where libzstd checks them.
//
// C interface (ctypes): gpt_zstd_tiff returns 0 when the `occ` output
// bytes were produced, else a negative code (the binding raises
// ValueError): -1 corrupt data, -2 a frame that ends (or an input that
// ends) before the output is full, -3 a dictionary the frame asks for,
// -4 a window libzstd refuses, -5 an unknown frame magic. `made` gets the
// bytes written to the output either way (libtiff keeps them, zeros
// after them).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum { kCorrupt = -1, kShort = -2, kDict = -3, kWindow = -4, kMagic = -5 };

struct Error {
  int code;
};

[[noreturn]] void fail(int code = kCorrupt) { throw Error{code}; }

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

inline uint32_t le16(const uint8_t* p) { return p[0] | uint32_t(p[1]) << 8; }
inline uint32_t le24(const uint8_t* p) { return le16(p) | uint32_t(p[2]) << 16; }
inline uint32_t le32(const uint8_t* p) { return le16(p) | le16(p + 2) << 16; }
inline uint64_t le64(const uint8_t* p) {
  return uint64_t(le32(p)) | uint64_t(le32(p + 4)) << 32;
}

// --- XXH64 -------------------------------------------------------------------

const uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
               P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
               P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t round1(uint64_t acc, uint64_t v) {
  return rotl(acc + v * P2, 31) * P1;
}
inline uint64_t merge(uint64_t acc, uint64_t v) {
  return (acc ^ round1(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (p + 32 <= end) {
      v1 = round1(v1, le64(p));
      v2 = round1(v2, le64(p + 8));
      v3 = round1(v3, le64(p + 16));
      v4 = round1(v4, le64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(merge(merge(merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  while (p + 8 <= end) {
    h ^= round1(0, le64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(le32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= *p++ * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// --- bit streams -------------------------------------------------------------

// A backward stream (Huffman and FSE data): read from the last bit towards
// the first, after the end mark (the highest set bit of the last byte).
// Bits past the start read as zeros; `left` then goes negative
// (libzstd's overflow).
struct BackBits {
  const uint8_t* p;
  int64_t left;  // bits not yet read
  BackBits(const uint8_t* src, size_t n) {
    if (n == 0 || src[n - 1] == 0) fail();
    p = src;
    left = int64_t(n) * 8 - 8 + highbit(src[n - 1]);
  }
  uint32_t peek(int nb) const {
    uint32_t v = 0;
    for (int i = 1; i <= nb; i++) {
      int64_t b = left - i;
      v <<= 1;
      if (b >= 0) v |= (p[b >> 3] >> (b & 7)) & 1;
    }
    return v;
  }
  uint32_t read(int nb) {
    uint32_t v = peek(nb);
    left -= nb;
    return v;
  }
};

// A forward little-endian stream (FSE table descriptions).
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // in bits
  uint32_t peek(int nb) const {
    uint32_t v = 0;
    for (int i = 0; i < nb; i++) {
      size_t b = pos + i;
      if (b < n * 8 && ((p[b >> 3] >> (b & 7)) & 1)) v |= 1u << i;
    }
    return v;
  }
};

// --- FSE -----------------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint32_t base;
};

struct Fse {
  int log = 0;
  std::vector<FseEntry> t;
};

// libzstd's FSE_readNCount: the normalized counts of a table description
// of at most `max_log` bits and symbols up to `max_sym`; returns the bytes
// it takes.
size_t read_ncount(const uint8_t* src, size_t n, int max_log, int max_sym,
                   std::vector<int>& norm, int& log) {
  uint8_t pad[4] = {0, 0, 0, 0};
  const uint8_t* p = src;
  size_t size = n;
  if (n < 4) {
    memcpy(pad, src, n);
    p = pad;
    size = 4;
  }
  FwdBits b{p, size};
  int nb = int(b.peek(4)) + 5;
  b.pos = 4;
  if (nb > 15) fail();
  log = nb;
  int remaining = (1 << nb) + 1, threshold = 1 << nb;
  nb++;
  int sym = 0;
  bool prev0 = false;
  norm.assign(max_sym + 1, 0);
  for (;;) {
    if (prev0) {
      uint32_t rep;
      while ((rep = b.peek(2)) == 3) {
        sym += 3;
        b.pos += 2;
      }
      sym += int(rep);
      b.pos += 2;
      if (sym >= max_sym + 1) break;
    }
    int max = (2 * threshold - 1) - remaining;
    uint32_t v = b.peek(nb);
    int count;
    if (int(v & (threshold - 1)) < max) {
      count = int(v & (threshold - 1));
      b.pos += nb - 1;
    } else {
      count = int(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      b.pos += nb;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    if (sym > max_sym) fail();
    norm[sym++] = count;
    prev0 = count == 0;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nb = highbit(uint32_t(remaining)) + 1;
      threshold = 1 << (nb - 1);
    }
    if (sym >= max_sym + 1) break;
  }
  if (remaining != 1 || sym > max_sym + 1) fail();
  if (log > max_log) fail();
  size_t used = (b.pos + 7) >> 3;
  if (used > n) fail();
  norm.resize(sym);
  return used;
}

void build_fse(const std::vector<int>& norm, int log, Fse& f) {
  int size = 1 << log, high = size - 1;
  f.log = log;
  f.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  for (size_t s = 0; s < norm.size(); s++) {
    if (norm[s] == -1) {
      f.t[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  int pos = 0, step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  for (size_t s = 0; s < norm.size(); s++) {
    for (int i = 0; i < norm[s]; i++) {
      f.t[pos].symbol = uint16_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail();
  for (int u = 0; u < size; u++) {
    uint32_t ns = next[f.t[u].symbol]++;
    int nbits = log - highbit(ns);
    f.t[u].nbits = uint8_t(nbits);
    f.t[u].base = (ns << nbits) - uint32_t(size);
  }
}

void rle_fse(int sym, Fse& f) {
  f.log = 0;
  f.t.assign(1, FseEntry{uint16_t(sym), 0, 0});
}

void predefined(const int* dist, int n, int log, Fse& f) {
  std::vector<int> norm(dist, dist + n);
  build_fse(norm, log, f);
}

// --- Huffman literals ------------------------------------------------------------

struct Huff {
  int log = 0;
  std::vector<uint8_t> sym, nbits;
};

// The tree description: the weights (direct or FSE-coded), the last one
// implied; libzstd's HUF_readStats and HUF_readDTableX1.
size_t read_huff(const uint8_t* src, size_t n, Huff& h) {
  if (n < 1) fail();
  int hb = src[0];
  uint8_t w[256];
  int nw;
  size_t used;
  if (hb >= 128) {
    nw = hb - 127;
    used = 1 + size_t((nw + 1) / 2);
    if (used > n) fail();
    for (int i = 0; i < nw; i++)
      w[i] = (i & 1) ? src[1 + i / 2] & 15 : src[1 + i / 2] >> 4;
  } else {
    if (size_t(hb) + 1 > n) fail();
    std::vector<int> norm;
    int log;
    size_t hdr = read_ncount(src + 1, size_t(hb), 6, 255, norm, log);
    if (hdr > size_t(hb)) fail();
    Fse f;
    build_fse(norm, log, f);
    BackBits b(src + 1 + hdr, size_t(hb) - hdr);
    uint32_t s1 = b.read(log), s2 = b.read(log);
    nw = 0;
    for (;;) {
      if (nw > 253) fail();
      w[nw++] = uint8_t(f.t[s1].symbol);
      s1 = f.t[s1].base + b.read(f.t[s1].nbits);
      if (b.left < 0) {
        w[nw++] = uint8_t(f.t[s2].symbol);
        break;
      }
      if (nw > 253) fail();
      w[nw++] = uint8_t(f.t[s2].symbol);
      s2 = f.t[s2].base + b.read(f.t[s2].nbits);
      if (b.left < 0) {
        w[nw++] = uint8_t(f.t[s1].symbol);
        break;
      }
    }
    used = 1 + size_t(hb);
  }
  uint32_t rank[17] = {0}, total = 0;
  for (int i = 0; i < nw; i++) {
    if (w[i] > 12) fail();
    rank[w[i]]++;
    total += (1u << w[i]) >> 1;
  }
  if (total == 0) fail();
  int log = highbit(total) + 1;
  if (log > 12) fail();
  uint32_t rest = (1u << log) - total;
  if (rest & (rest - 1)) fail();  // not a power of two
  int last = highbit(rest) + 1;
  w[nw++] = uint8_t(last);
  rank[last]++;
  if (rank[1] < 2 || (rank[1] & 1)) fail();
  h.log = log;
  h.sym.assign(size_t(1) << log, 0);
  h.nbits.assign(size_t(1) << log, 0);
  uint32_t start[17], next = 0;
  for (int k = 1; k <= log; k++) {
    start[k] = next;
    next += rank[k] << (k - 1);
  }
  for (int s = 0; s < nw; s++) {
    int k = w[s];
    if (!k) continue;
    uint32_t len = (1u << k) >> 1;
    for (uint32_t i = 0; i < len; i++) {
      h.sym[start[k] + i] = uint8_t(s);
      h.nbits[start[k] + i] = uint8_t(log + 1 - k);
    }
    start[k] += len;
  }
  return used;
}

void huff_stream(const Huff& h, const uint8_t* src, size_t n, uint8_t* out,
                 size_t count) {
  BackBits b(src, n);
  for (size_t i = 0; i < count; i++) {
    uint32_t v = b.peek(h.log);
    out[i] = h.sym[v];
    b.left -= h.nbits[v];
  }
  if (b.left != 0) fail();
}

// Four streams as libzstd's fast Huffman decoder reads them (x86-64): it
// runs where the table is at most 11 bits deep, every stream holds 8 bytes
// or more and the last segment is shorter than the others, and it checks
// neither the streams' ends nor their markers. Each stream's bits run on
// below its first byte into the bytes before it (the jump table, then
// zeros); the one check is that no stream has read more than its own
// bytes when the unrolled loop (5 symbols a stream a round, while stream
// 0 has 7 bytes above the table and stream 3 5 symbols to go) stops.
// Returns false where it does not run.
bool huff_fast(const Huff& h, const uint8_t* base, size_t m, uint8_t* out,
               size_t n) {
  if (h.log > 11 || m < 10) return false;
  size_t len[4] = {le16(base), le16(base + 2), le16(base + 4), 0};
  if (6 + len[0] + len[1] + len[2] > m) return false;
  len[3] = m - 6 - len[0] - len[1] - len[2];
  size_t seg = (n + 3) / 4;
  if (len[0] < 8 || len[1] < 8 || len[2] < 8 || len[3] < 8 || 3 * seg >= n)
    return false;
  int64_t start[4], end[4], t[4];
  size_t want[4] = {seg, seg, seg, n - 3 * seg}, made[4] = {0, 0, 0, 0};
  start[0] = 6;
  for (int i = 0; i < 4; i++) {
    if (i) start[i] = start[i - 1] + int64_t(len[i - 1]);
    end[i] = start[i] + int64_t(len[i]);
    uint8_t last = base[end[i] - 1];
    t[i] = last ? 8 - highbit(last) : 0;
  }
  // Past the first byte, libzstd's bit container stays on the first 8
  // bytes and its read position wraps around them every 64 bits, zeros
  // shifted in past their last bit.
  auto peek = [&](int i) {
    int64_t t0 = (end[i] - 8) * 8;  // where the first 8 bytes begin
    uint32_t v = 0;
    for (int k = 0; k < h.log; k++) {
      v <<= 1;
      int64_t byte, bit;
      if (t[i] < t0) {
        bit = t[i] + k;
        byte = end[i] - 1 - (bit >> 3);
      } else {
        bit = (t[i] - t0) % 64 + k;
        if (bit >= 64) continue;
        byte = 7 - (bit >> 3);
      }
      v |= (base[byte] >> (7 - (bit & 7))) & 1;
    }
    return v;
  };
  auto one = [&](int i) {
    uint32_t v = peek(i);
    out[i * seg + made[i]++] = h.sym[v];
    t[i] += h.nbits[v];
  };
  bool loaded = false;  // the bytes a stream holds, after a reload
  auto ip = [&](int i) { return end[i] - 8 - (loaded ? t[i] >> 3 : 0); };
  for (;;) {
    size_t iters = (want[3] - made[3]) / 5;
    size_t ins = size_t(ip(0) > 0 ? ip(0) : 0) / 7;
    if (ins < iters) iters = ins;
    if (!iters) break;
    bool crossed = false;
    for (int i = 1; i < 4; i++) crossed |= ip(i) < ip(i - 1);
    if (crossed) break;
    for (size_t r = 0; r < iters; r++) {
      for (int i = 0; i < 4; i++)
        for (int k = 0; k < 5; k++) one(i);
      loaded = true;
    }
  }
  for (int i = 0; i < 4; i++)
    if (ip(i) < start[i] - 8) fail();
  for (int i = 0; i < 4; i++)
    while (made[i] < want[i]) one(i);
  return true;
}

// --- frames ------------------------------------------------------------------

const int kLLDist[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                         2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                         2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int kMLDist[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                         1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                         1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                         1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int kOFDist[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                         1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,    9,    10,   11,
    12, 13, 14, 15, 16, 18, 20, 22, 24,   28,   32,   40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2,  2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195,
    16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Frame {
  std::vector<uint8_t> out;  // the frame's content so far
  size_t block_max = 0;
  Huff huff;
  bool have_huff = false;
  Fse ll, of, ml;
  bool have_seq = false;
  uint64_t rep[3] = {1, 4, 8};
  size_t flushed = 0;  // the output of the blocks decoded whole
};

size_t literals(Frame& f, const uint8_t* src, size_t n,
                std::vector<uint8_t>& lit) {
  if (n < 2) fail();
  int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
  if (type < 2) {
    size_t hs, size;
    if (fmt == 0 || fmt == 2) {
      hs = 1;
      size = src[0] >> 3;
    } else if (fmt == 1) {
      hs = 2;
      size = le16(src) >> 4;
    } else {
      if (n < 3) fail();
      hs = 3;
      size = le24(src) >> 4;
    }
    if (size > f.block_max) fail();
    if (type == 0) {
      if (hs + size > n) fail();
      lit.assign(src + hs, src + hs + size);
      return hs + size;
    }
    if (hs + 1 > n) fail();
    lit.assign(size, src[hs]);
    return hs + 1;
  }
  if (n < 5) fail();
  size_t hs, size, csize;
  bool single = fmt == 0;
  uint32_t c = le32(src);
  if (fmt < 2) {
    hs = 3;
    size = (c >> 4) & 0x3ff;
    csize = (c >> 14) & 0x3ff;
  } else if (fmt == 2) {
    hs = 4;
    size = (c >> 4) & 0x3fff;
    csize = c >> 18;
  } else {
    hs = 5;
    size = (c >> 4) & 0x3ffff;
    csize = (c >> 22) + (size_t(src[4]) << 10);
  }
  if (size > f.block_max) fail();
  if (!single && size < 6) fail();
  if (csize + hs > n) fail();
  const uint8_t* p = src + hs;
  size_t m = csize;
  if (type == 2) {
    size_t used = read_huff(p, m, f.huff);
    f.have_huff = true;
    p += used;
    m -= used;
  } else if (!f.have_huff) {
    fail();
  }
  lit.assign(size, 0);
  if (single) {
    huff_stream(f.huff, p, m, lit.data(), size);
  } else {
    if (m < 6) fail();
    if (huff_fast(f.huff, p, m, lit.data(), size)) return hs + csize;
    size_t s1 = le16(p), s2 = le16(p + 2), s3 = le16(p + 4);
    if (6 + s1 + s2 + s3 > m) fail();
    size_t s4 = m - 6 - s1 - s2 - s3, seg = (size + 3) / 4;
    if (3 * seg > size) fail();
    const uint8_t* q = p + 6;
    huff_stream(f.huff, q, s1, lit.data(), seg);
    huff_stream(f.huff, q + s1, s2, lit.data() + seg, seg);
    huff_stream(f.huff, q + s1 + s2, s3, lit.data() + 2 * seg, seg);
    huff_stream(f.huff, q + s1 + s2 + s3, s4, lit.data() + 3 * seg,
                size - 3 * seg);
  }
  return hs + csize;
}

size_t seq_table(const uint8_t* src, size_t n, int mode, int max_sym,
                 int max_log, const int* dist, int dist_n, int dist_log,
                 Fse& t, bool have) {
  if (mode == 0) {
    predefined(dist, dist_n, dist_log, t);
    return 0;
  }
  if (mode == 1) {
    if (n < 1) fail();
    if (src[0] > max_sym) fail();
    rle_fse(src[0], t);
    return 1;
  }
  if (mode == 2) {
    std::vector<int> norm;
    int log;
    size_t used = read_ncount(src, n, max_log, max_sym, norm, log);
    build_fse(norm, log, t);
    return used;
  }
  if (!have) fail();
  return 0;
}

void compressed_block(Frame& f, const uint8_t* src, size_t n) {
  std::vector<uint8_t> lit;
  size_t used = literals(f, src, n, lit);
  const uint8_t* p = src + used;
  const uint8_t* end = src + n;
  if (p >= end) fail();
  uint32_t nseq = *p++;
  if (nseq > 0x7f) {
    if (nseq == 0xff) {
      if (p + 2 > end) fail();
      nseq = le16(p) + 0x7f00;
      p += 2;
    } else {
      if (p >= end) fail();
      nseq = ((nseq - 0x80) << 8) + *p++;
    }
  }
  size_t start = f.out.size();
  if (nseq == 0) {
    if (p != end) fail();
    if (lit.size() > f.block_max) fail();
    f.out.insert(f.out.end(), lit.begin(), lit.end());
    return;
  }
  if (p + 1 > end) fail();
  int modes = *p++;
  if (modes & 3) fail();
  p += seq_table(p, size_t(end - p), modes >> 6, 35, 9, kLLDist, 36, 6,
                 f.ll, f.have_seq);
  p += seq_table(p, size_t(end - p), (modes >> 4) & 3, 31, 8, kOFDist, 29,
                 5, f.of, f.have_seq);
  p += seq_table(p, size_t(end - p), (modes >> 2) & 3, 52, 9, kMLDist, 53,
                 6, f.ml, f.have_seq);
  f.have_seq = true;
  if (p > end) fail();
  BackBits b(p, size_t(end - p));
  uint32_t sl = b.read(f.ll.log), so = b.read(f.of.log),
           sm = b.read(f.ml.log);
  size_t lp = 0;
  for (uint32_t i = 0; i < nseq; i++) {
    uint32_t llc = f.ll.t[sl].symbol, ofc = f.of.t[so].symbol,
             mlc = f.ml.t[sm].symbol;
    if (ofc > 31) fail();
    uint64_t ofv = (uint64_t(1) << ofc) + b.read(int(ofc));
    uint64_t mlen = kMLBase[mlc] + b.read(kMLBits[mlc]);
    uint64_t llen = kLLBase[llc] + b.read(kLLBits[llc]);
    uint64_t off;
    if (ofv > 3) {
      off = ofv - 3;
      f.rep[2] = f.rep[1];
      f.rep[1] = f.rep[0];
      f.rep[0] = off;
    } else {
      uint64_t idx = ofv - 1 + (llen == 0);
      if (idx == 0) {
        off = f.rep[0];
      } else {
        off = idx == 3 ? f.rep[0] - 1 : f.rep[idx];
        if (off == 0) fail();
        if (idx != 1) f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = off;
      }
    }
    if (llen > lit.size() - lp) fail();
    if (f.out.size() - start + llen + mlen > f.block_max) fail();
    f.out.insert(f.out.end(), lit.begin() + lp, lit.begin() + lp + llen);
    lp += llen;
    if (off > f.out.size()) fail();
    size_t from = f.out.size() - off;
    for (uint64_t k = 0; k < mlen; k++) f.out.push_back(f.out[from + k]);
    if (i + 1 < nseq) {
      sl = f.ll.t[sl].base + b.read(f.ll.t[sl].nbits);
      sm = f.ml.t[sm].base + b.read(f.ml.t[sm].nbits);
      so = f.of.t[so].base + b.read(f.of.t[so].nbits);
    }
  }
  if (b.left != 0) fail();
  if (f.out.size() - start + (lit.size() - lp) > f.block_max) fail();
  f.out.insert(f.out.end(), lit.begin() + lp, lit.end());
}

// The first frame of the strip into `dst` (occ bytes); see the header.
int decode(const uint8_t* src, size_t n, uint8_t* dst, size_t occ,
           int64_t* made_out) {
  *made_out = 0;
  if (n < 4) return kShort;
  uint32_t magic = le32(src);
  if ((magic & 0xfffffff0u) == 0x184d2a50u) return kShort;  // skippable
  if (magic != 0xfd2fb528u) return kMagic;
  if (n < 5) return kShort;
  int fhd = src[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      did_flag = fhd & 3;
  if (fhd & 8) return kCorrupt;
  size_t did_size = did_flag == 3 ? 4 : size_t(did_flag);
  size_t fcs_size = fcs_flag == 0 ? size_t(single) : size_t(1) << fcs_flag;
  size_t hdr = 5 + (single ? 0 : 1) + did_size + fcs_size;
  if (hdr > n) return kShort;
  const uint8_t* p = src + 5;
  uint64_t window = 0;
  if (!single) {
    int wl = 10 + (*p >> 3);
    if (wl > 31) return kWindow;
    uint64_t base = uint64_t(1) << wl;
    window = base + (base / 8) * (*p & 7);
    p++;
  }
  uint32_t did = 0;
  for (size_t i = 0; i < did_size; i++) did |= uint32_t(p[i]) << (8 * i);
  p += did_size;
  bool fcs_known = fcs_size > 0;
  uint64_t fcs = 0;
  if (fcs_size == 1) fcs = p[0];
  if (fcs_size == 2) fcs = le16(p) + 256;
  if (fcs_size == 4) fcs = le32(p);
  if (fcs_size == 8) fcs = le64(p);
  p += fcs_size;
  if (single) window = fcs;
  if (did) return kDict;
  Frame f;
  f.block_max = size_t(window < 131072 ? window : 131072);
  // libzstd decodes the whole frame at once when its content size fits
  // the output and the whole frame is in the input; else it streams,
  // block after block, and refuses windows past 2^27 + 1 bytes.
  bool one_shot = false;
  if (fcs_known && fcs <= occ) {
    const uint8_t* q = p;
    bool ok = true;
    for (;;) {
      if (q + 3 > src + n) {
        ok = false;
        break;
      }
      uint32_t bh = le24(q);
      int type = (bh >> 1) & 3;
      if (type == 3) {
        ok = false;
        break;
      }
      size_t cs = type == 1 ? 1 : bh >> 3;
      q += 3 + cs;
      if (q > src + n) {
        ok = false;
        break;
      }
      if (bh & 1) break;
    }
    if (ok && checksum && q + 4 > src + n) ok = false;
    one_shot = ok;
  }
  if (!one_shot) {
    uint64_t w = window < 1024 ? 1024 : window;
    if (w > (uint64_t(1) << 27) + 1) return kWindow;
  }
  const uint8_t* end = src + n;
  try {
    for (;;) {
      if (p + 3 > end) break;  // the input ends: the stream waits
      uint32_t bh = le24(p);
      bool last = bh & 1;
      int type = (bh >> 1) & 3;
      size_t size = bh >> 3;
      if (type == 3) fail();
      size_t cs = type == 1 ? 1 : size;
      if (cs > f.block_max) fail();
      if (p + 3 + cs > end) {
        // The input ends in the block: libzstd streams a raw block's
        // bytes out as they come, and waits for the rest of any other.
        if (type == 0) {
          f.out.insert(f.out.end(), p + 3, end);
          f.flushed = f.out.size();
        }
        break;
      }
      if (type == 0) {
        f.out.insert(f.out.end(), p + 3, p + 3 + size);
      } else if (type == 1) {
        if (size > f.block_max) fail();
        f.out.insert(f.out.end(), size, p[3]);
      } else {
        compressed_block(f, p + 3, size);
      }
      p += 3 + cs;
      size_t made = f.out.size();
      if (last && fcs_known && made != fcs) fail();
      f.flushed = made;
      // Streaming, a block's flush that fills the output ends the call;
      // one that fills it exactly lets the next block (or the checksum)
      // be read first.
      if (!one_shot && made > occ) break;
      if (last) {
        if (checksum) {
          if (p + 4 > end) break;
          if (uint32_t(xxh64(f.out.data(), made)) != le32(p)) fail();
        }
        break;
      }
    }
  } catch (const Error& e) {
    // Streaming, libzstd has flushed the blocks before the bad one; at
    // once, it has written nothing libtiff keeps.
    size_t k = one_shot ? 0 : f.flushed < occ ? f.flushed : occ;
    memcpy(dst, f.out.data(), k);
    *made_out = int64_t(k);
    return e.code;
  }
  size_t k = f.out.size() < occ ? f.out.size() : occ;
  memcpy(dst, f.out.data(), k);
  *made_out = int64_t(k);
  return f.out.size() < occ ? kShort : 0;
}

}  // namespace

extern "C" {

int gpt_zstd_tiff(const uint8_t* src, int64_t n, uint8_t* out, int64_t occ,
                  int64_t* made) {
  return decode(src, size_t(n), out, size_t(occ), made);
}

}  // extern "C"
