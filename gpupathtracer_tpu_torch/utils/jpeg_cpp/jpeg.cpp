// A JPEG decoder whose output is bit for bit libjpeg-turbo 3.1's as PIL
// drives it (jpeg-6b API, the defaults a plain jpeg_read_header /
// jpeg_start_decompress gives): JDCT_ISLOW as its SIMD code computes it
// (jidctint-avx2.asm, which differs from jidctint.c at the extremes: see
// idct_islow), fancy upsampling (jdsample.c: h2v1, h2v2 with context rows,
// h1v2, int_upsample and the box upsamplers it falls back to below three
// samples a row, and always for lossless files), block smoothing of
// progressive files (jdcoefct.c decompress_smooth_data) and the
// table-driven YCbCr -> RGB of jdcolor.c.
//
// Reads every process libjpeg-turbo reads at 8-bit precision: sequential
// and progressive DCT, Huffman (SOF0-2) or arithmetic coded (SOF9-10, DAC
// conditioning; T.81 Annex D and F.2.4, jdarith.c), and lossless (SOF3:
// predictors 1-7, point transform, jdlossls.c / jdlhuff.c / jddiffct.c);
// 1, 3 or 4 components (CMYK, or YCCK by an Adobe marker, taken to CMYK
// by jdcolor.c's ycck_cmyk_convert), sampling factors 1-4, DQT, DHT and
// libjpeg's standard Huffman tables (jstdhuff.c) where a scan's table 0 or
// 1 is not defined, DRI / RST0-7. Corrupt data is recovered from as libjpeg
// recovers: a scan cut by a marker is finished on zero bits and the rest of
// its restart interval left as it is (insufficient_data), a missing or
// out-of-order RST marker is resynced by jpeg_resync_to_restart's four
// actions, a bad Huffman code decodes as symbol 0, and corrupt arithmetic
// data stops its scan's decoding without an error. Integer arithmetic only.
//
// The input is read as PIL hands it to libjpeg: in buffers that end at
// multiples of 64 KiB (ImageFile.MAXBLOCK), where a Huffman or marker read
// suspends and resumes and an arithmetic read fails (jdarith.c cannot
// suspend); a read past the end of the file is PIL's "image file is
// truncated", except after the last MCU of a single-scan file, where PIL
// ignores jpeg_finish_decompress's suspension. With source 1 the input is
// read as libtiff hands a strip to libjpeg: whole, with a fake EOI past its
// end (tif_jpeg.c std_fill_input_buffer).
//
// C interface (ctypes, utils/jpeg.py):
//   int gpt_jpeg_info(data, n, source, dims[3], err, errlen)  -> height,
//       width, components of the frame;
//   int gpt_jpeg_decode(data, n, source, out, h, w, colour, err, errlen)
//       -> out [h, w, 3] uint8 RGB, grey replicated, or [h, w, 4] CMYK for
//       four components (as libjpeg gives it: PIL's "CMYK;I" inverts it
//       after). colour 0 picks three components' colour space as libjpeg
//       does (JFIF, Adobe, component ids, the process), 1 keeps the
//       components as they are (libtiff's JCS_UNKNOWN), 2 reads them as
//       YCbCr.
// Both return 0, or 1 with a message in err for corrupt data and for what
// libjpeg or PIL refuses.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Corrupt {
  std::string msg;
};
struct Truncated {};  // a read past the end of the file (PIL's source)

[[noreturn]] void corrupt(const std::string& m) { throw Corrupt{m}; }

constexpr size_t kChunk = 65536;     // PIL's ImageFile.MAXBLOCK
constexpr int kMaxDimension = 65500;  // JPEG_MAX_DIMENSION

// jutils.c jpeg_natural_order, with the 16 extra entries libjpeg keeps so
// that a run past coefficient 63 in corrupt data lands on 63.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// T.81 Annex K.3: the luminance and chrominance DC and AC tables (16 code
// counts, then the symbols), which libjpeg installs in slots 0 and 1 where
// the file defines none by the first scan (jstdhuff.c).
const uint8_t kStdDc0[] = {
    0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07,
    0x08, 0x09, 0x0a, 0x0b};
const uint8_t kStdAc0[] = {
    0x00, 0x02, 0x01, 0x03, 0x03, 0x02, 0x04, 0x03, 0x05, 0x05, 0x04, 0x04,
    0x00, 0x00, 0x01, 0x7d, 0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32,
    0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55,
    0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85,
    0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2,
    0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea,
    0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdDc1[] = {
    0x00, 0x03, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07,
    0x08, 0x09, 0x0a, 0x0b};
const uint8_t kStdAc1[] = {
    0x00, 0x02, 0x01, 0x02, 0x04, 0x04, 0x03, 0x04, 0x07, 0x05, 0x04, 0x04,
    0x00, 0x01, 0x02, 0x77, 0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81,
    0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0,
    0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17,
    0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54,
    0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9,
    0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9,
    0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// T.81 Table D.2, the QM coder's probability estimation: Qe, Next_Index_LPS,
// Next_Index_MPS, Switch_MPS; entry 113 is the fixed estimate of 0.5 that
// libjpeg codes sign and refinement bits with (T.851).
struct QeRow {
  uint16_t qe;
  uint8_t nlps, nmps, sw;
};
const QeRow kQe[114] = {
    {0x5a1d, 1, 1, 1},     {0x2586, 14, 2, 0},    {0x1114, 16, 3, 0},
    {0x080b, 18, 4, 0},    {0x03d8, 20, 5, 0},    {0x01da, 23, 6, 0},
    {0x00e5, 25, 7, 0},    {0x006f, 28, 8, 0},    {0x0036, 30, 9, 0},
    {0x001a, 33, 10, 0},   {0x000d, 35, 11, 0},   {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0},   {0x0001, 12, 13, 0},   {0x5a7f, 15, 15, 1},
    {0x3f25, 36, 16, 0},   {0x2cf2, 38, 17, 0},   {0x207c, 39, 18, 0},
    {0x17b9, 40, 19, 0},   {0x1182, 42, 20, 0},   {0x0cef, 43, 21, 0},
    {0x09a1, 45, 22, 0},   {0x072f, 46, 23, 0},   {0x055c, 48, 24, 0},
    {0x0406, 49, 25, 0},   {0x0303, 51, 26, 0},   {0x0240, 52, 27, 0},
    {0x01b1, 54, 28, 0},   {0x0144, 56, 29, 0},   {0x00f5, 57, 30, 0},
    {0x00b7, 59, 31, 0},   {0x008a, 60, 32, 0},   {0x0068, 62, 33, 0},
    {0x004e, 63, 34, 0},   {0x003b, 32, 35, 0},   {0x002c, 33, 9, 0},
    {0x5ae1, 37, 37, 1},   {0x484c, 64, 38, 0},   {0x3a0d, 65, 39, 0},
    {0x2ef1, 67, 40, 0},   {0x261f, 68, 41, 0},   {0x1f33, 69, 42, 0},
    {0x19a8, 70, 43, 0},   {0x1518, 72, 44, 0},   {0x1177, 73, 45, 0},
    {0x0e74, 74, 46, 0},   {0x0bfb, 75, 47, 0},   {0x09f8, 77, 48, 0},
    {0x0861, 78, 49, 0},   {0x0706, 79, 50, 0},   {0x05cd, 48, 51, 0},
    {0x04de, 50, 52, 0},   {0x040f, 50, 53, 0},   {0x0363, 51, 54, 0},
    {0x02d4, 52, 55, 0},   {0x025c, 53, 56, 0},   {0x01f8, 54, 57, 0},
    {0x01a4, 55, 58, 0},   {0x0160, 56, 59, 0},   {0x0125, 57, 60, 0},
    {0x00f6, 58, 61, 0},   {0x00cb, 59, 62, 0},   {0x00ab, 61, 63, 0},
    {0x008f, 61, 32, 0},   {0x5b12, 65, 65, 1},   {0x4d04, 80, 66, 0},
    {0x412c, 81, 67, 0},   {0x37d8, 82, 68, 0},   {0x2fe8, 83, 69, 0},
    {0x293c, 84, 70, 0},   {0x2379, 86, 71, 0},   {0x1edf, 87, 72, 0},
    {0x1aa9, 87, 73, 0},   {0x174e, 72, 74, 0},   {0x1424, 72, 75, 0},
    {0x119c, 74, 76, 0},   {0x0f6b, 74, 77, 0},   {0x0d51, 75, 78, 0},
    {0x0bb6, 77, 79, 0},   {0x0a40, 77, 48, 0},   {0x5832, 80, 81, 1},
    {0x4d1c, 88, 82, 0},   {0x438e, 89, 83, 0},   {0x3bdd, 90, 84, 0},
    {0x34ee, 91, 85, 0},   {0x2eae, 92, 86, 0},   {0x299a, 93, 87, 0},
    {0x2516, 86, 71, 0},   {0x5570, 88, 89, 1},   {0x4ca9, 95, 90, 0},
    {0x44d9, 96, 91, 0},   {0x3e22, 97, 92, 0},   {0x3824, 99, 93, 0},
    {0x32b4, 99, 94, 0},   {0x2e17, 93, 86, 0},   {0x56a8, 95, 96, 1},
    {0x4f46, 101, 97, 0},  {0x47e5, 102, 98, 0},  {0x41cf, 103, 99, 0},
    {0x3c3d, 104, 100, 0}, {0x375e, 99, 93, 0},   {0x5231, 105, 102, 0},
    {0x4c0f, 106, 103, 0}, {0x4639, 107, 104, 0}, {0x415e, 103, 99, 0},
    {0x5627, 105, 106, 1}, {0x50e7, 108, 107, 0}, {0x4b85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504f, 111, 107, 0}, {0x5a10, 110, 111, 1},
    {0x5522, 112, 109, 0}, {0x59eb, 112, 111, 1}, {0x5a1d, 113, 113, 0}};

// A DHT table as the file defines it, and jdhuff.c's d_derived_tbl of it
// (built where a scan starts: an unused bad table is no error).
struct Huff {
  bool defined = false;
  uint8_t bits[17];
  uint8_t vals[256];
};
struct Derived {
  int32_t maxcode[18];
  int32_t valoffset[18];
  int lookup[256];  // 8-bit lookahead: (length << 8) | symbol; 9 = longer
  const uint8_t* vals;
};

struct Comp {
  int id, h, v, tq;
  int td = 0, ta = 0;  // the table selectors of the last scan naming it
  int bw, bh;          // allocated blocks (MCU-padded)
  int wib, hib;        // width / height in blocks (jdinput.c)
  int dw, dh;          // downsampled width / height
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  std::vector<uint8_t> samp;  // lossless: dw * dh samples
  bool latched = false;       // jdinput.c latch_quant_tables
  uint16_t q[64];
  int coef_bits[64], prev_bits[64];  // jdphuff.c's progression status
  // jdlossls.c: the undifferencer's state
  bool first_row = true;
  std::vector<int32_t> prev;
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + int((~0u) << s) + 1 : v;
}

struct Decoder {
  const uint8_t* d;
  size_t n;
  bool tiff;
  size_t pos = 0;
  size_t chunk_end = kChunk;  // the end of the buffer PIL has handed over
  bool no_suspend = false;    // inside an arithmetic scan
  int unread_marker = 0;
  bool saw_soi = false, saw_sof = false;
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false, arith = false, lossless = false;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  bool qt_defined[4] = {false, false, false, false};
  uint16_t qt[4][64];  // natural order
  Huff dc_tbl[4], ac_tbl[4];
  uint8_t arith_dc_L[16], arith_dc_U[16], arith_ac_K[16];
  Comp comp[4];
  int maxh = 1, maxv = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  int input_scan_number = 0;
  bool has_multiple_scans = false;
  int last_good = 0;  // jdmaster.c last_good_iMCU_row

  Decoder(const uint8_t* data, size_t size, bool libtiff)
      : d(data), n(size), tiff(libtiff) {
    if (tiff) chunk_end = SIZE_MAX;
    for (int i = 0; i < 16; i++) {
      arith_dc_L[i] = 0;
      arith_dc_U[i] = 1;
      arith_ac_K[i] = 5;
    }
  }

  // --- the source manager ------------------------------------------------

  // The byte at p as libjpeg's source gives it: past PIL's buffer a new
  // one (a suspension, which a suspending reader resumes; an arithmetic
  // scan cannot), past the file's end PIL's truncation or libtiff's EOI.
  int at(size_t p) {
    if (p >= n) {
      if (tiff) return ((p - n) & 1) ? 0xD9 : 0xFF;
      throw Truncated{};
    }
    if (p >= chunk_end) {
      if (no_suspend)
        corrupt("arithmetic-coded data past PIL's 64 KiB input buffer "
                "(libjpeg's arithmetic decoder cannot suspend)");
      chunk_end = (p / kChunk + 1) * kChunk;
    }
    return d[p];
  }
  int in() { return at(pos++); }
  int in16() {
    int a = in();
    return (a << 8) | in();
  }
  // Bytes left in the buffer libjpeg holds (bytes_in_buffer).
  size_t avail() const {
    size_t e = chunk_end < n ? chunk_end : n;
    return pos < e ? e - pos : 0;
  }

  // --- jdmarker.c ----------------------------------------------------------

  void first_marker() {
    int c = in(), c2 = in();
    if (c != 0xFF || c2 != 0xD8) corrupt("not a JPEG file (no SOI)");
    unread_marker = c2;
  }

  void next_marker() {
    int c;
    for (;;) {
      c = in();
      while (c != 0xFF) c = in();  // garbage: JWRN_EXTRANEOUS_DATA
      do c = in();
      while (c == 0xFF);
      if (c != 0) break;
    }
    unread_marker = c;
  }

  void skip_variable() {
    long len = in16() - 2;
    if (len > 0) pos += size_t(len);
  }

  void get_soi() {
    if (saw_soi) corrupt("a second SOI marker");
    for (int i = 0; i < 16; i++) {
      arith_dc_L[i] = 0;
      arith_dc_U[i] = 1;
      arith_ac_K[i] = 5;
    }
    restart_interval = 0;
    jfif = adobe = false;
    adobe_transform = 0;
    saw_soi = true;
  }

  void get_sof(bool prog, bool loss, bool ari) {
    if (saw_sof) corrupt("a second frame header");
    progressive = prog;
    lossless = loss;
    arith = ari;
    int len = in16();
    int prec = in();
    height = in16();
    width = in16();
    ncomp = in();
    // PIL's SOF handler refuses every precision but 8 and layer counts
    // other than 1, 3 and 4 (PIL/JpegImagePlugin.py SOF).
    if (prec != 8) corrupt("cannot handle " + std::to_string(prec) +
                           "-bit layers (PIL reads 8-bit JPEG only)");
    if (height <= 0 || width <= 0 || ncomp <= 0)
      corrupt("empty image (a DNL height is not read by libjpeg either)");
    if (len - 8 != ncomp * 3) corrupt("bad SOF length");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      corrupt("cannot handle " + std::to_string(ncomp) + "-layer images");
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.id = in();
      int hv = in();
      c.h = (hv >> 4) & 15;
      c.v = hv & 15;
      c.tq = in();
    }
    saw_sof = true;
  }

  int scomp[4], ns = 0, Ss = 0, Se = 0, Ah = 0, Al = 0;
  int next_restart_num = 0;

  void get_sos() {
    if (!saw_sof) corrupt("SOS before SOF");
    int len = in16();
    int k = in();
    if (len != k * 2 + 6 || k > 4 || (k == 0 && !progressive))
      corrupt("bad SOS length");
    ns = k;
    const Comp* cur[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int i = 0; i < k; i++) {
      int cc = in(), t = in();
      int found = -1;
      for (int ci = 0; ci < ncomp && ci < 4; ci++)
        if (cc == comp[ci].id && !cur[ci]) {
          found = ci;
          break;
        }
      if (found < 0) corrupt("SOS names an unknown component");
      for (int pi = 0; pi < i; pi++)
        if (cur[pi] == &comp[found]) corrupt("SOS names a component twice");
      cur[i] = &comp[found];
      scomp[i] = found;
      comp[found].td = (t >> 4) & 15;
      comp[found].ta = t & 15;
    }
    Ss = in();
    Se = in();
    int a = in();
    Ah = (a >> 4) & 15;
    Al = a & 15;
    next_restart_num = 0;
    input_scan_number++;
  }

  void get_dac() {
    long len = in16() - 2;
    while (len > 0) {
      int index = in(), val = in();
      len -= 2;
      if (index >= 32) corrupt("bad DAC index");
      if (index >= 16) {
        arith_ac_K[index - 16] = uint8_t(val);
      } else {
        arith_dc_L[index] = uint8_t(val & 15);
        arith_dc_U[index] = uint8_t(val >> 4);
        if (arith_dc_L[index] > arith_dc_U[index]) corrupt("bad DAC value");
      }
    }
    if (len != 0) corrupt("bad DAC length");
  }

  void get_dht() {
    long len = in16() - 2;
    while (len > 16) {
      int index = in();
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = uint8_t(in());
        count += bits[i];
      }
      len -= 17;
      if (count > 256 || count > len) corrupt("bad Huffman table");
      uint8_t vals[256];
      for (int i = 0; i < count; i++) vals[i] = uint8_t(in());
      std::memset(vals + count, 0, size_t(256 - count));
      len -= count;
      Huff* h;
      if (index & 0x10) {
        index -= 0x10;
        if (index < 0 || index >= 4) corrupt("bad DHT table number");
        h = &ac_tbl[index];
      } else {
        if (index < 0 || index >= 4) corrupt("bad DHT table number");
        h = &dc_tbl[index];
      }
      std::memcpy(h->bits, bits, sizeof bits);
      std::memcpy(h->vals, vals, sizeof vals);
      h->defined = true;
    }
    if (len != 0) corrupt("bad DHT length");
  }

  void get_dqt() {
    long len = in16() - 2;
    while (len > 0) {
      len--;
      int t = in();
      int prec = t >> 4;
      t &= 15;
      if (t >= 4) corrupt("bad DQT table number");
      for (int i = 0; i < 64; i++)
        qt[t][kNatural[i]] = uint16_t(prec ? in16() : in());
      qt_defined[t] = true;
      len -= 64;
      if (prec) len -= 64;
    }
    if (len != 0) corrupt("bad DQT length");
  }

  void get_dri() {
    if (in16() != 4) corrupt("bad DRI length");
    restart_interval = in16();
  }

  // get_interesting_appn: the first 14 bytes of APP0 and APP14.
  void get_app(int m) {
    long len = in16() - 2;
    uint8_t b[14];
    int k = len >= 14 ? 14 : (len > 0 ? int(len) : 0);
    for (int i = 0; i < k; i++) b[i] = uint8_t(in());
    len -= k;
    if (m == 0xE0 && k >= 14 && !std::memcmp(b, "JFIF\0", 5)) jfif = true;
    if (m == 0xEE && k >= 12 && !std::memcmp(b, "Adobe", 5)) {
      adobe = true;
      adobe_transform = b[11];
    }
    if (len > 0) pos += size_t(len);
  }

  // read_markers: 'S' at an SOS (its header read), 'E' at EOI.
  int read_markers() {
    for (;;) {
      if (unread_marker == 0) {
        if (!saw_soi)
          first_marker();
        else
          next_marker();
      }
      int m = unread_marker;
      if (m == 0xD8) {
        get_soi();
      } else if (m == 0xC0 || m == 0xC1) {
        get_sof(false, false, false);
      } else if (m == 0xC2) {
        get_sof(true, false, false);
      } else if (m == 0xC3) {
        get_sof(false, true, false);
      } else if (m == 0xC9) {
        get_sof(false, false, true);
      } else if (m == 0xCA) {
        get_sof(true, false, true);
      } else if (m == 0xCB) {
        get_sof(false, true, true);
      } else if ((m >= 0xC5 && m <= 0xC8) || (m >= 0xCD && m <= 0xCF)) {
        // Differential (hierarchical) processes and JPG: libjpeg refuses.
        char name[8];
        std::snprintf(name, sizeof name, "0x%02X", m);
        corrupt(std::string("unsupported JPEG process: SOF type ") + name +
                " (libjpeg refuses hierarchical files)");
      } else if (m == 0xDA) {
        get_sos();
        unread_marker = 0;
        return 'S';
      } else if (m == 0xD9) {
        unread_marker = 0;
        return 'E';
      } else if (m == 0xCC) {
        get_dac();
      } else if (m == 0xC4) {
        get_dht();
      } else if (m == 0xDB) {
        get_dqt();
      } else if (m == 0xDD) {
        get_dri();
      } else if (m == 0xE0 || m == 0xEE) {
        get_app(m);
      } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
        skip_variable();  // APPn, COM and DNL
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // RSTn and TEM carry no parameters
      } else {
        // DHP, EXP, JPGn and RESn are fatal.
        char name[8];
        std::snprintf(name, sizeof name, "0x%02X", m);
        corrupt(std::string("unknown marker ") + name);
      }
      unread_marker = 0;
    }
  }

  // --- jdinput.c -----------------------------------------------------------

  // At the first SOS.
  void initial_setup() {
    if (height > kMaxDimension || width > kMaxDimension)
      corrupt("image too big (over 65500 pixels a side)");
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        corrupt("bad sampling factors");
      if (c.h > maxh) maxh = c.h;
      if (c.v > maxv) maxv = c.v;
    }
    int unit = lossless ? 1 : 8;
    mcux = (width + unit * maxh - 1) / (unit * maxh);
    mcuy = (height + unit * maxv - 1) / (unit * maxv);
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.dw = int((int64_t(width) * c.h + maxh - 1) / maxh);
      c.dh = int((int64_t(height) * c.v + maxv - 1) / maxv);
      c.wib = (c.dw + unit - 1) / unit;
      c.hib = (c.dh + unit - 1) / unit;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      for (int k = 0; k < 64; k++) {
        c.coef_bits[k] = -1;
        c.prev_bits[k] = 0;
      }
    }
    has_multiple_scans = ns < ncomp || progressive;
  }

  // jdmaster.c master_selection (at jpeg_start_decompress): what must hold
  // before any scan is decoded.
  void master_selection() {
    if (lossless && arith)
      corrupt("arithmetic-coded lossless JPEG (SOF11: libjpeg-turbo does "
              "not read it)");
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      if (maxh % c.h || maxv % c.v)
        corrupt("fractional sampling ratios (libjpeg refuses them too)");
      if (lossless)
        c.samp.assign(size_t(c.dw) * c.dh, 0);
      else
        c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    }
    if (!arith && !progressive && !lossless) {
      // jstdhuff.c std_huff_tables, from jinit_huff_decoder; the
      // progressive and lossless Huffman decoders install none.
      const uint8_t* std[4] = {kStdDc0, kStdAc0, kStdDc1, kStdAc1};
      for (int t = 0; t < 2; t++)
        for (int cls = 0; cls < 2; cls++) {
          Huff& h = cls ? ac_tbl[t] : dc_tbl[t];
          if (h.defined) continue;
          const uint8_t* s = std[2 * t + cls];
          h.bits[0] = 0;
          int count = 0;
          for (int l = 1; l <= 16; l++) count += h.bits[l] = s[l - 1];
          std::memset(h.vals, 0, sizeof h.vals);
          std::memcpy(h.vals, s + 16, size_t(count));
          h.defined = true;
        }
    }
  }

  // jdhuff.c jpeg_make_d_derived_tbl.
  void derive(bool is_dc, int t, Derived& out) {
    if (t < 0 || t >= 4) corrupt("a scan names Huffman table " +
                                 std::to_string(t));
    const Huff& h = is_dc ? dc_tbl[t] : ac_tbl[t];
    if (!h.defined)
      corrupt("a scan uses Huffman table " + std::to_string(t) +
              ", which the file does not define");
    int huffsize[257];
    unsigned huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      int i = h.bits[l];
      if (p + i > 256) corrupt("bad Huffman table");
      while (i--) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    int numsymbols = p;
    unsigned code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) {
        huffcode[p++] = code;
        code++;
      }
      if (code >= (1u << si)) corrupt("bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (h.bits[l]) {
        out.valoffset[l] = p - int32_t(huffcode[p]);
        p += h.bits[l];
        out.maxcode[l] = int32_t(huffcode[p - 1]);
      } else {
        out.maxcode[l] = -1;
      }
    }
    out.valoffset[17] = 0;
    out.maxcode[17] = 0xFFFFF;
    for (int i = 0; i < 256; i++) out.lookup[i] = 9 << 8;
    p = 0;
    for (int l = 1; l <= 8; l++)
      for (int i = 1; i <= h.bits[l]; i++, p++) {
        int look = int(huffcode[p] << (8 - l));
        for (int ctr = 1 << (8 - l); ctr > 0; ctr--)
          out.lookup[look++] = (l << 8) | h.vals[p];
      }
    if (is_dc)
      for (int i = 0; i < numsymbols; i++)
        if (h.vals[i] > (lossless ? 16 : 15)) corrupt("bad Huffman table");
    out.vals = h.vals;
  }

  // --- the bit reader of jdhuff.c (jpeg_fill_bit_buffer and its macros) ---

  uint64_t gb = 0;  // get_buffer
  int bl = 0;       // bits_left
  bool insufficient = false;

  void fill(int nbits) {
    if (unread_marker == 0) {
      while (bl < 57) {
        int c = in();
        if (c == 0xFF) {
          do c = in();
          while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker = c;
            goto no_more_bytes;
          }
        }
        gb = (gb << 8) | uint64_t(c);
        bl += 8;
      }
      return;
    }
  no_more_bytes:
    if (nbits > bl) {
      insufficient = true;  // JWRN_HIT_MARKER: zero bits from here on
      gb <<= 57 - bl;
      bl = 57;
    }
  }
  int get(int k) {
    bl -= k;
    return int((gb >> bl) & ((uint64_t(1) << k) - 1));
  }
  int getn(int k) {  // CHECK_BIT_BUFFER then GET_BITS
    if (bl < k) fill(k);
    return get(k);
  }
  // HUFF_DECODE, and jpeg_huff_decode for codes longer than 8 bits.
  int huff(const Derived& t) {
    int nb;
    if (bl < 8) {
      fill(0);
      if (bl < 8) {
        nb = 1;
        goto slow;
      }
    }
    {
      int e = t.lookup[(gb >> (bl - 8)) & 0xFF];
      nb = e >> 8;
      if (nb <= 8) {
        bl -= nb;
        return e & 0xFF;
      }
    }
  slow:
    int32_t code = getn(nb);
    while (code > t.maxcode[nb]) {
      code = (code << 1) | getn(1);
      nb++;
    }
    if (nb > 16) return 0;  // JWRN_HUFF_BAD_CODE: a zero is the safest
    return t.vals[code + t.valoffset[nb]];
  }

  // decode_mcu_fast's reader: six bytes whenever 16 bits or fewer are left,
  // a marker backed out and read as zero bytes.
  void fill_fast() {
    if (bl > 16) return;
    for (int i = 0; i < 6; i++) {
      int c0 = d[pos++], c1 = d[pos];
      gb = (gb << 8) | uint64_t(c0);
      bl += 8;
      if (c0 == 0xFF) {
        pos++;
        if (c1 != 0) {
          unread_marker = c1;
          pos -= 2;
          gb &= ~uint64_t(0xFF);
        }
      }
    }
  }
  int huff_fast(const Derived& t) {
    fill_fast();
    int s = t.lookup[(gb >> (bl - 8)) & 0xFF];
    int nb = s >> 8;
    bl -= nb;
    s &= 0xFF;
    if (nb > 8) {
      s = int((gb >> bl) & ((uint64_t(1) << nb) - 1));
      while (s > t.maxcode[nb]) {
        s = (s << 1) | get(1);
        nb++;
      }
      s = nb > 16 ? 0 : t.vals[(s + t.valoffset[nb]) & 0xFF];
    }
    return s;
  }

  // --- restarts: jdmarker.c read_restart_marker / jpeg_resync_to_restart --

  void resync(int desired) {
    int marker = unread_marker;
    for (;;) {
      int action;
      if (marker < 0xC0) {
        action = 2;  // an invalid marker
      } else if (marker < 0xD0 || marker > 0xD7) {
        action = 3;  // a valid non-restart marker
      } else if (marker == 0xD0 + ((desired + 1) & 7) ||
                 marker == 0xD0 + ((desired + 2) & 7)) {
        action = 3;  // one of the next two expected restarts
      } else if (marker == 0xD0 + ((desired - 1) & 7) ||
                 marker == 0xD0 + ((desired - 2) & 7)) {
        action = 2;  // a prior restart, so advance
      } else {
        action = 1;  // the desired restart, or too far away
      }
      if (action == 1) {
        unread_marker = 0;  // discard it and resume after it
        return;
      }
      if (action == 3) return;  // leave it: an empty segment
      next_marker();
      marker = unread_marker;
    }
  }
  void read_restart_marker() {
    if (unread_marker == 0) next_marker();
    if (unread_marker == 0xD0 + next_restart_num)
      unread_marker = 0;
    else
      resync(next_restart_num);
    next_restart_num = (next_restart_num + 1) & 7;
  }

  // --- scans -----------------------------------------------------------

  int restarts_to_go = 0;
  int blocks_in_mcu = 0;
  int16_t* mcu_blk[10];
  int mcu_memb[10];
  Derived dtbl[4], atbl[4];
  int last_dc[4];
  int eobrun = 0;
  enum Kind { SEQ, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE } kind = SEQ;

  int16_t* block(Comp& c, int bx, int by) {
    return &c.coef[(size_t(by) * c.bw + bx) * 64];
  }

  // jdinput.c start_input_pass: per_scan_setup, latch_quant_tables and the
  // entropy decoder's start_pass.
  void start_scan() {
    blocks_in_mcu = 0;
    if (ns > 1)
      for (int i = 0; i < ns; i++)
        blocks_in_mcu += comp[scomp[i]].h * comp[scomp[i]].v;
    if (blocks_in_mcu > 10)
      corrupt("an MCU of more than 10 blocks (libjpeg refuses it too)");
    if (!lossless)
      for (int i = 0; i < ns; i++) {
        Comp& c = comp[scomp[i]];
        if (c.latched) continue;
        if (c.tq >= 4 || !qt_defined[c.tq])
          corrupt("missing quantization table");
        std::memcpy(c.q, qt[c.tq], sizeof c.q);
        c.latched = true;
      }
    if (progressive) {
      // jdphuff.c / jdarith.c start_pass: errors; the warnings pass.
      bool bad = false;
      if (Ss == 0) {
        if (Se != 0) bad = true;
      } else {
        if (Se < Ss || Se > 63) bad = true;
        if (ns != 1) bad = true;
      }
      if (Ah != 0 && Al != Ah - 1) bad = true;
      if (Al > 13) bad = true;
      if (bad) corrupt("bad progression parameters");
      for (int i = 0; i < ns; i++) {
        Comp& c = comp[scomp[i]];
        int lo = Ss < 1 ? Ss : 1, hi = Se > 9 ? Se : 9;
        for (int k = lo; k <= hi; k++)
          c.prev_bits[k] = input_scan_number > 1 ? c.coef_bits[k] : 0;
        for (int k = Ss; k <= Se; k++) c.coef_bits[k] = Al;
      }
      kind = Ss == 0 ? (Ah == 0 ? DC_FIRST : DC_REFINE)
                     : (Ah == 0 ? AC_FIRST : AC_REFINE);
    } else if (lossless) {
      // jdlossls.c start_pass_lossless
      if (Ss < 1 || Ss > 7 || Se != 0 || Ah != 0 || Al >= 8)
        corrupt("bad lossless scan parameters");
      kind = SEQ;
    } else {
      kind = SEQ;
    }
    if (arith) {
      for (int i = 0; i < ns; i++) {
        Comp& c = comp[scomp[i]];
        if (!progressive || (Ss == 0 && Ah == 0)) {
          std::memset(dc_stats[c.td], 0, 64);
          last_dc[i] = 0;
          dc_context[i] = 0;
        }
        if (!progressive || Ss)
          std::memset(ac_stats[c.ta], 0, 256);
      }
      creg = 0;
      areg = 0;
      ct = -16;
    } else {
      for (int i = 0; i < ns; i++) {
        Comp& c = comp[scomp[i]];
        if (lossless || !progressive || (Ss == 0 && Ah == 0))
          derive(true, c.td, dtbl[i]);
        if (!lossless && (!progressive || Ss)) derive(false, c.ta, atbl[i]);
        last_dc[i] = 0;
      }
      bl = 0;
      gb = 0;
    }
    insufficient = false;
    eobrun = 0;
    restarts_to_go = restart_interval;
  }

  void huff_restart() {
    bl = 0;
    read_restart_marker();
    for (int i = 0; i < ns; i++) last_dc[i] = 0;
    eobrun = 0;
    restarts_to_go = restart_interval;
    if (unread_marker == 0) insufficient = false;
  }

  // jdhuff.c decode_mcu_slow / decode_mcu_fast.
  void seq_slow() {
    for (int b = 0; b < blocks_in_mcu; b++) {
      int ci = mcu_memb[b];
      int16_t* blk = mcu_blk[b];
      int s = huff(dtbl[ci]);
      if (s) s = extend(getn(s), s);
      last_dc[ci] = int(unsigned(last_dc[ci]) + unsigned(s));
      blk[0] = int16_t(last_dc[ci]);
      const Derived& t = atbl[ci];
      for (int k = 1; k < 64; k++) {
        s = huff(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = int16_t(extend(getn(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }
  bool seq_fast() {
    for (int b = 0; b < blocks_in_mcu; b++) {
      int ci = mcu_memb[b];
      int16_t* blk = mcu_blk[b];
      int s = huff_fast(dtbl[ci]);
      if (s) {
        fill_fast();
        s = extend(get(s), s);
      }
      last_dc[ci] = int(unsigned(last_dc[ci]) + unsigned(s));
      blk[0] = int16_t(last_dc[ci]);
      const Derived& t = atbl[ci];
      for (int k = 1; k < 64; k++) {
        s = huff_fast(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          fill_fast();
          blk[kNatural[k]] = int16_t(extend(get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
    if (unread_marker != 0) {
      unread_marker = 0;
      return false;
    }
    return true;
  }
  void mcu_seq_huff() {
    bool usefast = true;
    if (restart_interval) {
      if (restarts_to_go == 0) huff_restart();
      usefast = false;
    }
    if (avail() < size_t(512) * blocks_in_mcu || unread_marker != 0)
      usefast = false;
    if (!insufficient) {
      bool done = false;
      if (usefast) {
        size_t pos0 = pos;
        uint64_t gb0 = gb;
        int bl0 = bl, dc0[4];
        std::memcpy(dc0, last_dc, sizeof dc0);
        done = seq_fast();
        if (!done) {
          // A marker inside the MCU: decode it again on the slow path
          // (the same values, and insufficient_data where bits run out).
          pos = pos0;
          gb = gb0;
          bl = bl0;
          std::memcpy(last_dc, dc0, sizeof dc0);
        }
      }
      if (!done) seq_slow();
    }
    if (restart_interval) restarts_to_go--;
  }

  // jdphuff.c's four MCU decoders.
  void mcu_prog_huff() {
    if (restart_interval && restarts_to_go == 0) huff_restart();
    switch (kind) {
      case DC_FIRST:
        if (!insufficient)
          for (int b = 0; b < blocks_in_mcu; b++) {
            int ci = mcu_memb[b];
            int s = huff(dtbl[ci]);
            if (s) s = extend(getn(s), s);
            last_dc[ci] = int(unsigned(last_dc[ci]) + unsigned(s));
            mcu_blk[b][0] = int16_t(unsigned(last_dc[ci]) << Al);
          }
        break;
      case DC_REFINE:
        // No insufficient_data test: zero bits change nothing.
        for (int b = 0; b < blocks_in_mcu; b++)
          if (getn(1)) mcu_blk[b][0] = int16_t(mcu_blk[b][0] | (1 << Al));
        break;
      case AC_FIRST:
        if (!insufficient) {
          if (eobrun > 0) {
            eobrun--;
          } else {
            int16_t* blk = mcu_blk[0];
            const Derived& t = atbl[0];
            for (int k = Ss; k <= Se; k++) {
              int s = huff(t);
              int r = s >> 4;
              s &= 15;
              if (s) {
                k += r;
                int v = extend(getn(s), s);
                blk[kNatural[k]] = int16_t(unsigned(v) << Al);
              } else if (r == 15) {
                k += 15;
              } else {
                eobrun = 1 << r;
                if (r) eobrun += getn(r);
                eobrun--;
                break;
              }
            }
          }
        }
        break;
      case AC_REFINE:
        if (!insufficient) ac_refine(mcu_blk[0]);
        break;
      default:
        break;
    }
    if (restart_interval) restarts_to_go--;
  }

  void ac_refine(int16_t* blk) {
    int p1 = 1 << Al;
    int m1 = int(~0u << Al);
    int k = Ss;
    const Derived& t = atbl[0];
    if (eobrun == 0) {
      for (; k <= Se; k++) {
        int s = huff(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = getn(1) ? p1 : m1;  // a size other than 1 is only a warning
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += getn(r);
          break;
        }
        do {
          int16_t* c = blk + kNatural[k];
          if (*c != 0) {
            if (getn(1)) {
              if ((*c & p1) == 0) *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= Se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; k++) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) {
          if (getn(1)) {
            if ((*c & p1) == 0) *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
          }
        }
      }
      eobrun--;
    }
  }

  // --- jdarith.c -------------------------------------------------------------

  int64_t creg = 0, areg = 0;  // the C and A registers
  int ct = -16;
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};
  int dc_context[4];

  int decode(uint8_t* st) {
    while (areg < 0x8000) {
      if (--ct < 0) {
        int data;
        if (unread_marker) {
          data = 0;
        } else {
          data = in();
          if (data == 0xFF) {
            do data = in();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              unread_marker = data;  // legal here: zeros from now on
              data = 0;
            }
          }
        }
        creg = (creg << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) areg = 0x8000;  // two initial bytes: A = 0x10000
      }
      areg <<= 1;
    }
    int sv = *st;
    const QeRow& row = kQe[sv & 0x7F];
    int64_t qe = row.qe;
    int nl = row.nlps | (row.sw << 7), nm = row.nmps;
    int64_t temp = areg - qe;
    areg = temp;
    temp <<= ct;
    if (creg >= temp) {
      creg -= temp;
      if (areg < qe) {
        areg = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        areg = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (areg < 0x8000) {
      if (areg < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  void arith_restart() {
    read_restart_marker();
    for (int i = 0; i < ns; i++) {
      Comp& c = comp[scomp[i]];
      if (!progressive || (Ss == 0 && Ah == 0)) {
        std::memset(dc_stats[c.td], 0, 64);
        last_dc[i] = 0;
        dc_context[i] = 0;
      }
      if (!progressive || Ss) std::memset(ac_stats[c.ta], 0, 256);
    }
    creg = 0;
    areg = 0;
    ct = -16;
    restarts_to_go = restart_interval;
  }

  // F.2.4.1: a DC difference; false on corrupt data (ct = -1).
  bool arith_dc(int ci, int tbl) {
    uint8_t* st = dc_stats[tbl] + dc_context[ci];
    if (decode(st) == 0) {
      dc_context[ci] = 0;
      return true;
    }
    int sign = decode(st + 1);
    st += 2 + sign;
    int m = decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ct = -1;  // JWRN_ARITH_BAD_CODE: magnitude overflow
          return false;
        }
        st += 1;
      }
    }
    if (m < int((1L << arith_dc_L[tbl]) >> 1))
      dc_context[ci] = 0;
    else if (m > int((1L << arith_dc_U[tbl]) >> 1))
      dc_context[ci] = 12 + sign * 4;
    else
      dc_context[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc[ci] = (last_dc[ci] + v) & 0xFFFF;
    return true;
  }

  // F.2.4.2 / G.1.3.2: AC coefficients Ss..Se of a block; false on
  // corrupt data.
  bool arith_ac(int16_t* blk, int tbl, int lo, int hi, int shift) {
    for (int k = lo; k <= hi; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (decode(st)) break;  // EOB
      while (decode(st + 1) == 0) {
        st += 3;
        if (++k > hi) {
          ct = -1;  // JWRN_ARITH_BAD_CODE: spectral overflow
          return false;
        }
      }
      int sign = decode(fixed_bin);
      st += 2;
      int m = decode(st);
      if (m != 0) {
        if (decode(st)) {
          m <<= 1;
          st = ac_stats[tbl] + (k <= arith_ac_K[tbl] ? 189 : 217);
          while (decode(st)) {
            if ((m <<= 1) == 0x8000) {
              ct = -1;  // magnitude overflow
              return false;
            }
            st += 1;
          }
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = int16_t(unsigned(v) << shift);
    }
    return true;
  }

  void mcu_arith() {
    if (restart_interval) {
      if (restarts_to_go == 0) arith_restart();
      restarts_to_go--;
    }
    switch (kind) {
      case SEQ:
        if (ct == -1) return;
        for (int b = 0; b < blocks_in_mcu; b++) {
          int ci = mcu_memb[b];
          Comp& c = comp[scomp[ci]];
          if (!arith_dc(ci, c.td)) return;
          mcu_blk[b][0] = int16_t(last_dc[ci]);
          if (!arith_ac(mcu_blk[b], c.ta, 1, 63, 0)) return;
        }
        return;
      case DC_FIRST:
        if (ct == -1) return;
        for (int b = 0; b < blocks_in_mcu; b++) {
          int ci = mcu_memb[b];
          if (!arith_dc(ci, comp[scomp[ci]].td)) return;
          mcu_blk[b][0] = int16_t(unsigned(last_dc[ci]) << Al);
        }
        return;
      case DC_REFINE:
        for (int b = 0; b < blocks_in_mcu; b++)
          if (decode(fixed_bin)) mcu_blk[b][0] = int16_t(mcu_blk[b][0] | (1 << Al));
        return;
      case AC_FIRST:
        if (ct == -1) return;
        arith_ac(mcu_blk[0], comp[scomp[0]].ta, Ss, Se, Al);
        return;
      case AC_REFINE: {
        if (ct == -1) return;
        int16_t* blk = mcu_blk[0];
        int tbl = comp[scomp[0]].ta;
        int p1 = 1 << Al, m1 = int(~0u << Al);
        int kex;
        for (kex = Se; kex > 0; kex--)
          if (blk[kNatural[kex]]) break;
        for (int k = Ss; k <= Se; k++) {
          uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
          if (k > kex)
            if (decode(st)) break;  // EOB
          for (;;) {
            int16_t* c = blk + kNatural[k];
            if (*c) {
              if (decode(st + 2)) *c = int16_t(*c < 0 ? *c + m1 : *c + p1);
              break;
            }
            if (decode(st + 1)) {
              *c = int16_t(decode(fixed_bin) ? m1 : p1);
              break;
            }
            st += 3;
            if (++k > Se) {
              ct = -1;  // spectral overflow
              return;
            }
          }
        }
        return;
      }
    }
  }

  // --- the scan: jdcoefct.c consume_data's MCU order ------------------------

  void decode_scan() {
    if (lossless) {
      lossless_scan();
      return;
    }
    no_suspend = arith;
    auto run_mcu = [&](int irow) {
      if (!insufficient) last_good = irow;
      if (arith)
        mcu_arith();
      else if (progressive)
        mcu_prog_huff();
      else
        mcu_seq_huff();
    };
    if (ns == 1) {
      Comp& c = comp[scomp[0]];
      blocks_in_mcu = 1;
      mcu_memb[0] = 0;
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++) {
          mcu_blk[0] = block(c, bx, by);
          run_mcu(by / c.v);
        }
    } else {
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          int b = 0;
          for (int i = 0; i < ns; i++) {
            Comp& c = comp[scomp[i]];
            for (int y = 0; y < c.v; y++)
              for (int x = 0; x < c.h; x++) {
                mcu_memb[b] = i;
                mcu_blk[b++] = block(c, mx * c.h + x, my * c.v + y);
              }
          }
          run_mcu(my);
        }
    }
    no_suspend = false;
  }

  // --- lossless: jddiffct.c, jdlhuff.c, jdlossls.c ---------------------------

  std::vector<int32_t> diff[4];  // a scan component's rows of differences

  void lossless_scan() {
    int mcus_per_row = ns > 1 ? mcux : comp[scomp[0]].wib;
    if (restart_interval % mcus_per_row != 0)
      corrupt("a lossless restart interval that is not a whole number of "
              "MCU rows (libjpeg refuses it)");
    int rows_to_go = restart_interval / mcus_per_row;
    for (int i = 0; i < ns; i++) {
      Comp& c = comp[scomp[i]];
      int rw = ns > 1 ? mcus_per_row * c.h : mcus_per_row;
      diff[i].assign(size_t(rw) * c.v, 0);
      c.prev.assign(size_t(c.dw), 0);
    }
    for (int ci = 0; ci < ncomp; ci++) comp[ci].first_row = true;
    for (int r = 0; r < mcuy; r++) {
      int per_irow = 1;
      if (ns == 1) {
        const Comp& c = comp[scomp[0]];
        per_irow = c.v;
        if (r == mcuy - 1) {
          per_irow = c.hib % c.v;
          if (per_irow == 0) per_irow = c.v;
        }
      }
      for (int yoff = 0; yoff < per_irow; yoff++) {
        if (restart_interval) {
          if (rows_to_go == 0) {
            huff_restart();
            for (int ci = 0; ci < ncomp; ci++) comp[ci].first_row = true;
            rows_to_go = restart_interval / mcus_per_row;
          }
        }
        decode_diff_row(yoff, mcus_per_row);
        if (restart_interval) rows_to_go--;
      }
      for (int i = 0; i < ns; i++) {
        Comp& c = comp[scomp[i]];
        int rows = c.v;
        if (r == mcuy - 1) {
          rows = c.hib % c.v;
          if (rows == 0) rows = c.v;
        }
        int rw = ns > 1 ? mcus_per_row * c.h : mcus_per_row;
        for (int row = 0; row < rows; row++) {
          int y = r * c.v + row;
          if (y >= c.dh) break;
          undifference(c, diff[i].data() + size_t(row) * rw,
                       c.samp.data() + size_t(y) * c.dw);
        }
      }
    }
  }

  // jdlhuff.c decode_mcus over one MCU row.
  void decode_diff_row(int yoff, int mcus_per_row) {
    if (insufficient) {
      // Zero differences, and the undifferencers start over.
      for (int i = 0; i < ns; i++) {
        Comp& c = comp[scomp[i]];
        int rw = ns > 1 ? mcus_per_row * c.h : mcus_per_row;
        int rows = ns > 1 ? c.v : 1;
        for (int y = 0; y < rows; y++)
          std::memset(diff[i].data() + size_t(yoff + y) * rw, 0,
                      size_t(rw) * sizeof(int32_t));
      }
      for (int ci = 0; ci < ncomp; ci++) comp[ci].first_row = true;
      return;
    }
    for (int m = 0; m < mcus_per_row; m++)
      for (int i = 0; i < ns; i++) {
        Comp& c = comp[scomp[i]];
        int hh = ns > 1 ? c.h : 1, vv = ns > 1 ? c.v : 1;
        int rw = ns > 1 ? mcus_per_row * c.h : mcus_per_row;
        for (int y = 0; y < vv; y++)
          for (int x = 0; x < hh; x++) {
            int s = huff(dtbl[i]);
            if (s) {
              if (s == 16)
                s = 32768;
              else
                s = extend(getn(s), s);
            }
            diff[i][size_t(yoff + y) * rw + size_t(m) * hh + x] = s;
          }
      }
  }

  // jdlossls.c: the predictors, modulo 2^16, then the point transform.
  void undifference(Comp& c, const int32_t* df, uint8_t* out) {
    int32_t* prev = c.prev.data();
    int w = c.dw;
    if (c.first_row) {
      int32_t ra = (df[0] + (1 << (8 - Al - 1))) & 0xFFFF;
      prev[0] = ra;
      for (int x = 1; x < w; x++) {
        ra = (df[x] + ra) & 0xFFFF;
        prev[x] = ra;
      }
      c.first_row = false;
    } else {
      int32_t rb = prev[0], rc;
      int32_t ra = (df[0] + rb) & 0xFFFF;
      prev[0] = ra;
      for (int x = 1; x < w; x++) {
        rc = rb;
        rb = prev[x];
        int32_t p;
        switch (Ss) {
          case 1: p = ra; break;
          case 2: p = rb; break;
          case 3: p = rc; break;
          case 4: p = ra + rb - rc; break;
          case 5: p = ra + ((rb - rc) >> 1); break;
          case 6: p = rb + ((ra - rc) >> 1); break;
          default: p = (ra + rb) >> 1; break;
        }
        ra = (df[x] + p) & 0xFFFF;
        prev[x] = ra;
      }
    }
    for (int x = 0; x < w; x++) out[x] = uint8_t(prev[x] << Al);
  }

  // --- the whole file -----------------------------------------------------

  // jpeg_read_header: the markers up to the first SOS.
  void read_header() {
    if (read_markers() == 'E')
      corrupt(saw_sof ? "no scan before EOI" : "no image");
    if (ns == 0) corrupt("an SOS of no components before any scan");
    initial_setup();
  }

  // jpeg_start_decompress and the scanline reads PIL makes, then
  // jpeg_finish_decompress.
  void decode_all() {
    read_header();
    master_selection();
    start_scan();
    decode_scan();
    if (has_multiple_scans) {
      for (;;) {
        int r = read_markers();
        if (r == 'E') break;
        if (ns == 0) continue;  // a pseudo SOS: libjpeg ignores it
        start_scan();
        decode_scan();
      }
    } else {
      // Every row is out: PIL ignores a suspension of
      // jpeg_finish_decompress, but not its errors.
      try {
        for (;;) {
          int r = read_markers();
          if (r == 'E') break;
          corrupt("a second scan in a single-scan file (libjpeg expects "
                  "EOI)");
        }
      } catch (const Truncated&) {
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
              int width, int height, bool fancy, uint8_t* out) {
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
  bool h2v1 = fancy && hr == 2 && vr == 1, h2v2 = fancy && hr == 2 && vr == 2;
  bool h1v2 = fancy && hr == 1 && vr == 2;
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


// --- jdcoefct.c: block smoothing of a progressive file ----------------------

// smoothing_ok: latch each component's progression status (and the one
// before its last scan, which the rows its last scan did not reach use).
bool smoothing_ok(const Decoder& dec, int latch[4][10], int prev[4][10]) {
  if (!dec.progressive) return false;
  bool useful = false;
  for (int ci = 0; ci < dec.ncomp; ci++) {
    const Comp& c = dec.comp[ci];
    if (!c.latched) return false;
    const uint16_t* q = c.q;
    if (!q[0] || !q[1] || !q[8] || !q[16] || !q[9] || !q[2] || !q[3] ||
        !q[10] || !q[17] || !q[24])
      return false;
    if (c.coef_bits[0] < 0) return false;
    latch[ci][0] = c.coef_bits[0];
    for (int k = 1; k < 10; k++) {
      prev[ci][k] = dec.input_scan_number > 1 ? c.prev_bits[k] : -1;
      latch[ci][k] = c.coef_bits[k];
      if (c.coef_bits[k] != 0) useful = true;
    }
  }
  return useful;
}

inline int smooth_pred(int64_t num, int64_t q, int al) {
  int pred;
  if (num >= 0) {
    pred = int(((q << 7) + num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = int(((q << 7) - num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return pred;
}

// decompress_smooth_data for one component: each block's missing low
// coefficients estimated from the DC values of its 5x5 neighbourhood (and,
// where no AC coefficient is known yet, the DC too), then the IDCT.
void smooth_component(Decoder& dec, int ci, const int latch[10],
                      const int prev[10], uint8_t* plane, int pw) {
  Comp& c = dec.comp[ci];
  const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16],
                Q11 = c.q[9], Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10],
                Q21 = c.q[17], Q30 = c.q[24];
  const int total = dec.mcuy;
  const int last_col = c.wib - 1;
  int16_t ws[64];
  for (int r = 0; r < total; r++) {
    int block_rows = c.v;
    if (r == total - 1) {
      block_rows = c.hib % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const int* cb = r > dec.last_good ? prev : latch;
    bool change_dc = true;
    for (int k = 1; k < 10; k++) change_dc &= cb[k] == -1;
    // libjpeg counts rows by this iMCU row's block_rows (its quirk at a
    // short last row kept).
    const int image_block_rows = block_rows * total;
    for (int br = 0; br < block_rows; br++) {
      const int ibr = r * block_rows + br;
      const int row = r * c.v + br;
      const int rp = ibr > 0 ? row - 1 : row;
      const int rpp = ibr > 1 ? row - 2 : rp;
      const int rn = ibr < image_block_rows - 1 ? row + 1 : row;
      const int rnn = ibr < image_block_rows - 2 ? row + 2 : rn;
      auto dcat = [&](int rr, int x) { return int(dec.block(c, x, rr)[0]); };
      int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11,
          DC12, DC13, DC14, DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22,
          DC23, DC24, DC25;
      DC01 = DC02 = DC03 = DC04 = DC05 = dcat(rpp, 0);
      DC06 = DC07 = DC08 = DC09 = DC10 = dcat(rp, 0);
      DC11 = DC12 = DC13 = DC14 = DC15 = dcat(row, 0);
      DC16 = DC17 = DC18 = DC19 = DC20 = dcat(rn, 0);
      DC21 = DC22 = DC23 = DC24 = DC25 = dcat(rnn, 0);
      for (int bn = 0; bn <= last_col; bn++) {
        std::memcpy(ws, dec.block(c, bn, row), sizeof ws);
        if (bn == 0 && bn < last_col) {
          DC04 = DC05 = dcat(rpp, 1);
          DC09 = DC10 = dcat(rp, 1);
          DC14 = DC15 = dcat(row, 1);
          DC19 = DC20 = dcat(rn, 1);
          DC24 = DC25 = dcat(rnn, 1);
        }
        if (bn + 1 < last_col) {
          DC05 = dcat(rpp, bn + 2);
          DC10 = dcat(rp, bn + 2);
          DC15 = dcat(row, bn + 2);
          DC20 = dcat(rn, bn + 2);
          DC25 = dcat(rnn, bn + 2);
        }
        int al;
        int64_t num;
        // AC01
        if ((al = cb[1]) != 0 && ws[1] == 0) {
          num = Q00 * (change_dc
                           ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 +
                              13 * DC07 - 13 * DC09 + 3 * DC10 - 3 * DC11 +
                              38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 +
                              13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                              DC24 + DC25)
                           : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = int16_t(smooth_pred(num, Q01, al));
        }
        // AC10
        if ((al = cb[2]) != 0 && ws[8] == 0) {
          num = Q00 * (change_dc
                           ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 -
                              DC06 + 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 +
                              DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 +
                              DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                           : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = int16_t(smooth_pred(num, Q10, al));
        }
        // AC20
        if ((al = cb[3]) != 0 && ws[16] == 0) {
          num = Q00 * (change_dc
                           ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 -
                              5 * DC12 - 14 * DC13 - 5 * DC14 + 2 * DC17 +
                              7 * DC18 + 2 * DC19 + DC23)
                           : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 -
                              DC23));
          ws[16] = int16_t(smooth_pred(num, Q20, al));
        }
        // AC11
        if ((al = cb[4]) != 0 && ws[9] == 0) {
          num = Q00 * (change_dc
                           ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                              9 * DC19 + DC21 - DC25)
                           : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 -
                              DC20 + DC22 - DC24 + DC04 - DC06 + 10 * DC07 -
                              10 * DC09));
          ws[9] = int16_t(smooth_pred(num, Q11, al));
        }
        // AC02
        if ((al = cb[5]) != 0 && ws[2] == 0) {
          num = Q00 * (change_dc
                           ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 +
                              7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
                              2 * DC17 - 5 * DC18 + 2 * DC19)
                           : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 -
                              DC15));
          ws[2] = int16_t(smooth_pred(num, Q02, al));
        }
        if (change_dc) {
          // AC03
          if ((al = cb[6]) != 0 && ws[3] == 0) {
            num = Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
            ws[3] = int16_t(smooth_pred(num, Q03, al));
          }
          // AC12
          if ((al = cb[7]) != 0 && ws[10] == 0) {
            num = Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
            ws[10] = int16_t(smooth_pred(num, Q12, al));
          }
          // AC21
          if ((al = cb[8]) != 0 && ws[17] == 0) {
            num = Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
            ws[17] = int16_t(smooth_pred(num, Q21, al));
          }
          // AC30
          if ((al = cb[9]) != 0 && ws[24] == 0) {
            num = Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
            ws[24] = int16_t(smooth_pred(num, Q30, al));
          }
          // DC: a Gaussian-like average of the 5x5 DC values.
          num = Q00 *
                (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                 6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
                 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
          ws[0] = int16_t(smooth_pred(num, Q00, 0));
        }
        idct_islow(ws, c.q, plane + size_t(row) * 8 * pw + size_t(bn) * 8, pw);
        DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
        DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
        DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
        DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
        DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
      }
    }
  }
}

int run(const uint8_t* data, int64_t n, int source, uint8_t* out, int h,
        int w, int colour) {
  Decoder dec(data, size_t(n), source == 1);
  try {
    dec.decode_all();
  } catch (const Truncated&) {
    corrupt("image file is truncated");
  }
  if (dec.height != h || dec.width != w) corrupt("size changed");
  int nc = dec.ncomp;
  // jdapimin.c default_decompress_parms: the colour space of 3 components.
  bool rgb = false;
  if (nc == 3) {
    if (colour == 1)
      rgb = true;
    else if (colour == 2)
      rgb = false;
    else if (dec.jfif)
      rgb = false;
    else if (dec.adobe)
      rgb = dec.adobe_transform == 0;
    else if (dec.comp[0].id == 1 && dec.comp[1].id == 2 && dec.comp[2].id == 3)
      rgb = dec.lossless;
    else if (dec.comp[0].id == 82 && dec.comp[1].id == 71 &&
             dec.comp[2].id == 66)
      rgb = true;
    else
      rgb = dec.lossless;
  }
  bool ycck = nc == 4 && colour == 0 && dec.adobe && dec.adobe_transform != 0;
  // jdcolor.c: no lossy colour conversion of a lossless file.
  if (dec.lossless && ((nc == 3 && !rgb) || ycck))
    corrupt("a lossless file in YCbCr or YCCK (libjpeg converts no "
            "lossless colour)");
  int latch[4][10], prev[4][10];
  bool smooth = smoothing_ok(dec, latch, prev);
  std::vector<std::vector<uint8_t>> full(nc);
  for (int i = 0; i < nc; i++) {
    Comp& c = dec.comp[i];
    const uint8_t* plane;
    std::vector<uint8_t> buf;
    int pw;
    if (dec.lossless) {
      plane = c.samp.data();
      pw = c.dw;
    } else {
      pw = c.bw * 8;
      buf.resize(size_t(pw) * c.bh * 8);
      if (!c.latched) std::memset(c.q, 0, sizeof c.q);  // never scanned
      if (smooth) {
        smooth_component(dec, i, latch[i], prev[i], buf.data(), pw);
      } else {
        // Only the blocks that hold real samples (libjpeg's IDCT runs
        // over width_in_blocks x height_in_blocks; the MCU padding is
        // dropped).
        for (int by = 0; by < c.hib; by++)
          for (int bx = 0; bx < c.wib; bx++)
            idct_islow(dec.block(c, bx, by), c.q,
                       buf.data() + size_t(by) * 8 * pw + bx * 8, pw);
      }
      plane = buf.data();
    }
    full[i].resize(size_t(w) * h);
    upsample(c, plane, pw, dec.maxh, dec.maxv, w, h, !dec.lossless,
             full[i].data());
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

int fail(const std::string& m, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", m.c_str());
  return 1;
}

}  // namespace

extern "C" {

int gpt_jpeg_info(const uint8_t* data, int64_t n, int32_t source,
                  int32_t* dims, char* err, int errlen) {
  try {
    Decoder dec(data, size_t(n), source == 1);
    try {
      dec.read_header();
    } catch (const Truncated&) {
      corrupt("image file is truncated");
    }
    dims[0] = dec.height;
    dims[1] = dec.width;
    dims[2] = dec.ncomp;
    return 0;
  } catch (const Corrupt& e) {
    return fail(e.msg, err, errlen);
  } catch (...) {
    return fail("decoder error", err, errlen);
  }
}

int gpt_jpeg_decode(const uint8_t* data, int64_t n, int32_t source,
                    uint8_t* out, int32_t h, int32_t w, int32_t colour,
                    char* err, int errlen) {
  try {
    return run(data, n, source, out, h, w, colour);
  } catch (const Corrupt& e) {
    return fail(e.msg, err, errlen);
  } catch (...) {
    return fail("decoder error", err, errlen);
  }
}

}  // extern "C"
