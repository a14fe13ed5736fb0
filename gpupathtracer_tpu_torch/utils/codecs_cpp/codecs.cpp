// The image codecs behind utils/dds.py, utils/gif.py, utils/tiff.py,
// utils/psd.py, utils/qoi.py, utils/sgi.py and utils/pcx.py, each giving
// bit for bit what PIL (Pillow 12.1.0) gives:
//
//   - the BCn block decoders of DDS files (Pillow's BcnDecode.c): BC1-BC5
//     (BC4 and BC5 unsigned and signed), BC6H (unsigned and signed half
//     floats taken to 8 bits as PIL takes them) and BC7, every mode;
//   - GIF's LZW (LSB first, Pillow's GifDecode.c) into a frame's rows,
//     interlaced or not;
//   - TIFF's LZW (MSB first with early change, libtiff's LZWDecode);
//   - PackBits, by rows (Pillow's PackBitsDecode.c, PSD) or over a whole
//     strip (libtiff's PackBitsDecode, TIFF);
//   - QOI (Pillow's Python QoiDecoder: its index table starts empty and
//     runs do not enter it);
//   - SGI's run-length rows (Pillow's SgiRleDecode.c: the start and length
//     tables, one row buffer reused from row to row);
//   - PCX's run-length lines (Pillow's PcxDecode.c: a run that crosses a
//     line's end is an overrun, the planes of a padded line moved
//     together).
//
// Integer arithmetic only, but BC6H's last step: a half float widened to
// float, times 255, truncated, as Pillow's C code does it in single
// precision (built with -ffp-contract=off).
//
// C interface (ctypes): each function returns a count or a status, and a
// negative value for corrupt data (the binding raises ValueError).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// --- BC1-BC5 ----------------------------------------------------------------

struct Rgba {
  uint8_t r, g, b, a;
};

void decode_565(Rgba& c, uint16_t v) {
  uint8_t r = uint8_t((v & 0xf800) >> 8);
  r |= r >> 5;
  uint8_t g = uint8_t((v & 0x07e0) >> 3);
  g |= g >> 6;
  uint8_t b = uint8_t((v & 0x001f) << 3);
  b |= b >> 5;
  c = {r, g, b, 0xff};
}

inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

// An 8-byte colour block. BC2 and BC3 always take the four-colour mode.
void decode_bc1_color(Rgba* dst, const uint8_t* src, bool separate_alpha) {
  uint16_t c0 = uint16_t(src[0] | src[1] << 8);
  uint16_t c1 = uint16_t(src[2] | src[3] << 8);
  uint32_t lut = le32(src + 4);
  Rgba p[4];
  decode_565(p[0], c0);
  decode_565(p[1], c1);
  int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b;
  int r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = {uint8_t((2 * r0 + r1) / 3), uint8_t((2 * g0 + g1) / 3),
            uint8_t((2 * b0 + b1) / 3), 0xff};
    p[3] = {uint8_t((r0 + 2 * r1) / 3), uint8_t((g0 + 2 * g1) / 3),
            uint8_t((b0 + 2 * b1) / 3), 0xff};
  } else {
    p[2] = {uint8_t((r0 + r1) / 2), uint8_t((g0 + g1) / 2),
            uint8_t((b0 + b1) / 2), 0xff};
    p[3] = {0, 0, 0, 0};  // punch-through: black
  }
  for (int n = 0; n < 16; n++) dst[n] = p[3 & (lut >> (2 * n))];
}

// An 8-byte alpha block (BC3's alpha, BC4, each channel of BC5) into
// dst[stride * n]; signed blocks (BC5S) move their endpoints by 128.
void decode_bc3_alpha(uint8_t* dst, const uint8_t* src, int stride,
                      bool sign) {
  int a0, a1;
  if (sign) {
    a0 = int(int8_t(src[0])) + 128;
    a1 = int(int8_t(src[1])) + 128;
  } else {
    a0 = src[0];
    a1 = src[1];
  }
  uint32_t lut1 = uint32_t(src[2]) | uint32_t(src[3]) << 8 |
                  uint32_t(src[4]) << 16;
  uint32_t lut2 = uint32_t(src[5]) | uint32_t(src[6]) << 8 |
                  uint32_t(src[7]) << 16;
  uint8_t a[8];
  a[0] = uint8_t(a0);
  a[1] = uint8_t(a1);
  if (a0 > a1) {
    for (int i = 1; i < 7; i++) a[i + 1] = uint8_t(((7 - i) * a0 + i * a1) / 7);
  } else {
    for (int i = 1; i < 5; i++) a[i + 1] = uint8_t(((5 - i) * a0 + i * a1) / 5);
    a[6] = 0;
    a[7] = 0xff;
  }
  for (int n = 0; n < 8; n++) dst[stride * n] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; n++) dst[stride * (8 + n)] = a[7 & (lut2 >> (3 * n))];
}

// --- BC6H and BC7: bits, weights, partitions --------------------------------

struct Bits {
  const uint8_t* p;
  int pos = 0;
  int get(int n) {
    int v = 0;
    for (int i = 0; i < n; i++, pos++)
      v |= ((p[pos >> 3] >> (pos & 7)) & 1) << i;
    return v;
  }
};

const uint8_t kW2[4] = {0, 21, 43, 64};
const uint8_t kW3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kW4[16] = {0,  4,  9,  13, 17, 21, 26, 30,
                         34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) {
  return bits == 2 ? kW2 : (bits == 3 ? kW3 : kW4);
}

// Subset of each pixel, 2 and 3 subsets, partitions 0-63.
const uint8_t kPart2[64][16] = {
    {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1},
    {0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1},
    {0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1},
    {0, 0, 0, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1},
    {0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 1},
    {0, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1},
    {0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 1, 1},
    {0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1},
    {0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1},
    {0, 1, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0},
    {0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0},
    {0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0},
    {0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1},
    {0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0},
    {0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0},
    {0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0},
    {0, 0, 1, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0, 0},
    {0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0},
    {0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0},
    {0, 1, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 1, 1, 1, 0},
    {0, 0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0},
    {0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1},
    {0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1},
    {0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0},
    {0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0},
    {0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0},
    {0, 1, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0},
    {0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0, 0, 1},
    {0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0, 0, 1, 0, 1},
    {0, 1, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 1, 0},
    {0, 0, 0, 1, 0, 0, 1, 1, 1, 1, 0, 0, 1, 0, 0, 0},
    {0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1, 0, 0},
    {0, 0, 1, 1, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 0, 0},
    {0, 1, 1, 0, 1, 0, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0},
    {0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1},
    {0, 1, 1, 0, 0, 1, 1, 0, 1, 0, 0, 1, 1, 0, 0, 1},
    {0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0},
    {0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0},
    {0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0},
    {0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0},
    {0, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1},
    {0, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 1},
    {0, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0},
    {0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0, 1, 1, 0},
    {0, 1, 1, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1},
    {0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1},
    {0, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0, 0, 0, 0, 1},
    {0, 0, 0, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1},
    {0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1},
    {0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0},
    {0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0},
    {0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1}};

const uint8_t kPart3[64][16] = {
    {0, 0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 1, 2, 2, 2, 2},
    {0, 0, 0, 1, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 2, 1},
    {0, 0, 0, 0, 2, 0, 0, 1, 2, 2, 1, 1, 2, 2, 1, 1},
    {0, 2, 2, 2, 0, 0, 2, 2, 0, 0, 1, 1, 0, 1, 1, 1},
    {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2},
    {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2, 0, 0, 2, 2},
    {0, 0, 2, 2, 0, 0, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1},
    {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2},
    {0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2},
    {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2},
    {0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2},
    {0, 1, 1, 2, 0, 1, 1, 2, 0, 1, 1, 2, 0, 1, 1, 2},
    {0, 1, 2, 2, 0, 1, 2, 2, 0, 1, 2, 2, 0, 1, 2, 2},
    {0, 0, 1, 1, 0, 1, 1, 2, 1, 1, 2, 2, 1, 2, 2, 2},
    {0, 0, 1, 1, 2, 0, 0, 1, 2, 2, 0, 0, 2, 2, 2, 0},
    {0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 2, 1, 1, 2, 2},
    {0, 1, 1, 1, 0, 0, 1, 1, 2, 0, 0, 1, 2, 2, 0, 0},
    {0, 0, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1, 2, 2},
    {0, 0, 2, 2, 0, 0, 2, 2, 0, 0, 2, 2, 1, 1, 1, 1},
    {0, 1, 1, 1, 0, 1, 1, 1, 0, 2, 2, 2, 0, 2, 2, 2},
    {0, 0, 0, 1, 0, 0, 0, 1, 2, 2, 2, 1, 2, 2, 2, 1},
    {0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 2, 2, 0, 1, 2, 2},
    {0, 0, 0, 0, 1, 1, 0, 0, 2, 2, 1, 0, 2, 2, 1, 0},
    {0, 1, 2, 2, 0, 1, 2, 2, 0, 0, 1, 1, 0, 0, 0, 0},
    {0, 0, 1, 2, 0, 0, 1, 2, 1, 1, 2, 2, 2, 2, 2, 2},
    {0, 1, 1, 0, 1, 2, 2, 1, 1, 2, 2, 1, 0, 1, 1, 0},
    {0, 0, 0, 0, 0, 1, 1, 0, 1, 2, 2, 1, 1, 2, 2, 1},
    {0, 0, 2, 2, 1, 1, 0, 2, 1, 1, 0, 2, 0, 0, 2, 2},
    {0, 1, 1, 0, 0, 1, 1, 0, 2, 0, 0, 2, 2, 2, 2, 2},
    {0, 0, 1, 1, 0, 1, 2, 2, 0, 1, 2, 2, 0, 0, 1, 1},
    {0, 0, 0, 0, 2, 0, 0, 0, 2, 2, 1, 1, 2, 2, 2, 1},
    {0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 2, 2, 2},
    {0, 2, 2, 2, 0, 0, 2, 2, 0, 0, 1, 2, 0, 0, 1, 1},
    {0, 0, 1, 1, 0, 0, 1, 2, 0, 0, 2, 2, 0, 2, 2, 2},
    {0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0},
    {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 0, 0, 0, 0},
    {0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0},
    {0, 1, 2, 0, 2, 0, 1, 2, 1, 2, 0, 1, 0, 1, 2, 0},
    {0, 0, 1, 1, 2, 2, 0, 0, 1, 1, 2, 2, 0, 0, 1, 1},
    {0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 0, 0, 0, 0, 1, 1},
    {0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2},
    {0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 2, 1, 2, 1, 2, 1},
    {0, 0, 2, 2, 1, 1, 2, 2, 0, 0, 2, 2, 1, 1, 2, 2},
    {0, 0, 2, 2, 0, 0, 1, 1, 0, 0, 2, 2, 0, 0, 1, 1},
    {0, 2, 2, 0, 1, 2, 2, 1, 0, 2, 2, 0, 1, 2, 2, 1},
    {0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 0, 1, 0, 1},
    {0, 0, 0, 0, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1},
    {0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2},
    {0, 2, 2, 2, 0, 1, 1, 1, 0, 2, 2, 2, 0, 1, 1, 1},
    {0, 0, 0, 2, 1, 1, 1, 2, 0, 0, 0, 2, 1, 1, 1, 2},
    {0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1, 2},
    {0, 2, 2, 2, 0, 1, 1, 1, 0, 1, 1, 1, 0, 2, 2, 2},
    {0, 0, 0, 2, 1, 1, 1, 2, 1, 1, 1, 2, 0, 0, 0, 2},
    {0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 2, 2},
    {0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 1, 2},
    {0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 2, 2, 2, 2, 2, 2},
    {0, 0, 2, 2, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2},
    {0, 0, 2, 2, 1, 1, 2, 2, 1, 1, 2, 2, 0, 0, 2, 2},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2},
    {0, 0, 0, 2, 0, 0, 0, 1, 0, 0, 0, 2, 0, 0, 0, 1},
    {0, 2, 2, 2, 1, 2, 2, 2, 0, 2, 2, 2, 1, 2, 2, 2},
    {0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2},
    {0, 1, 1, 1, 2, 0, 1, 1, 2, 2, 0, 1, 2, 2, 2, 0}};

// The anchor pixel of subset 1 of 2, and of subsets 1 and 2 of 3.
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
    15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
    6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kAnchor3a[64] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
    3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
    8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
    3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kAnchor3b[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
    15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
    15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
    15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

// Is pixel i an anchor (one index bit fewer) in its partition?
bool is_anchor(int ns, int part, int i) {
  if (i == 0) return true;
  if (ns == 2) return i == kAnchor2[part];
  if (ns == 3) return i == kAnchor3a[part] || i == kAnchor3b[part];
  return false;
}

int subset_of(int ns, int part, int i) {
  return ns == 1 ? 0 : (ns == 2 ? kPart2[part][i] : kPart3[part][i]);
}

// --- BC7 --------------------------------------------------------------------

struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

inline int bc7_expand(int v, int prec) {
  v <<= 8 - prec;
  return v | (v >> prec);
}

void decode_bc7(Rgba* col, const uint8_t* src) {
  int mode = 0;
  while (mode < 8 && !((src[0] >> mode) & 1)) mode++;
  if (mode == 8) {  // no mode bit: an invalid block
    std::memset(col, 0, 16 * sizeof(Rgba));
    return;
  }
  const Bc7Mode& m = kBc7[mode];
  Bits br{src, mode + 1};
  int part = br.get(m.pb);
  int rot = br.get(m.rb);
  int isb = br.get(m.isb);
  int ne = 2 * m.ns;
  int ep[6][4];
  for (int c = 0; c < 3; c++)
    for (int e = 0; e < ne; e++) ep[e][c] = br.get(m.cb);
  for (int e = 0; e < ne; e++) ep[e][3] = m.ab ? br.get(m.ab) : 255;
  int cprec = m.cb, aprec = m.ab;
  if (m.epb) {
    for (int e = 0; e < ne; e++) {
      int p = br.get(1);
      for (int c = 0; c < 3; c++) ep[e][c] = ep[e][c] << 1 | p;
      if (m.ab) ep[e][3] = ep[e][3] << 1 | p;
    }
    cprec++;
    if (m.ab) aprec++;
  } else if (m.spb) {
    for (int s = 0; s < m.ns; s++) {
      int p = br.get(1);
      for (int e = 2 * s; e < 2 * s + 2; e++)
        for (int c = 0; c < 3; c++) ep[e][c] = ep[e][c] << 1 | p;
    }
    cprec++;
  }
  for (int e = 0; e < ne; e++) {
    for (int c = 0; c < 3; c++) ep[e][c] = bc7_expand(ep[e][c], cprec);
    if (m.ab) ep[e][3] = bc7_expand(ep[e][3], aprec);
  }
  int idx[16], idx2[16];
  for (int i = 0; i < 16; i++)
    idx[i] = br.get(is_anchor(m.ns, part, i) ? m.ib - 1 : m.ib);
  if (m.ib2)
    for (int i = 0; i < 16; i++) idx2[i] = br.get(i == 0 ? m.ib2 - 1 : m.ib2);
  for (int i = 0; i < 16; i++) {
    int s = subset_of(m.ns, part, i);
    const int* e0 = ep[2 * s];
    const int* e1 = ep[2 * s + 1];
    int cw, aw;
    if (!m.ib2) {
      cw = weights(m.ib)[idx[i]];
      aw = cw;
    } else if (isb) {
      cw = weights(m.ib2)[idx2[i]];
      aw = weights(m.ib)[idx[i]];
    } else {
      cw = weights(m.ib)[idx[i]];
      aw = weights(m.ib2)[idx2[i]];
    }
    int v[4];
    for (int c = 0; c < 3; c++)
      v[c] = ((64 - cw) * e0[c] + cw * e1[c] + 32) >> 6;
    v[3] = ((64 - aw) * e0[3] + aw * e1[3] + 32) >> 6;
    if (rot) {
      int t = v[3];
      v[3] = v[rot - 1];
      v[rot - 1] = t;
    }
    col[i] = {uint8_t(v[0]), uint8_t(v[1]), uint8_t(v[2]), uint8_t(v[3])};
  }
}

// --- BC6H -------------------------------------------------------------------

// One field of a mode's header: ``count`` bits of endpoint value ``field``
// (0-11: r0 g0 b0 r1 g1 b1 r2 g2 b2 r3 g3 b3; 12 the partition), from bit
// ``lo`` upward, or downward from ``lo`` when ``rev``.
struct Field {
  int8_t field, lo, count, rev;
};

struct Bc6Mode {
  int8_t ns, tr, epb, db[3];
  Field f[24];
};

enum { RW, GW, BW, RX, GX, BX, RY, GY, BY, RZ, GZ, BZ, PART, END };

// The D3D11 header layouts, in bit order after the mode bits.
const Bc6Mode kBc6[14] = {
    // mode 1 (00)
    {2, 1, 10, {5, 5, 5},
     {{GY, 4, 1, 0}, {BY, 4, 1, 0}, {BZ, 4, 1, 0}, {RW, 0, 10, 0},
      {GW, 0, 10, 0}, {BW, 0, 10, 0}, {RX, 0, 5, 0}, {GZ, 4, 1, 0},
      {GY, 0, 4, 0}, {GX, 0, 5, 0}, {BZ, 0, 1, 0}, {GZ, 0, 4, 0},
      {BX, 0, 5, 0}, {BZ, 1, 1, 0}, {BY, 0, 4, 0}, {RY, 0, 5, 0},
      {BZ, 2, 1, 0}, {RZ, 0, 5, 0}, {BZ, 3, 1, 0}, {PART, 0, 5, 0},
      {END, 0, 0, 0}}},
    // mode 2 (01)
    {2, 1, 7, {6, 6, 6},
     {{GY, 5, 1, 0}, {GZ, 4, 2, 0}, {RW, 0, 7, 0}, {BZ, 0, 2, 0},
      {BY, 4, 1, 0}, {GW, 0, 7, 0}, {BY, 5, 1, 0}, {BZ, 2, 1, 0},
      {GY, 4, 1, 0}, {BW, 0, 7, 0}, {BZ, 3, 1, 0}, {BZ, 5, 1, 0},
      {BZ, 4, 1, 0}, {RX, 0, 6, 0}, {GY, 0, 4, 0}, {GX, 0, 6, 0},
      {GZ, 0, 4, 0}, {BX, 0, 6, 0}, {BY, 0, 4, 0}, {RY, 0, 6, 0},
      {RZ, 0, 6, 0}, {PART, 0, 5, 0}, {END, 0, 0, 0}}},
    // mode 3 (00010)
    {2, 1, 11, {5, 4, 4},
     {{RW, 0, 10, 0}, {GW, 0, 10, 0}, {BW, 0, 10, 0}, {RX, 0, 5, 0},
      {RW, 10, 1, 0}, {GY, 0, 4, 0}, {GX, 0, 4, 0}, {GW, 10, 1, 0},
      {BZ, 0, 1, 0}, {GZ, 0, 4, 0}, {BX, 0, 4, 0}, {BW, 10, 1, 0},
      {BZ, 1, 1, 0}, {BY, 0, 4, 0}, {RY, 0, 5, 0}, {BZ, 2, 1, 0},
      {RZ, 0, 5, 0}, {BZ, 3, 1, 0}, {PART, 0, 5, 0}, {END, 0, 0, 0}}},
    // mode 4 (00110)
    {2, 1, 11, {4, 5, 4},
     {{RW, 0, 10, 0}, {GW, 0, 10, 0}, {BW, 0, 10, 0}, {RX, 0, 4, 0},
      {RW, 10, 1, 0}, {GZ, 4, 1, 0}, {GY, 0, 4, 0}, {GX, 0, 5, 0},
      {GW, 10, 1, 0}, {GZ, 0, 4, 0}, {BX, 0, 4, 0}, {BW, 10, 1, 0},
      {BZ, 1, 1, 0}, {BY, 0, 4, 0}, {RY, 0, 4, 0}, {BZ, 0, 1, 0},
      {BZ, 2, 1, 0}, {RZ, 0, 4, 0}, {GY, 4, 1, 0}, {BZ, 3, 1, 0},
      {PART, 0, 5, 0}, {END, 0, 0, 0}}},
    // mode 5 (01010)
    {2, 1, 11, {4, 4, 5},
     {{RW, 0, 10, 0}, {GW, 0, 10, 0}, {BW, 0, 10, 0}, {RX, 0, 4, 0},
      {RW, 10, 1, 0}, {BY, 4, 1, 0}, {GY, 0, 4, 0}, {GX, 0, 4, 0},
      {GW, 10, 1, 0}, {BZ, 0, 1, 0}, {GZ, 0, 4, 0}, {BX, 0, 5, 0},
      {BW, 10, 1, 0}, {BY, 0, 4, 0}, {RY, 0, 4, 0}, {BZ, 1, 2, 0},
      {RZ, 0, 4, 0}, {BZ, 4, 1, 0}, {BZ, 3, 1, 0}, {PART, 0, 5, 0},
      {END, 0, 0, 0}}},
    // mode 6 (01110)
    {2, 1, 9, {5, 5, 5},
     {{RW, 0, 9, 0}, {BY, 4, 1, 0}, {GW, 0, 9, 0}, {GY, 4, 1, 0},
      {BW, 0, 9, 0}, {BZ, 4, 1, 0}, {RX, 0, 5, 0}, {GZ, 4, 1, 0},
      {GY, 0, 4, 0}, {GX, 0, 5, 0}, {BZ, 0, 1, 0}, {GZ, 0, 4, 0},
      {BX, 0, 5, 0}, {BZ, 1, 1, 0}, {BY, 0, 4, 0}, {RY, 0, 5, 0},
      {BZ, 2, 1, 0}, {RZ, 0, 5, 0}, {BZ, 3, 1, 0}, {PART, 0, 5, 0},
      {END, 0, 0, 0}}},
    // mode 7 (10010)
    {2, 1, 8, {6, 5, 5},
     {{RW, 0, 8, 0}, {GZ, 4, 1, 0}, {BY, 4, 1, 0}, {GW, 0, 8, 0},
      {BZ, 2, 1, 0}, {GY, 4, 1, 0}, {BW, 0, 8, 0}, {BZ, 3, 2, 0},
      {RX, 0, 6, 0}, {GY, 0, 4, 0}, {GX, 0, 5, 0}, {BZ, 0, 1, 0},
      {GZ, 0, 4, 0}, {BX, 0, 5, 0}, {BZ, 1, 1, 0}, {BY, 0, 4, 0},
      {RY, 0, 6, 0}, {RZ, 0, 6, 0}, {PART, 0, 5, 0}, {END, 0, 0, 0}}},
    // mode 8 (10110)
    {2, 1, 8, {5, 6, 5},
     {{RW, 0, 8, 0}, {BZ, 0, 1, 0}, {BY, 4, 1, 0}, {GW, 0, 8, 0},
      {GY, 5, 1, 0}, {GY, 4, 1, 0}, {BW, 0, 8, 0}, {GZ, 5, 1, 0},
      {BZ, 4, 1, 0}, {RX, 0, 5, 0}, {GZ, 4, 1, 0}, {GY, 0, 4, 0},
      {GX, 0, 6, 0}, {GZ, 0, 4, 0}, {BX, 0, 5, 0}, {BZ, 1, 1, 0},
      {BY, 0, 4, 0}, {RY, 0, 5, 0}, {BZ, 2, 1, 0}, {RZ, 0, 5, 0},
      {BZ, 3, 1, 0}, {PART, 0, 5, 0}, {END, 0, 0, 0}}},
    // mode 9 (11010)
    {2, 1, 8, {5, 5, 6},
     {{RW, 0, 8, 0}, {BZ, 1, 1, 0}, {BY, 4, 1, 0}, {GW, 0, 8, 0},
      {BY, 5, 1, 0}, {GY, 4, 1, 0}, {BW, 0, 8, 0}, {BZ, 5, 1, 0},
      {BZ, 4, 1, 0}, {RX, 0, 5, 0}, {GZ, 4, 1, 0}, {GY, 0, 4, 0},
      {GX, 0, 5, 0}, {BZ, 0, 1, 0}, {GZ, 0, 4, 0}, {BX, 0, 6, 0},
      {BY, 0, 4, 0}, {RY, 0, 5, 0}, {BZ, 2, 1, 0}, {RZ, 0, 5, 0},
      {BZ, 3, 1, 0}, {PART, 0, 5, 0}, {END, 0, 0, 0}}},
    // mode 10 (11110)
    {2, 0, 6, {6, 6, 6},
     {{RW, 0, 6, 0}, {GZ, 4, 1, 0}, {BZ, 0, 2, 0}, {BY, 4, 1, 0},
      {GW, 0, 6, 0}, {GY, 5, 1, 0}, {BY, 5, 1, 0}, {BZ, 2, 1, 0},
      {GY, 4, 1, 0}, {BW, 0, 6, 0}, {GZ, 5, 1, 0}, {BZ, 3, 1, 0},
      {BZ, 5, 1, 0}, {BZ, 4, 1, 0}, {RX, 0, 6, 0}, {GY, 0, 4, 0},
      {GX, 0, 6, 0}, {GZ, 0, 4, 0}, {BX, 0, 6, 0}, {BY, 0, 4, 0},
      {RY, 0, 6, 0}, {RZ, 0, 6, 0}, {PART, 0, 5, 0}, {END, 0, 0, 0}}},
    // mode 11 (00011)
    {1, 0, 10, {10, 10, 10},
     {{RW, 0, 10, 0}, {GW, 0, 10, 0}, {BW, 0, 10, 0}, {RX, 0, 10, 0},
      {GX, 0, 10, 0}, {BX, 0, 10, 0}, {END, 0, 0, 0}}},
    // mode 12 (00111)
    {1, 1, 11, {9, 9, 9},
     {{RW, 0, 10, 0}, {GW, 0, 10, 0}, {BW, 0, 10, 0}, {RX, 0, 9, 0},
      {RW, 10, 1, 0}, {GX, 0, 9, 0}, {GW, 10, 1, 0}, {BX, 0, 9, 0},
      {BW, 10, 1, 0}, {END, 0, 0, 0}}},
    // mode 13 (01011)
    {1, 1, 12, {8, 8, 8},
     {{RW, 0, 10, 0}, {GW, 0, 10, 0}, {BW, 0, 10, 0}, {RX, 0, 8, 0},
      {RW, 11, 2, 1}, {GX, 0, 8, 0}, {GW, 11, 2, 1}, {BX, 0, 8, 0},
      {BW, 11, 2, 1}, {END, 0, 0, 0}}},
    // mode 14 (01111)
    {1, 1, 16, {4, 4, 4},
     {{RW, 0, 10, 0}, {GW, 0, 10, 0}, {BW, 0, 10, 0}, {RX, 0, 4, 0},
      {RW, 15, 6, 1}, {GX, 0, 4, 0}, {GW, 15, 6, 1}, {BX, 0, 4, 0},
      {BW, 15, 6, 1}, {END, 0, 0, 0}}}};

inline int sign_extend(int v, int bits) {
  int s = 1 << (bits - 1);
  v &= (1 << bits) - 1;
  return (v ^ s) - s;
}

int bc6_unquantize(int v, int prec, bool sign) {
  if (!sign) {
    if (prec >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << prec) - 1) return 0xffff;
    return ((v << 15) + 0x4000) >> (prec - 1);
  }
  if (prec >= 16) return v;
  bool neg = v < 0;
  if (neg) v = -v;
  if (v != 0) {
    if (v >= (1 << (prec - 1)) - 1)
      v = 0x7fff;
    else
      v = ((v << 15) + 0x4000) >> (prec - 1);
  }
  return neg ? -v : v;
}

// A half float widened to float (exact below the largest finite half).
float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = uint32_t(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= uint32_t(h & 0x8000) << 16;
  return o.f;
}

float bc6_finalize(int v, bool sign) {
  if (sign) {
    if (v < 0) return half_to_float(uint16_t(0x8000 | ((-v) * 31) / 32));
    return half_to_float(uint16_t((v * 31) / 32));
  }
  return half_to_float(uint16_t((v * 31) / 64));
}

uint8_t bc6_clamp(float v) {
  if (v < 0.0f) return 0;
  if (v > 1.0f) return 255;
  return uint8_t(v * 255.0f);
}

void decode_bc6(Rgba* col, const uint8_t* src, bool sign) {
  int mode = src[0] & 3;
  int mi;
  Bits br{src, 2};
  if (mode < 2) {
    mi = mode;
  } else {
    mode = src[0] & 31;
    br.pos = 5;
    static const int8_t kIdx[32] = {
        -1, -1, 2,  10, -1, -1, 3,  11, -1, -1, 4,  12, -1, -1, 5,  13,
        -1, -1, 6,  -1, -1, -1, 7,  -1, -1, -1, 8,  -1, -1, -1, 9,  -1};
    mi = kIdx[mode];
    if (mi < 0) {  // a reserved mode
      std::memset(col, 0, 16 * sizeof(Rgba));
      for (int i = 0; i < 16; i++) col[i].a = 0xff;
      return;
    }
  }
  const Bc6Mode& m = kBc6[mi];
  int e[12] = {0}, part = 0;
  for (const Field* f = m.f; f->field != END; f++) {
    for (int k = 0; k < f->count; k++) {
      int bit = br.get(1);
      int b = f->rev ? f->lo - k : f->lo + k;
      if (f->field == PART)
        part |= bit << b;
      else
        e[f->field] |= bit << b;
    }
  }
  int ne = m.ns == 2 ? 12 : 6;
  if (sign) {
    for (int c = 0; c < 3; c++) e[c] = sign_extend(e[c], m.epb);
  }
  if (m.tr || sign) {
    for (int i = 3; i < ne; i++) {
      int bits = m.tr ? m.db[i % 3] : m.epb;
      e[i] = sign_extend(e[i], bits);
    }
  }
  if (m.tr) {
    // Pillow masks a transformed endpoint to its precision and, signed,
    // reads it as a 16-bit integer (not sign-extended from its precision).
    for (int i = 3; i < ne; i++) {
      e[i] = (e[i] + e[i % 3]) & ((1 << m.epb) - 1);
      if (sign) e[i] = int16_t(uint16_t(e[i]));
    }
  }
  for (int i = 0; i < ne; i++) e[i] = bc6_unquantize(e[i], m.epb, sign);
  int ib = m.ns == 2 ? 3 : 4;
  const uint8_t* w = weights(ib);
  for (int i = 0; i < 16; i++) {
    int idx = br.get(is_anchor(m.ns, part, i) ? ib - 1 : ib);
    int s = subset_of(m.ns, part, i);
    const int* e0 = e + 6 * s;
    const int* e1 = e0 + 3;
    int t = 64 - w[idx], u = w[idx];
    uint8_t v[3];
    for (int c = 0; c < 3; c++)
      v[c] = bc6_clamp(bc6_finalize((e0[c] * t + e1[c] * u) >> 6, sign));
    col[i] = {v[0], v[1], v[2], 0xff};
  }
}

// --- GIF's LZW (Pillow's GifDecode.c) ---------------------------------------
//
// The image data from its first sub-block's size byte to the end of the
// file: a size byte of 0 is an empty block, not the end (as in Pillow), and
// a block is read only once all of it is there. Clear codes right after a
// clear are ignored; a code past the table's next entry is an error; the
// table stops growing at 4,096 entries. Pixels go to the frame's rows in
// order, or in GIF's four interlace passes.

struct GifOut {
  uint8_t* frame;
  int stride, x0, y0, w, h;
  int x = 0, y = 0, step = 1, pass = 0;  // pass 0: not interlaced
  // Returns false once the frame is full (Pillow's decoder is done there).
  bool put(uint8_t v) {
    frame[int64_t(y + y0) * stride + x0 + x] = v;
    if (++x < w) return true;
    x = 0;
    y += step;
    while (y >= h) {
      switch (pass) {
        case 1: y = 4; pass = 2; break;
        case 2: step = 4; y = 2; pass = 3; break;
        case 3: step = 2; y = 1; pass = 4; break;
        default: return false;
      }
    }
    return true;
  }
};

int gif_decode(const uint8_t* src, int64_t n, int bits, GifOut& out) {
  if (bits < 0 || bits > 12) return -2;
  if (out.w <= 0 || out.h <= 0) return 0;
  const int clear = 1 << bits, end = clear + 1;
  static thread_local uint8_t data[4096], buffer[4096];
  static thread_local uint16_t link[4096];
  int next = clear + 2, codesize = bits + 1, codemask = (1 << codesize) - 1;
  int state = 2, lastcode = 0, lastdata = 0;
  uint32_t bitbuffer = 0;
  int bitcount = 0, blocksize = 0;
  int64_t pos = 0;
  for (;;) {
    while (bitcount < codesize) {
      if (blocksize > 0) {
        bitbuffer |= uint32_t(src[pos++]) << bitcount;
        bitcount += 8;
        blocksize--;
      } else {
        if (pos >= n || n - pos < int64_t(src[pos]) + 1) return 1;  // short
        blocksize = src[pos++];
      }
    }
    int c = int(bitbuffer) & codemask;
    bitbuffer >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      if (state != 2) {
        next = clear + 2;
        codesize = bits + 1;
        codemask = (1 << codesize) - 1;
        state = 2;
      }
      continue;
    }
    if (c == end) return 1;  // the frame is not full: PIL reads on, and fails
    const uint8_t* p;
    int count;
    if (state == 2) {
      if (c > clear) return -1;
      lastdata = lastcode = c;
      state = 3;
      buffer[0] = uint8_t(c);
      p = buffer;
      count = 1;
    } else {
      int thiscode = c;
      if (c > next) return -1;
      int bi = 4096;
      if (c == next) {
        buffer[--bi] = uint8_t(lastdata);
        c = lastcode;
      }
      while (c >= clear) {
        if (bi <= 0 || c >= 4096) return -1;
        buffer[--bi] = data[c];
        c = link[c];
      }
      if (bi <= 0) return -1;
      buffer[--bi] = uint8_t(c);
      lastdata = c;
      if (next < 4096) {
        data[next] = uint8_t(c);
        link[next] = uint16_t(lastcode);
        if (next == codemask && codesize < 12) {
          codesize++;
          codemask = (1 << codesize) - 1;
        }
        next++;
      }
      lastcode = thiscode;
      p = buffer + bi;
      count = 4096 - bi;
    }
    for (int i = 0; i < count; i++)
      if (!out.put(p[i])) return 0;
  }
}

// --- TIFF's LZW (libtiff's LZWDecode) ---------------------------------------

int64_t tiff_lzw(const uint8_t* src, int64_t n, uint8_t* out, int64_t cap) {
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kSize = 4095 + 1024;
  struct Code {
    int next;  // -1: none
    uint16_t length;
    uint8_t value, firstchar;
  };
  std::vector<Code> tab(kSize);
  for (int c = 0; c < 256; c++) tab[c] = {-1, 1, uint8_t(c), uint8_t(c)};
  int nbits = 9, free_ent = kFirst, maxcode = (1 << 9) - 2;
  int old = -1;
  int64_t bitpos = 0, nbitsavail = n * 8, op = 0;
  auto next_code = [&]() -> int {
    if (nbitsavail - bitpos < nbits) return kEoi;  // not terminated: EOI
    int v = 0;
    for (int i = 0; i < nbits; i++, bitpos++)
      v = (v << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    return v;
  };
  auto reset = [&]() {
    for (int c = kFirst; c < kSize; c++) tab[c] = {-1, 0, 0, 0};
    nbits = 9;
    free_ent = kFirst;
    maxcode = (1 << 9) - 2;
  };
  reset();
  while (op < cap) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      reset();
      do {
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return -1;
      out[op++] = uint8_t(code);
      old = code;
      continue;
    }
    if (old < 0 || free_ent >= kSize) return -1;
    Code& f = tab[free_ent];
    f.next = old;
    f.firstchar = tab[old].firstchar;
    f.length = uint16_t(tab[old].length + 1);
    f.value = code < free_ent ? tab[code].firstchar : f.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > 12) nbits = 12;
      maxcode = (1 << nbits) - 2;
    }
    old = code;
    if (code >= 256) {
      int len = tab[code].length;
      if (len == 0) return -1;
      // Written back to front; a string past the end is cut at the end.
      int64_t end = op + len;
      int c = code;
      for (int64_t k = end - 1; k >= op; k--) {
        if (k < cap) out[k] = tab[c].value;
        c = tab[c].next;
        if (c < 0 && k > op) return -1;
      }
      op = end < cap ? end : cap;
    } else {
      out[op++] = uint8_t(code);
    }
  }
  return op;
}

// --- PackBits ---------------------------------------------------------------

// libtiff (``clip`` set) needs of a literal cut at the output's end only
// the bytes it copies; Pillow's decoder (PSD) waits for all of them.
int64_t packbits(const uint8_t* src, int64_t n, uint8_t* out, int64_t rows,
                 int64_t row_bytes, bool clip) {
  int64_t pos = 0;
  for (int64_t y = 0; y < rows; y++) {
    uint8_t* row = out + y * row_bytes;
    int64_t x = 0;
    while (x < row_bytes) {
      if (pos >= n) return -1;
      int h = src[pos];
      if (h & 0x80) {
        if (h == 0x80) {  // no-op
          pos++;
          continue;
        }
        if (n - pos < 2) return -1;
        for (int k = 257 - h; k > 0 && x < row_bytes; k--)
          row[x++] = src[pos + 1];
        pos += 2;
      } else {
        int64_t need = h + 1;
        if (clip && need > row_bytes - x) need = row_bytes - x;
        if (n - pos - 1 < need) return -1;
        for (int k = 1; k < h + 2 && x < row_bytes; k++)
          row[x++] = src[pos + k];
        pos += h + 2;
      }
    }
  }
  return pos;
}

// --- QOI ----------------------------------------------------------------------

// Pillow's QoiDecoder from byte ``pos`` on: npix pixels' RGB into out.
// Its index table is a dict that starts empty (a slot never written reads
// 0, 0, 0, 0), each decoded pixel enters it at its own hash (an index op's
// pixel too), a run does not. Returns 0, or -1 when the data ends inside
// an op (PIL's load fails).
int64_t qoi(const uint8_t* src, int64_t n, int64_t pos, uint8_t* out,
            int64_t npix) {
  uint8_t seen[64][4];
  std::memset(seen, 0, sizeof seen);
  uint8_t prev[4] = {0, 0, 0, 255};
  int64_t done = 0;
  while (done < npix) {
    if (pos >= n) return -1;
    int b = src[pos++];
    uint8_t v[4];
    if (b == 0xFE) {
      if (n - pos < 3) return -1;
      v[0] = src[pos];
      v[1] = src[pos + 1];
      v[2] = src[pos + 2];
      v[3] = prev[3];
      pos += 3;
    } else if (b == 0xFF) {
      if (n - pos < 4) return -1;
      std::memcpy(v, src + pos, 4);
      pos += 4;
    } else if ((b >> 6) == 0) {
      std::memcpy(v, seen[b & 63], 4);
    } else if ((b >> 6) == 1) {
      v[0] = uint8_t(prev[0] + ((b >> 4) & 3) - 2);
      v[1] = uint8_t(prev[1] + ((b >> 2) & 3) - 2);
      v[2] = uint8_t(prev[2] + (b & 3) - 2);
      v[3] = prev[3];
    } else if ((b >> 6) == 2) {
      if (pos >= n) return -1;
      int b2 = src[pos++];
      int dg = (b & 63) - 32;
      v[0] = uint8_t(prev[0] + dg + ((b2 >> 4) - 8));
      v[1] = uint8_t(prev[1] + dg);
      v[2] = uint8_t(prev[2] + dg + ((b2 & 15) - 8));
      v[3] = prev[3];
    } else {  // a run of the previous pixel, outside the table
      for (int k = (b & 63) + 1; k > 0 && done < npix; k--, done++)
        std::memcpy(out + 3 * done, prev, 3);
      continue;
    }
    std::memcpy(prev, v, 4);
    std::memcpy(seen[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64], v,
                4);
    std::memcpy(out + 3 * done, v, 3);
    done++;
  }
  return 0;
}

// --- SGI run-length rows ------------------------------------------------------

// One row's chunks into dest (every z-th byte, or byte pair at bpc 2):
// Pillow's expandrow / expandrow2. n counts chunks; end is the buffer's
// last byte. 0 the row ends, 1 its last chunk is not the terminator
// (Pillow stops decoding there, without an error), -1 an overrun.
int sgi_row(uint8_t* dest, const uint8_t* src, int n, int z, int xsize,
            const uint8_t* end, int bpc) {
  int x = 0;
  for (; n > 0; n--) {
    uint8_t pixel;
    if (bpc == 1) {
      if (src > end) return -1;
      pixel = *src++;
    } else {
      if (src + 1 > end) return -1;
      pixel = src[1];
      src += 2;
    }
    if (n == 1 && pixel != 0) return 1;
    int count = pixel & 0x7F;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + bpc * count > end) return -1;
      while (count--) {
        std::memcpy(dest, src, bpc);
        src += bpc;
        dest += z * bpc;
      }
    } else {
      if (src + bpc > end) return -1;
      while (count--) {
        std::memcpy(dest, src, bpc);
        dest += z * bpc;
      }
      src += bpc;
    }
  }
  return 0;
}

// The file's bytes after the 512-byte header (``n`` of them) -> out
// [ysize, xsize, bands * bpc], rows in the file's table order (row 0 is
// the image's bottom row). Returns 0, or -1 where Pillow sets an error.
// A row whose chunks stop short keeps the previous row's samples past
// them (one buffer for every row); rows after a non-terminating last
// chunk stay 0.
int64_t sgi_rle(const uint8_t* buf, int64_t n, int32_t xsize, int32_t ysize,
                int32_t bands, int32_t bpc, uint8_t* out) {
  int64_t tablen = int64_t(bands) * ysize;
  if (n < 8 * tablen) return -1;
  auto be32 = [](const uint8_t* p) {
    return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 |
           uint32_t(p[2]) << 8 | uint32_t(p[3]);
  };
  int64_t row_bytes = int64_t(xsize) * bands * bpc;
  std::vector<uint8_t> row(row_bytes, 0);
  const uint8_t* end = buf + n - 1;
  for (int64_t y = 0; y < ysize; y++) {
    for (int c = 0; c < bands; c++) {
      uint32_t start = be32(buf + 4 * (y + int64_t(c) * ysize));
      uint32_t len = be32(buf + 4 * (tablen + y + int64_t(c) * ysize));
      if (start < 512) return -1;
      start -= 512;
      int status = sgi_row(row.data() + c * bpc, buf + start, int32_t(len),
                           bands, xsize, end, bpc);
      if (status == -1) return -1;
      if (status == 1) return 0;
    }
    std::memcpy(out + y * row_bytes, row.data(), row_bytes);
  }
  return 0;
}

// --- PCX run-length lines -----------------------------------------------------

// Pillow's PcxDecode over the image data: ysize lines of ``bytes`` bytes
// (planes * stride) into out. A padded line's planes are moved together
// as Pillow moves them: 1-bit planes (raw mode P;2L and P;4L, ``bits`` 2
// and 4) to ceil(xsize / 8) bytes apart, byte planes to xsize apart where
// bytes / (bytes / xsize) exceeds xsize. Returns 0, -1 where a run crossed
// a line's end (Pillow finishes, then raises an overrun), or -2 when the
// data ends first.
int64_t pcx(const uint8_t* src, int64_t n, int32_t xsize, int32_t ysize,
            int32_t bytes, int32_t bits, uint8_t* out) {
  std::vector<uint8_t> line(bytes, 0);
  int64_t pos = 0;
  int x = 0;
  bool overrun = false;
  for (int y = 0; y < ysize;) {
    if (pos >= n) return -2;
    if ((src[pos] & 0xC0) == 0xC0) {
      if (n - pos < 2) return -2;
      for (int k = src[pos] & 0x3F; k > 0; k--) {
        if (x >= bytes) {
          overrun = true;
          break;
        }
        line[x++] = src[pos + 1];
      }
      pos += 2;
    } else {
      line[x++] = src[pos++];
    }
    if (x >= bytes) {
      int width, bands, stride = 0;
      if (bits == 2 || bits == 4) {
        width = (xsize + 7) / 8;
        bands = bits;
        stride = bytes / bits;
      } else {
        width = xsize;
        bands = bytes / xsize;
        if (bands) stride = bytes / bands;
      }
      if (stride > width)
        for (int i = 1; i < bands; i++)
          std::memmove(&line[i * width], &line[i * stride], width);
      std::memcpy(out + int64_t(y) * bytes, line.data(), bytes);
      x = 0;
      y++;
    }
  }
  return overrun ? -1 : 0;
}

}  // namespace

extern "C" {

// BCn blocks [ceil(h/4), ceil(w/4)] -> out [h, w, 3] RGB (BC4's grey in
// all three). fmt: 1-3 BC1-BC3, 4 BC4, 5 BC5, 6 BC5 signed, 7 BC6H
// unsigned, 8 BC6H signed, 9 BC7. Returns 0, or -1 when n is short.
int gpt_bcn_decode(const uint8_t* src, int64_t n, int32_t w, int32_t h,
                   int32_t fmt, uint8_t* out) {
  int bsize = (fmt == 1 || fmt == 4) ? 8 : 16;
  int64_t bw = (w + 3) / 4, bh = (h + 3) / 4;
  if (n < bw * bh * bsize) return -1;
  Rgba col[16];
  for (int64_t by = 0; by < bh; by++)
    for (int64_t bx = 0; bx < bw; bx++) {
      const uint8_t* b = src + (by * bw + bx) * bsize;
      std::memset(col, 0, sizeof col);
      switch (fmt) {
        case 1:
          decode_bc1_color(col, b, false);
          break;
        case 2:
          decode_bc1_color(col, b + 8, true);
          break;
        case 3:
          decode_bc1_color(col, b + 8, true);
          decode_bc3_alpha(&col[0].a, b, 4, false);
          break;
        case 4: {
          uint8_t l[16];
          decode_bc3_alpha(l, b, 1, false);
          for (int i = 0; i < 16; i++) col[i] = {l[i], l[i], l[i], 0xff};
          break;
        }
        case 5:
        case 6:
          decode_bc3_alpha(&col[0].r, b, 4, fmt == 6);
          decode_bc3_alpha(&col[0].g, b + 8, 4, fmt == 6);
          if (fmt == 6)  // signed: blue is the middle of the range
            for (int i = 0; i < 16; i++) col[i].b = 128;
          break;
        case 7:
        case 8:
          decode_bc6(col, b, fmt == 8);
          break;
        case 9:
          decode_bc7(col, b);
          break;
        default:
          return -2;
      }
      for (int j = 0; j < 4; j++) {
        int64_t y = by * 4 + j;
        if (y >= h) break;
        for (int i = 0; i < 4; i++) {
          int64_t x = bx * 4 + i;
          if (x >= w) break;
          uint8_t* o = out + (y * w + x) * 3;
          o[0] = col[4 * j + i].r;
          o[1] = col[4 * j + i].g;
          o[2] = col[4 * j + i].b;
        }
      }
    }
  return 0;
}

// GIF image data -> frame [., stride] at (x0, y0), w x h; 0 the frame
// filled, 1 the data ended first, -1 a corrupt code, -2 a bad code size.
int64_t gpt_gif_lzw(const uint8_t* src, int64_t n, int32_t bits,
                    uint8_t* frame, int32_t stride, int32_t x0, int32_t y0,
                    int32_t w, int32_t h, int32_t interlace) {
  GifOut out{frame, stride, x0, y0, w, h};
  if (interlace) {
    out.step = 8;
    out.pass = 1;
  }
  return gif_decode(src, n, bits, out);
}

// One TIFF LZW strip -> at most cap bytes; the count, or -1 (corrupt).
int64_t gpt_tiff_lzw(const uint8_t* src, int64_t n, uint8_t* out,
                     int64_t cap) {
  return tiff_lzw(src, n, out, cap);
}

// PackBits -> rows x row_bytes; the bytes consumed, or -1 (data short).
// clip: libtiff's reading of a literal past the output's end.
int64_t gpt_packbits(const uint8_t* src, int64_t n, uint8_t* out,
                     int64_t rows, int64_t row_bytes, int32_t clip) {
  return packbits(src, n, out, rows, row_bytes, clip != 0);
}

// QOI ops from pos -> npix RGB pixels; 0, or -1 (data short).
int64_t gpt_qoi(const uint8_t* src, int64_t n, int64_t pos, uint8_t* out,
                int64_t npix) {
  return qoi(src, n, pos, out, npix);
}

// SGI run-length data (the file after its header) -> [ysize, xsize,
// bands * bpc] in table row order; 0, or -1 (Pillow's overrun).
int64_t gpt_sgi_rle(const uint8_t* buf, int64_t n, int32_t xsize,
                    int32_t ysize, int32_t bands, int32_t bpc, uint8_t* out) {
  return sgi_rle(buf, n, xsize, ysize, bands, bpc, out);
}

// PCX run-length data -> ysize lines of ``bytes``, the planes moved as
// Pillow moves them for a raw mode of ``bits``; 0, -1 (overrun) or -2
// (data short).
int64_t gpt_pcx(const uint8_t* src, int64_t n, int32_t xsize, int32_t ysize,
                int32_t bytes, int32_t bits, uint8_t* out) {
  return pcx(src, n, xsize, ysize, bytes, bits, out);
}

}  // extern "C"
