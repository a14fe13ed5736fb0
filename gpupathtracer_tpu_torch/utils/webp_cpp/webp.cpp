// The bitstream decoders behind utils/webp.py, each giving bit for bit what
// libwebp (1.6.0, the library Pillow 12.1.0 reads WebP with) gives through
// WebPAnimDecoder in MODE_RGBA:
//
//   - VP8L, lossless: the four transforms (predictor with its 14 modes,
//     cross-colour, subtract-green, colour indexing with pixel bundling),
//     simple and normal prefix codes, the meta prefix codes, LZ77
//     backward references with the 120-entry distance map, the colour
//     cache; libwebp's bit reader and its table lookups are followed
//     exactly, so a stream that ends early fails, or reads the same
//     bits, where libwebp's does;
//   - VP8, lossy key frames (RFC 6386): the bool decoder, segmentation,
//     the normal and simple loop filters, 1-8 token partitions, the
//     intra modes, the inverse WHT and DCT; where libwebp runs SSE2 code
//     (the full 4x4 inverse DCT) its 16-bit arithmetic is reproduced, so
//     coefficients out of the encoder's range wrap as they wrap there;
//     then libwebp's "fancy" chroma upsampling and its fixed-point
//     YUV -> RGB;
//   - ALPH: raw or VP8L-compressed (a headerless VP8L image whose green
//     channel is the alpha), then the none / horizontal / vertical /
//     gradient unfilter. The pre-processing bit is read and ignored (no
//     alpha dithering, as WebPAnimDecoder leaves it off).
//
// Integer arithmetic only. C interface (ctypes): each decoder returns 0,
// or 1 with a message in err for data libwebp refuses.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Fail {
  const char* msg;
};

[[noreturn]] void fail(const char* msg) { throw Fail{msg}; }

// =========================================================================
// VP8L
// =========================================================================

// libwebp's VP8LBitReader: a 64-bit window, refilled a byte at a time.
// Past the end it reads zero bits (and, once bit_pos passes 64, the
// window's bits again), and flags the end once more bits were taken than
// the stream holds (or 64, for a stream under 8 bytes).
struct LBits {
  uint64_t val = 0;
  const uint8_t* buf;
  size_t len, pos;
  int bit_pos = 0;
  bool eos = false;

  LBits(const uint8_t* d, size_t n) : buf(d), len(n) {
    size_t k = n < 8 ? n : 8;
    for (size_t i = 0; i < k; ++i) val |= uint64_t(d[i]) << (8 * i);
    pos = k;
  }
  bool at_end() const { return eos || (pos == len && bit_pos > 64); }
  void set_end() {
    eos = true;
    bit_pos = 0;
  }
  void shift() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= uint64_t(buf[pos++]) << 56;
      bit_pos -= 8;
    }
    if (at_end()) set_end();
  }
  uint32_t peek() const { return uint32_t(val >> (bit_pos & 63)); }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      uint32_t v = peek() & ((1u << n) - 1);
      bit_pos += n;
      shift();
      return v;
    }
    set_end();
    return 0;
  }
  void fill() {
    if (bit_pos >= 32) shift();
  }
};

// A prefix code as libwebp tabulates it: an 8-bit root table whose long
// codes point to second-level tables (a code's bits past the root are
// looked up in a second read of the window).
struct HCode {
  uint8_t bits;
  uint16_t value;
};
using Table = std::vector<HCode>;

uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

void replicate(HCode* t, int step, int end, HCode code) {
  do {
    end -= step;
    t[end] = code;
  } while (end > 0);
}

int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < 15) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// libwebp's BuildHuffmanTable: false for what it refuses (no symbol, a
// length past 15, an over-subscribed or incomplete code); one symbol
// makes a code of 0 bits.
bool build_table(Table& t, int root_bits, const int* lengths, int n) {
  int count[16] = {0}, offset[16];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > 15) return false;
    ++count[lengths[s]];
  }
  if (count[0] == n) return false;
  offset[1] = 0;
  for (int len = 1; len < 15; ++len) {
    if (count[len] > (1 << len)) return false;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(n);
  for (int s = 0; s < n; ++s)
    if (lengths[s] > 0) sorted[offset[lengths[s]]++] = uint16_t(s);
  int total = 1 << root_bits;
  if (offset[15] == 1) {
    t.assign(total, HCode{0, sorted[0]});
    return true;
  }
  t.assign(total, HCode{0, 0});
  int table = 0, table_bits = root_bits, table_size = total;
  uint32_t low = 0xffffffffu, mask = uint32_t(total - 1), key = 0;
  int num_nodes = 1, num_open = 1, sym = 0, len, step;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return false;
    for (; count[len] > 0; --count[len]) {
      replicate(&t[key], step, table_size,
                HCode{uint8_t(len), sorted[sym++]});
      key = next_key(key, len);
    }
  }
  for (len = root_bits + 1, step = 2; len <= 15; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return false;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        table += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        total += table_size;
        t.resize(total, HCode{0, 0});
        low = key & mask;
        t[low] = HCode{uint8_t(table_bits + root_bits),
                       uint16_t(table - int(low))};
      }
      replicate(&t[table + (key >> root_bits)], step, table_size,
                HCode{uint8_t(len - root_bits), sorted[sym++]});
      key = next_key(key, len);
    }
  }
  return num_nodes == 2 * offset[15] - 1;
}

// libwebp's ReadSymbol (no refill: the caller refills as libwebp does).
inline int read_symbol(const Table& t, LBits& br) {
  uint32_t val = br.peek();
  int i = int(val & 0xff);
  int nbits = t[i].bits - 8;
  if (nbits > 0) {
    br.bit_pos += 8;
    val = br.peek();
    i += t[i].value;
    i += int(val & ((1u << nbits) - 1));
  }
  br.bit_pos += t[i].bits;
  return t[i].value;
}

const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
const uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};

bool read_code_lengths(LBits& br, const int* cl, int num_symbols,
                       int* lengths) {
  Table table;
  if (!build_table(table, 7, cl, 19)) return false;
  int max_symbol = num_symbols;
  if (br.read(1)) {
    int nbits = 2 + 2 * int(br.read(3));
    max_symbol = 2 + int(br.read(nbits));
    if (max_symbol > num_symbols) return false;
  }
  int prev = 8, symbol = 0;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    br.fill();
    const HCode& p = table[br.peek() & 127];
    br.bit_pos += p.bits;
    int code_len = p.value;
    if (code_len < 16) {
      lengths[symbol++] = code_len;
      if (code_len) prev = code_len;
    } else {
      static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
      int slot = code_len - 16;
      int repeat = int(br.read(kExtra[slot])) + kOffset[slot];
      if (symbol + repeat > num_symbols) return false;
      int l = code_len == 16 ? prev : 0;
      while (repeat-- > 0) lengths[symbol++] = l;
    }
  }
  return true;
}

// One prefix code of the stream (libwebp's ReadHuffmanCode); lengths
// holds at least 280 entries.
bool read_code(LBits& br, int alphabet, std::vector<int>& lengths,
               Table& table) {
  std::fill(lengths.begin(), lengths.begin() + alphabet, 0);
  bool ok;
  if (br.read(1)) {  // simple code: one or two symbols
    int num = int(br.read(1)) + 1;
    int first_bits = br.read(1) ? 8 : 1;
    lengths[br.read(first_bits)] = 1;
    if (num == 2) lengths[br.read(8)] = 1;
    ok = true;
  } else {
    int cl[19] = {0};
    int num = int(br.read(4)) + 4;
    for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = int(br.read(3));
    ok = read_code_lengths(br, cl, alphabet, lengths.data());
  }
  ok = ok && !br.eos;
  return ok && build_table(table, 8, lengths.data(), alphabet);
}

struct Group {
  Table t[5];  // green (+ lengths + cache), red, blue, alpha, distance
  bool trivial_literal = false, trivial_code = false;
  uint32_t literal_arb = 0;
};

// An image's entropy coding: the colour cache, the meta prefix codes.
struct Codes {
  int cache_bits = 0;
  int huff_bits = 0, huff_xsize = 0;
  std::vector<uint32_t> huff_image;  // group per tile, remapped
  std::vector<Group> groups;

  const Group& at(int x, int y) const {
    if (huff_bits == 0) return groups[0];
    return groups[huff_image[size_t(huff_xsize) * (y >> huff_bits) +
                             (x >> huff_bits)]];
  }
};

struct Transform {
  int type, bits = 0, xsize, ysize;
  std::vector<uint32_t> data;
};

enum {
  PREDICTOR = 0,
  CROSS_COLOR = 1,
  SUBTRACT_GREEN = 2,
  COLOR_INDEXING = 3
};

inline int subsample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

struct LDec {
  LBits br;
  int seen = 0;
  std::vector<Transform> transforms;
  explicit LDec(const uint8_t* d, size_t n) : br(d, n) {
    transforms.reserve(4);
  }
};

bool decode_stream(LDec& d, int xsize, int ysize, bool level0,
                   std::vector<uint32_t>* data, Codes* level0_codes,
                   int* level0_xsize);

bool read_codes(LDec& d, int xsize, int ysize, int cache_bits,
                bool allow_recursion, Codes& c) {
  LBits& br = d.br;
  int num_max = 1;
  if (allow_recursion && br.read(1)) {
    c.huff_bits = 2 + int(br.read(3));
    c.huff_xsize = subsample(xsize, c.huff_bits);
    if (!decode_stream(d, c.huff_xsize, subsample(ysize, c.huff_bits), false,
                       &c.huff_image, nullptr, nullptr))
      return false;
    for (auto& v : c.huff_image) {
      v = (v >> 8) & 0xffff;
      num_max = std::max(num_max, int(v) + 1);
    }
  }
  if (br.eos) return false;
  // Every group up to the largest index is read and checked; only the
  // ones the meta image uses are kept (libwebp's mapping).
  std::vector<int> mapping(num_max, -1);
  int used = 0;
  if (c.huff_bits == 0) {
    mapping[0] = used++;
  } else {
    for (auto& v : c.huff_image) {
      if (mapping[v] < 0) mapping[v] = used++;
      v = uint32_t(mapping[v]);
    }
  }
  c.groups.assign(used, Group());
  int max_alphabet = kAlphabet[0] + (cache_bits ? 1 << cache_bits : 0);
  std::vector<int> lengths(std::max(max_alphabet, 280), 0);
  Table scratch;
  for (int i = 0; i < num_max; ++i) {
    Group* g = mapping[i] >= 0 ? &c.groups[mapping[i]] : nullptr;
    for (int j = 0; j < 5; ++j) {
      int alphabet = kAlphabet[j];
      if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
      if (!read_code(br, alphabet, lengths, g ? g->t[j] : scratch))
        return false;
    }
    if (g) {
      g->trivial_literal = g->t[1][0].bits == 0 && g->t[2][0].bits == 0 &&
                           g->t[3][0].bits == 0;
      int total = 0;
      for (int j = 0; j < 5; ++j) total += g->t[j][0].bits;
      if (g->trivial_literal) {
        g->literal_arb = uint32_t(g->t[3][0].value) << 24 |
                         uint32_t(g->t[1][0].value) << 16 | g->t[2][0].value;
        if (total == 0 && g->t[0][0].value < 256) {
          g->trivial_code = true;
          g->literal_arb |= uint32_t(g->t[0][0].value) << 8;
        }
      }
    }
  }
  return true;
}

inline int copy_distance(int symbol, LBits& br) {
  if (symbol < 4) return symbol + 1;
  int extra = (symbol - 2) >> 1;
  int offset = (2 + (symbol & 1)) << extra;
  return offset + int(br.read(extra)) + 1;
}

// The distance map's (dy << 4) | (8 - dx) for the 120 short codes.
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

inline int plane_to_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  int dist_code = kCodeToPlane[code - 1];
  int dist = (dist_code >> 4) * xsize + (8 - (dist_code & 0xf));
  return dist >= 1 ? dist : 1;
}

// libwebp's DecodeImageData: ARGB pixels, false where it fails (the end
// of the stream passed included).
bool decode_pixels(LDec& d, const Codes& c, uint32_t* data, int width,
                   int height) {
  LBits& br = d.br;
  uint32_t* src = data;
  uint32_t* last_cached = src;
  uint32_t* const end = data + size_t(width) * height;
  int row = 0, col = 0;
  const int len_limit = 256 + 24;
  const int cache_limit = len_limit + (c.cache_bits ? 1 << c.cache_bits : 0);
  std::vector<uint32_t> cache(c.cache_bits ? size_t(1) << c.cache_bits : 0);
  const int cache_shift = 32 - c.cache_bits;
  auto insert = [&](uint32_t argb) {
    cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
  };
  const int mask = c.huff_bits ? (1 << c.huff_bits) - 1 : ~0;
  const Group* g = src < end ? &c.at(col, row) : nullptr;
  while (src < end) {
    if ((col & mask) == 0) g = &c.at(col, row);
    bool literal = false;
    if (g->trivial_code) {
      *src = g->literal_arb;
      literal = true;
    } else {
      br.fill();
      int code = read_symbol(g->t[0], br);
      if (br.at_end()) break;
      if (code < 256) {
        if (g->trivial_literal) {
          *src = g->literal_arb | uint32_t(code) << 8;
        } else {
          int red = read_symbol(g->t[1], br);
          br.fill();
          int blue = read_symbol(g->t[2], br);
          int alpha = read_symbol(g->t[3], br);
          if (br.at_end()) break;
          *src = uint32_t(alpha) << 24 | uint32_t(red) << 16 |
                 uint32_t(code) << 8 | uint32_t(blue);
        }
        literal = true;
      } else if (code < len_limit) {
        int length = copy_distance(code - 256, br);
        int dist_symbol = read_symbol(g->t[4], br);
        br.fill();
        int dist = plane_to_distance(width, copy_distance(dist_symbol, br));
        if (br.at_end()) break;
        if (src - data < std::ptrdiff_t(dist) ||
            end - src < std::ptrdiff_t(length))
          return false;
        for (int i = 0; i < length; ++i) src[i] = src[i - dist];
        src += length;
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
        if (col & mask) g = &c.at(col, row);
        if (!cache.empty())
          while (last_cached < src) insert(*last_cached++);
      } else if (code < cache_limit) {
        while (last_cached < src) insert(*last_cached++);
        *src = cache[code - len_limit];
        literal = true;
      } else {
        return false;
      }
    }
    if (literal) {
      ++src;
      if (++col >= width) {
        col = 0;
        ++row;
        if (!cache.empty())
          while (last_cached < src) insert(*last_cached++);
      }
    }
  }
  br.eos = br.at_end();
  return !br.eos;
}

// libwebp's ExpandColorMap: the palette's deltas summed bytewise, the
// entries past it transparent black.
void expand_color_map(int num_colors, Transform& t) {
  int final_num = 1 << (8 >> t.bits);
  std::vector<uint32_t> out(final_num, 0);
  auto* nd = reinterpret_cast<uint8_t*>(out.data());
  const auto* od = reinterpret_cast<const uint8_t*>(t.data.data());
  out[0] = t.data[0];
  for (int i = 4; i < 4 * num_colors; ++i)
    nd[i] = uint8_t(od[i] + nd[i - 4]);
  t.data.swap(out);
}

bool read_transform(LDec& d, int* xsize, int* ysize) {
  LBits& br = d.br;
  int type = int(br.read(2));
  if (d.seen & (1 << type)) return false;
  d.seen |= 1 << type;
  d.transforms.push_back(Transform());
  Transform& t = d.transforms.back();
  t.type = type;
  t.xsize = *xsize;
  t.ysize = *ysize;
  switch (type) {
    case PREDICTOR:
    case CROSS_COLOR:
      t.bits = int(br.read(3)) + 2;
      return decode_stream(d, subsample(t.xsize, t.bits),
                           subsample(t.ysize, t.bits), false, &t.data,
                           nullptr, nullptr);
    case COLOR_INDEXING: {
      int num = int(br.read(8)) + 1;
      t.bits = num > 16 ? 0 : num > 4 ? 1 : num > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      if (!decode_stream(d, num, 1, false, &t.data, nullptr, nullptr))
        return false;
      expand_color_map(num, t);
      return true;
    }
    default:
      return true;
  }
}

// libwebp's DecodeImageStream. At level 0 (the image itself) it reads the
// transforms and the codes and leaves the pixels to the caller.
bool decode_stream(LDec& d, int xsize, int ysize, bool level0,
                   std::vector<uint32_t>* data, Codes* level0_codes,
                   int* level0_xsize) {
  LBits& br = d.br;
  int txsize = xsize, tysize = ysize;
  bool ok = true;
  if (level0)
    while (ok && br.read(1)) ok = read_transform(d, &txsize, &tysize);
  int cache_bits = 0;
  if (ok && br.read(1)) {
    cache_bits = int(br.read(4));
    if (cache_bits < 1 || cache_bits > 11) return false;
  }
  Codes local;
  Codes& c = level0 ? *level0_codes : local;
  if (!ok || !read_codes(d, txsize, tysize, cache_bits, level0, c))
    return false;
  c.cache_bits = cache_bits;
  if (level0) {
    *level0_xsize = txsize;
    return true;
  }
  data->assign(size_t(txsize) * tysize, 0);
  return decode_pixels(d, c, data->data(), txsize, tysize) && !br.eos;
}

// --- inverse transforms ----------------------------------------------------

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int clip255(uint32_t a) { return a < 256 ? int(a) : int(~a >> 24); }

inline int sub3(int a, int b, int c) {
  return std::abs(b - c) - std::abs(a - c);
}

inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  int s = sub3(a >> 24, b >> 24, c >> 24) +
          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
          sub3(a & 0xff, b & 0xff, c & 0xff);
  return s <= 0 ? a : b;
}

inline uint32_t clamped_add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    int v = clip255(uint32_t(int((c0 >> sh) & 0xff) + int((c1 >> sh) & 0xff) -
                             int((c2 >> sh) & 0xff)));
    out |= uint32_t(v) << sh;
  }
  return out;
}

inline uint32_t clamped_add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t ave = average2(c0, c1), out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    int a = int((ave >> sh) & 0xff), b = int((c2 >> sh) & 0xff);
    out |= uint32_t(clip255(uint32_t(a + (a - b) / 2))) << sh;
  }
  return out;
}

// The predictor of mode m for the pixel whose left neighbour is left and
// whose row above starts at top (top[-1] top-left, top[1] top-right).
inline uint32_t predict(int m, uint32_t left, const uint32_t* top) {
  switch (m) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10:
      return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], left, top[-1]);
    case 12: return clamped_add_sub_full(left, top[0], top[-1]);
    case 13: return clamped_add_sub_half(left, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14-15 as libwebp pads them
  }
}

void inverse_predictor(const Transform& t, uint32_t* px) {
  const int w = t.xsize, h = t.ysize;
  for (int x = 0; x < w; ++x)  // first row: black, then left
    px[x] = add_pixels(px[x], x ? px[x - 1] : 0xff000000u);
  const int tiles = subsample(w, t.bits);
  for (int y = 1; y < h; ++y) {
    uint32_t* row = px + size_t(y) * w;
    const uint32_t* top = row - w;
    const uint32_t* modes = t.data.data() + size_t(y >> t.bits) * tiles;
    row[0] = add_pixels(row[0], top[0]);
    for (int x = 1; x < w; ++x) {
      int m = int((modes[x >> t.bits] >> 8) & 0xf);
      // top + x + 1 at the last column is the row's first pixel.
      row[x] = add_pixels(row[x], predict(m, row[x - 1], top + x));
    }
  }
}

inline int color_delta(int8_t pred, int8_t color) {
  return (int(pred) * color) >> 5;
}

void inverse_cross_color(const Transform& t, uint32_t* px) {
  const int w = t.xsize, h = t.ysize, tiles = subsample(w, t.bits);
  for (int y = 0; y < h; ++y) {
    const uint32_t* codes = t.data.data() + size_t(y >> t.bits) * tiles;
    for (int x = 0; x < w; ++x) {
      uint32_t code = codes[x >> t.bits];
      int8_t g2r = int8_t(code & 0xff), g2b = int8_t((code >> 8) & 0xff),
             r2b = int8_t((code >> 16) & 0xff);
      uint32_t argb = px[size_t(y) * w + x];
      int8_t green = int8_t(argb >> 8);
      int red = int((argb >> 16) & 0xff), blue = int(argb & 0xff);
      red = (red + color_delta(g2r, green)) & 0xff;
      blue += color_delta(g2b, green);
      blue = (blue + color_delta(r2b, int8_t(red))) & 0xff;
      px[size_t(y) * w + x] =
          (argb & 0xff00ff00u) | uint32_t(red) << 16 | uint32_t(blue);
    }
  }
}

void add_green(uint32_t* px, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    uint32_t g = (px[i] >> 8) & 0xff;
    uint32_t rb = (px[i] & 0x00ff00ffu) + (g << 16 | g);
    px[i] = (px[i] & 0xff00ff00u) | (rb & 0x00ff00ffu);
  }
}

// Colour indexing: packed indices (in: the packed width) to the palette.
void inverse_color_index(const Transform& t, const uint32_t* in,
                         uint32_t* out) {
  const int w = t.xsize, h = t.ysize, bits = t.bits;
  const int pw = subsample(w, bits);
  const int bpp = 8 >> bits, per = 1 << bits;
  const uint32_t bmask = (1u << bpp) - 1;
  for (int y = 0; y < h; ++y) {
    const uint32_t* src = in + size_t(y) * pw;
    uint32_t* dst = out + size_t(y) * w;
    uint32_t packed = 0;
    for (int x = 0; x < w; ++x) {
      if ((x & (per - 1)) == 0) packed = (*src++ >> 8) & 0xff;
      dst[x] = t.data[packed & bmask];
      packed >>= bpp;
    }
  }
}

// The transforms undone, last read first: the decoded (possibly packed)
// pixels in, the width x height image out.
std::vector<uint32_t> undo_transforms(const LDec& d,
                                      std::vector<uint32_t> px) {
  for (auto it = d.transforms.rbegin(); it != d.transforms.rend(); ++it) {
    const Transform& t = *it;
    switch (t.type) {
      case PREDICTOR: inverse_predictor(t, px.data()); break;
      case CROSS_COLOR: inverse_cross_color(t, px.data()); break;
      case SUBTRACT_GREEN: add_green(px.data(), px.size()); break;
      case COLOR_INDEXING: {
        std::vector<uint32_t> out(size_t(t.xsize) * t.ysize);
        inverse_color_index(t, px.data(), out.data());
        px.swap(out);
        break;
      }
    }
  }
  return px;
}

// A VP8L image stream after its header: ARGB, width x height.
std::vector<uint32_t> decode_argb(LDec& d, int width, int height) {
  Codes c;
  int txsize = 0;
  if (!decode_stream(d, width, height, true, nullptr, &c, &txsize))
    fail("corrupt VP8L stream");
  std::vector<uint32_t> px(size_t(txsize) * height);
  if (!decode_pixels(d, c, px.data(), txsize, height))
    fail("corrupt or truncated VP8L data");
  return undo_transforms(d, std::move(px));
}

// --- ALPH ------------------------------------------------------------------

// libwebp's DecodeAlphaData: colour-indexed alpha decoded to 8-bit
// indices. Unlike the ARGB path, the end of the stream may be passed by
// the last code, not before it.
bool decode_alpha_indices(LDec& d, const Codes& c, uint8_t* data, int width,
                          int height) {
  LBits& br = d.br;
  int row = 0, col = 0, pos = 0;
  const int end = width * height;
  const int mask = c.huff_bits ? (1 << c.huff_bits) - 1 : ~0;
  const Group* g = pos < end ? &c.at(col, row) : nullptr;
  while (!br.eos && pos < end) {
    if ((col & mask) == 0) g = &c.at(col, row);
    br.fill();
    int code = read_symbol(g->t[0], br);
    if (code < 256) {
      data[pos++] = uint8_t(code);
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else if (code < 256 + 24) {
      int length = copy_distance(code - 256, br);
      int dist_symbol = read_symbol(g->t[4], br);
      br.fill();
      int dist = plane_to_distance(width, copy_distance(dist_symbol, br));
      if (pos < dist || end - pos < length) return false;
      for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
      pos += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      if (pos < end && (col & mask)) g = &c.at(col, row);
    } else {
      return false;
    }
    br.eos = br.at_end();
  }
  br.eos = br.at_end();
  return !(br.eos && pos < end);
}

void unfilter(int filter, const uint8_t* prev, uint8_t* row, int width) {
  if (filter == 0) return;
  if (filter == 1 || prev == nullptr) {  // horizontal (and a first row)
    uint8_t pred = prev == nullptr ? 0 : prev[0];
    for (int i = 0; i < width; ++i) {
      row[i] = uint8_t(pred + row[i]);
      pred = row[i];
    }
  } else if (filter == 2) {  // vertical
    for (int i = 0; i < width; ++i) row[i] = uint8_t(prev[i] + row[i]);
  } else {  // gradient
    uint8_t top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      const int g = left + top - top_left;
      left = uint8_t(row[i] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
      top_left = top;
      row[i] = left;
    }
  }
}

// The ALPH chunk's payload to width x height alpha values.
void decode_alpha(const uint8_t* a, size_t n, int width, int height,
                  uint8_t* out) {
  if (n <= 1) fail("empty ALPH chunk");
  const int method = a[0] & 3, filter = (a[0] >> 2) & 3,
            pre = (a[0] >> 4) & 3, rsrv = a[0] >> 6;
  if (method > 1 || pre > 1 || rsrv != 0) fail("bad ALPH header");
  const size_t size = size_t(width) * height;
  if (method == 0) {
    if (n - 1 < size) fail("short ALPH data");
    std::memcpy(out, a + 1, size);
  } else {
    LDec d(a + 1, n - 1);
    Codes c;
    int txsize = 0;
    if (!decode_stream(d, width, height, true, nullptr, &c, &txsize))
      fail("corrupt ALPH stream");
    bool eight_bit = d.transforms.size() == 1 &&
                     d.transforms[0].type == COLOR_INDEXING &&
                     c.cache_bits == 0;
    for (const Group& g : c.groups)
      eight_bit = eight_bit && g.t[1][0].bits == 0 && g.t[2][0].bits == 0 &&
                  g.t[3][0].bits == 0;
    std::vector<uint32_t> argb;
    if (eight_bit) {
      std::vector<uint8_t> idx(size_t(txsize) * height);
      if (!decode_alpha_indices(d, c, idx.data(), txsize, height))
        fail("corrupt or truncated ALPH data");
      std::vector<uint32_t> packed(idx.size());
      for (size_t i = 0; i < idx.size(); ++i)
        packed[i] = uint32_t(idx[i]) << 8;
      argb = undo_transforms(d, std::move(packed));
    } else {
      argb.resize(size_t(txsize) * height);
      if (!decode_pixels(d, c, argb.data(), txsize, height))
        fail("corrupt or truncated ALPH data");
      argb = undo_transforms(d, std::move(argb));
    }
    for (size_t i = 0; i < size; ++i) out[i] = uint8_t(argb[i] >> 8);
  }
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    uint8_t* row = out + size_t(y) * width;
    unfilter(filter, prev, row, width);
    prev = row;
  }
}

// =========================================================================
// VP8
// =========================================================================

// RFC 6386's default coefficient probabilities, their update
// probabilities, and the 4x4 mode probabilities by the modes above and
// to the left (libwebp's mode order).
const uint8_t kCoeffsProba0[1056] = {
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
  189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
  106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
  1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
  181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
  78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
  1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
  184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
  77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
  1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
  170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
  37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
  1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
  207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
  102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
  1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
  177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
  80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
  131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
  68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
  1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
  184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
  81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
  1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
  99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
  23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
  1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
  109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
  44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
  1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
  94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
  22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
  1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
  124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
  35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
  1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
  121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
  45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
  1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
  203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
  253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
  175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
  73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
  1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
  239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
  155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
  1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
  201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
  69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
  1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
  223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
  141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
  149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
  213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
  55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
  126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
  61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
  1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
  166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
  39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
  1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
  124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
  24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
  1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
  149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
  28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
  1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
  123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
  20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
  1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
  168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
  47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
  1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
  141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
  42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kCoeffsUpdateProba[1056] = {
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
  250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
  234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
  251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kBModesProba[900] = {
  231, 120, 48, 89, 115, 113, 120, 152, 112,
  152, 179, 64, 126, 170, 118, 46, 70, 95,
  175, 69, 143, 80, 85, 82, 72, 155, 103,
  56, 58, 10, 171, 218, 189, 17, 13, 152,
  114, 26, 17, 163, 44, 195, 21, 10, 173,
  121, 24, 80, 195, 26, 62, 44, 64, 85,
  144, 71, 10, 38, 171, 213, 144, 34, 26,
  170, 46, 55, 19, 136, 160, 33, 206, 71,
  63, 20, 8, 114, 114, 208, 12, 9, 226,
  81, 40, 11, 96, 182, 84, 29, 16, 36,
  134, 183, 89, 137, 98, 101, 106, 165, 148,
  72, 187, 100, 130, 157, 111, 32, 75, 80,
  66, 102, 167, 99, 74, 62, 40, 234, 128,
  41, 53, 9, 178, 241, 141, 26, 8, 107,
  74, 43, 26, 146, 73, 166, 49, 23, 157,
  65, 38, 105, 160, 51, 52, 31, 115, 128,
  104, 79, 12, 27, 217, 255, 87, 17, 7,
  87, 68, 71, 44, 114, 51, 15, 186, 23,
  47, 41, 14, 110, 182, 183, 21, 17, 194,
  66, 45, 25, 102, 197, 189, 23, 18, 22,
  88, 88, 147, 150, 42, 46, 45, 196, 205,
  43, 97, 183, 117, 85, 38, 35, 179, 61,
  39, 53, 200, 87, 26, 21, 43, 232, 171,
  56, 34, 51, 104, 114, 102, 29, 93, 77,
  39, 28, 85, 171, 58, 165, 90, 98, 64,
  34, 22, 116, 206, 23, 34, 43, 166, 73,
  107, 54, 32, 26, 51, 1, 81, 43, 31,
  68, 25, 106, 22, 64, 171, 36, 225, 114,
  34, 19, 21, 102, 132, 188, 16, 76, 124,
  62, 18, 78, 95, 85, 57, 50, 48, 51,
  193, 101, 35, 159, 215, 111, 89, 46, 111,
  60, 148, 31, 172, 219, 228, 21, 18, 111,
  112, 113, 77, 85, 179, 255, 38, 120, 114,
  40, 42, 1, 196, 245, 209, 10, 25, 109,
  88, 43, 29, 140, 166, 213, 37, 43, 154,
  61, 63, 30, 155, 67, 45, 68, 1, 209,
  100, 80, 8, 43, 154, 1, 51, 26, 71,
  142, 78, 78, 16, 255, 128, 34, 197, 171,
  41, 40, 5, 102, 211, 183, 4, 1, 221,
  51, 50, 17, 168, 209, 192, 23, 25, 82,
  138, 31, 36, 171, 27, 166, 38, 44, 229,
  67, 87, 58, 169, 82, 115, 26, 59, 179,
  63, 59, 90, 180, 59, 166, 93, 73, 154,
  40, 40, 21, 116, 143, 209, 34, 39, 175,
  47, 15, 16, 183, 34, 223, 49, 45, 183,
  46, 17, 33, 183, 6, 98, 15, 32, 183,
  57, 46, 22, 24, 128, 1, 54, 17, 37,
  65, 32, 73, 115, 28, 128, 23, 128, 205,
  40, 3, 9, 115, 51, 192, 18, 6, 223,
  87, 37, 9, 115, 59, 77, 64, 21, 47,
  104, 55, 44, 218, 9, 54, 53, 130, 226,
  64, 90, 70, 205, 40, 41, 23, 26, 57,
  54, 57, 112, 184, 5, 41, 38, 166, 213,
  30, 34, 26, 133, 152, 116, 10, 32, 134,
  39, 19, 53, 221, 26, 114, 32, 73, 255,
  31, 9, 65, 234, 2, 15, 1, 118, 73,
  75, 32, 12, 51, 192, 255, 160, 43, 51,
  88, 31, 35, 67, 102, 85, 55, 186, 85,
  56, 21, 23, 111, 59, 205, 45, 37, 192,
  55, 38, 70, 124, 73, 102, 1, 34, 98,
  125, 98, 42, 88, 104, 85, 117, 175, 82,
  95, 84, 53, 89, 128, 100, 113, 101, 45,
  75, 79, 123, 47, 51, 128, 81, 171, 1,
  57, 17, 5, 71, 102, 57, 53, 41, 49,
  38, 33, 13, 121, 57, 73, 26, 1, 85,
  41, 10, 67, 138, 77, 110, 90, 47, 114,
  115, 21, 2, 10, 102, 255, 166, 23, 6,
  101, 29, 16, 10, 85, 128, 101, 196, 26,
  57, 18, 10, 102, 102, 213, 34, 20, 43,
  117, 20, 15, 36, 163, 128, 68, 1, 26,
  102, 61, 71, 37, 34, 53, 31, 243, 192,
  69, 60, 71, 38, 73, 119, 28, 222, 37,
  68, 45, 128, 34, 1, 47, 11, 245, 171,
  62, 17, 19, 70, 146, 85, 55, 62, 70,
  37, 43, 37, 154, 100, 163, 85, 160, 1,
  63, 9, 92, 136, 28, 64, 32, 201, 85,
  75, 15, 9, 9, 64, 255, 184, 119, 16,
  86, 6, 28, 5, 64, 255, 25, 248, 1,
  56, 8, 17, 132, 137, 255, 55, 116, 128,
  58, 15, 20, 82, 135, 57, 26, 121, 40,
  164, 50, 31, 137, 154, 133, 25, 35, 218,
  51, 103, 44, 131, 131, 123, 31, 6, 158,
  86, 40, 64, 135, 148, 224, 45, 183, 128,
  22, 26, 17, 131, 240, 154, 14, 1, 209,
  45, 16, 21, 91, 64, 222, 7, 1, 197,
  56, 21, 39, 155, 60, 138, 23, 102, 213,
  83, 12, 13, 54, 192, 255, 68, 47, 28,
  85, 26, 85, 85, 128, 128, 32, 146, 171,
  18, 11, 7, 63, 144, 171, 4, 4, 246,
  35, 27, 10, 146, 174, 171, 12, 26, 128,
  190, 80, 35, 99, 180, 80, 126, 54, 45,
  85, 126, 47, 87, 176, 51, 41, 20, 32,
  101, 75, 128, 139, 118, 146, 116, 128, 85,
  56, 41, 15, 176, 236, 85, 37, 9, 62,
  71, 30, 17, 119, 118, 255, 17, 18, 138,
  101, 38, 60, 138, 55, 70, 43, 26, 142,
  146, 36, 19, 30, 171, 255, 97, 27, 20,
  138, 45, 61, 62, 219, 1, 81, 188, 64,
  32, 41, 20, 117, 151, 142, 20, 21, 163,
  112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kZigzag[16] = {0, 1,  4,  8,  5, 2,  3,  6,
                             9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177,
                         153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// The 4x4 intra modes in libwebp's order, and their tree.
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
  B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
  TM_PRED = B_TM_PRED,
  DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6
};
const int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED,
    -B_HU_PRED};

// libwebp's VP8BitReader, loading a byte at a time (the end of the data
// is met at the same bit as with its wider loads): a read past the end
// shifts in one zero byte and sets eof, which fails the decode.
struct BoolDec {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;  // range - 1
  bool eof = false;

  void init(const uint8_t* d, size_t n) {
    buf = d;
    end = d + n;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = uint64_t(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const uint32_t v = uint32_t(value >> pos);
    int bit;
    if (v > split) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
      bit = 1;
    } else {
      r = split + 1;
      bit = 0;
    }
    int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= get(0x80) << n;
    return v;
  }
  int signed_bits(int n) {
    int v = value_bits(n);
    return get(0x80) ? -v : v;
  }
};

struct FInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t uvmode = 0, is_i4x4 = 0, segment = 0, skip = 0;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

struct Quant {
  int y1[2], y2[2], uv[2];
};

const int BPS = 32;
const int Y_OFF = BPS * 1 + 8;
const int U_OFF = Y_OFF + BPS * 16 + BPS;
const int V_OFF = U_OFF + 16;

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : uint8_t(v); }

// --- inverse transforms ----------------------------------------------------

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// The full 4x4 inverse DCT as libwebp's SSE2 code computes it: every sum
// in 16 bits, wrapping.
inline int16_t w16(int v) { return int16_t(v); }
inline int16_t mulhi(int16_t a, int k) {
  return int16_t((int32_t(a) * k) >> 16);
}

void transform_full(const int16_t* in, uint8_t* dst) {
  int16_t t[4][4];  // t[row of output][column] after the first pass
  for (int i = 0; i < 4; ++i) {
    const int16_t i0 = in[i], i1 = in[4 + i], i2 = in[8 + i], i3 = in[12 + i];
    int16_t a = w16(i0 + i2), b = w16(i0 - i2);
    int16_t c = w16(w16(i1 - i3) + w16(mulhi(i1, -30068) - mulhi(i3, 20091)));
    int16_t d = w16(w16(i1 + i3) + w16(mulhi(i1, 20091) + mulhi(i3, -30068)));
    t[0][i] = w16(a + d);
    t[1][i] = w16(b + c);
    t[2][i] = w16(b - c);
    t[3][i] = w16(a - d);
  }
  for (int r = 0; r < 4; ++r) {
    // Row r of the output takes the first pass's column values at r.
    const int16_t T0 = t[r][0], T1 = t[r][1], T2 = t[r][2], T3 = t[r][3];
    int16_t dc = w16(T0 + 4);
    int16_t a = w16(dc + T2), b = w16(dc - T2);
    int16_t c = w16(w16(T1 - T3) + w16(mulhi(T1, -30068) - mulhi(T3, 20091)));
    int16_t d = w16(w16(T1 + T3) + w16(mulhi(T1, 20091) + mulhi(T3, -30068)));
    const int16_t o[4] = {int16_t(w16(a + d) >> 3), int16_t(w16(b + c) >> 3),
                          int16_t(w16(b - c) >> 3), int16_t(w16(a - d) >> 3)};
    for (int x = 0; x < 4; ++x)
      dst[x + r * BPS] = clip8(int(dst[x + r * BPS]) + o[x]);
  }
}

inline void store(uint8_t* dst, int x, int y, int v) {
  dst[x + y * BPS] = clip8(dst[x + y * BPS] + (v >> 3));
}

void transform_ac3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int dcs[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    store(dst, 0, y, dcs[y] + d1);
    store(dst, 1, y, dcs[y] + c1);
    store(dst, 2, y, dcs[y] - c1);
    store(dst, 3, y, dcs[y] - d1);
  }
}

void transform_dc(const int16_t* in, uint8_t* dst) {
  const int dc = in[0] + 4;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) store(dst, x, y, dc);
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

// DoTransform: the block's code (3: more than 3 coefficients, 2: two or
// three, 1: the DC alone) picks libwebp's transform.
void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: transform_full(src, dst); break;
    case 2: transform_ac3(src, dst); break;
    case 1: transform_dc(src, dst); break;
    default: break;
  }
}

void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (!(bits & 0xff)) return;
  if (bits & 0xaa) {  // an AC coefficient: all four blocks in full
    transform_full(src, dst);
    transform_full(src + 16, dst + 4);
    transform_full(src + 32, dst + 4 * BPS);
    transform_full(src + 48, dst + 4 * BPS + 4);
  } else {
    if (src[0]) transform_dc(src, dst);
    if (src[16]) transform_dc(src + 16, dst + 4);
    if (src[32]) transform_dc(src + 32, dst + 4 * BPS);
    if (src[48]) transform_dc(src + 48, dst + 4 * BPS + 4);
  }
}

// --- intra predictors (libwebp's dsp/dec.c) --------------------------------

inline uint8_t avg3(int a, int b, int c) {
  return uint8_t((a + 2 * b + c + 2) >> 2);
}
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }
#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(l + top[x] - tl);
    dst += BPS;
  }
}

void pred4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3],
            E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, int(dc), 4);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                            avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE_PRED: {
      const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                            avg3(K, L, L)};
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, v[i], 4);
      break;
    }
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU_PRED
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          uint8_t(L);
      break;
  }
}
#undef DST

// 16x16 luma (size 16) and 8x8 chroma (size 8) predictors, the DC modes
// told apart at the frame's top and left edges.
void pred_block(int mode, uint8_t* dst, int size) {
  const int shift = size == 16 ? 4 : 3;
  int v = -1;
  switch (mode) {
    case DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      v = dc >> (shift + 1);
      break;
    }
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      v = dc >> shift;
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      v = dc >> shift;
      break;
    }
    case DC_NOTOPLEFT: v = 0x80; break;
    case TM_PRED: true_motion(dst, size); return;
    case V_PRED:
      for (int j = 0; j < size; ++j)
        std::memcpy(dst + j * BPS, dst - BPS, size);
      return;
    default:  // H_PRED
      for (int j = 0; j < size; ++j)
        std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      return;
  }
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : DC_PRED;
  }
  return mode;
}

// --- loop filters (libwebp's C reference; its SSE2 code is the same) --------

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// step: across the edge; stride: along it.
void simple_filter(uint8_t* p, int step, int stride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * stride, step, thresh2))
      do_filter2(p + i * stride, step);
}

void filter_loop(uint8_t* p, int step, int stride, int size, int thresh,
                 int ithresh, int hev_thresh, bool mb_edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, step, thresh2, ithresh)) {
      if (hev(p, step, hev_thresh))
        do_filter2(p, step);
      else if (mb_edge)
        do_filter6(p, step);
      else
        do_filter4(p, step);
    }
    p += stride;
  }
}

// --- the decoder ------------------------------------------------------------

struct VP8Dec {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolDec br;
  BoolDec parts[8];
  int num_parts_minus_one = 0;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t segment_p[3] = {255, 255, 255};
  // filter header
  bool simple = false;
  int level = 0, sharpness = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  Quant dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  FInfo fstrengths[4][2];

  std::vector<uint8_t> ybuf, ubuf, vbuf;  // the planes, whole macroblocks
  int ystride = 0, uvstride = 0;
};

void parse_header(VP8Dec& d, const uint8_t* buf, size_t size) {
  if (size < 4) fail("truncated VP8 header");
  const uint32_t bits = buf[0] | buf[1] << 8 | buf[2] << 16;
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const bool show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (profile > 3) fail("incorrect VP8 keyframe parameters");
  if (!show) fail("VP8 frame not displayable");
  buf += 3;
  size -= 3;
  if (!key_frame) fail("not a VP8 key frame");
  if (size < 7) fail("cannot parse the VP8 picture header");
  if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a)
    fail("bad VP8 code word");
  d.width = (buf[4] << 8 | buf[3]) & 0x3fff;
  d.height = (buf[6] << 8 | buf[5]) & 0x3fff;
  buf += 7;
  size -= 7;
  d.mb_w = (d.width + 15) >> 4;
  d.mb_h = (d.height + 15) >> 4;
  if (partition_length > size) fail("bad VP8 partition length");
  BoolDec& br = d.br;
  br.init(buf, partition_length);
  buf += partition_length;
  size -= partition_length;

  br.get(0x80);  // colour space
  br.get(0x80);  // clamping type (libwebp always clamps)
  d.use_segment = br.get(0x80);
  if (d.use_segment) {
    d.update_map = br.get(0x80);
    if (br.get(0x80)) {
      d.absolute_delta = br.get(0x80);
      for (int s = 0; s < 4; ++s)
        d.quantizer[s] = br.get(0x80) ? br.signed_bits(7) : 0;
      for (int s = 0; s < 4; ++s)
        d.filter_strength[s] = br.get(0x80) ? br.signed_bits(6) : 0;
    }
    if (d.update_map)
      for (int s = 0; s < 3; ++s)
        d.segment_p[s] = uint8_t(br.get(0x80) ? br.value_bits(8) : 255);
  }
  if (br.eof) fail("cannot parse the VP8 segment header");

  d.simple = br.get(0x80);
  d.level = br.value_bits(6);
  d.sharpness = br.value_bits(3);
  d.use_lf_delta = br.get(0x80);
  if (d.use_lf_delta && br.get(0x80)) {
    for (int i = 0; i < 4; ++i)
      if (br.get(0x80)) d.ref_lf_delta[i] = br.signed_bits(6);
    for (int i = 0; i < 4; ++i)
      if (br.get(0x80)) d.mode_lf_delta[i] = br.signed_bits(6);
  }
  d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
  if (br.eof) fail("cannot parse the VP8 filter header");

  // Token partitions: the sizes of all but the last, then the data.
  d.num_parts_minus_one = (1 << br.value_bits(2)) - 1;
  const size_t last = size_t(d.num_parts_minus_one);
  if (size < 3 * last) fail("cannot parse the VP8 partitions");
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + last * 3;
  const uint8_t* buf_end = buf + size;
  size_t size_left = size - last * 3;
  for (size_t p = 0; p < last; ++p) {
    size_t psize = sz[0] | sz[1] << 8 | sz[2] << 16;
    if (psize > size_left) psize = size_left;
    d.parts[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  d.parts[last].init(part_start, size_left);
  if (part_start >= buf_end) fail("cannot parse the VP8 partitions");

  // Quantizers.
  const int base_q0 = br.value_bits(7);
  int dq[5];
  for (int i = 0; i < 5; ++i) dq[i] = br.get(0x80) ? br.signed_bits(4) : 0;
  static const int kDcTable[128] = {
      4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14,
      15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22,
      23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32,
      33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
      44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54,
      55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66,
      67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77,
      78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
      91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110,
      112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136,
      138, 140, 143, 145, 148, 151, 154, 157,
  };
  static const int kAcTable[128] = {
      4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
      16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
      28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39,
      40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
      52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68,
      70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92,
      94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
      119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
      155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
      197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
      249, 254, 259, 264, 269, 274, 279, 284,
  };
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (d.use_segment) {
      q = d.quantizer[i];
      if (!d.absolute_delta) q += base_q0;
    } else if (i > 0) {
      d.dqm[i] = d.dqm[0];
      continue;
    } else {
      q = base_q0;
    }
    Quant& m = d.dqm[i];
    m.y1[0] = kDcTable[clip(q + dq[0], 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dq[1], 127)] * 2;
    m.y2[1] = (kAcTable[clip(q + dq[2], 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dq[3], 117)];
    m.uv[1] = kAcTable[clip(q + dq[4], 127)];
  }

  br.get(0x80);  // update_proba, ignored
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int k = ((t * 8 + b) * 3 + c) * 11 + p;
          d.proba[t][b][c][p] = uint8_t(
              br.get(kCoeffsUpdateProba[k]) ? br.value_bits(8)
                                            : kCoeffsProba0[k]);
        }
  d.use_skip = br.get(0x80);
  if (d.use_skip) d.skip_p = br.value_bits(8);
}

void precompute_filter_strengths(VP8Dec& d) {
  if (d.filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (d.use_segment) {
      base_level = d.filter_strength[s];
      if (!d.absolute_delta) base_level += d.level;
    } else {
      base_level = d.level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = d.fstrengths[s][i4x4];
      int level = base_level;
      if (d.use_lf_delta) {
        level += d.ref_lf_delta[0];
        if (i4x4) level += d.mode_lf_delta[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (d.sharpness > 0) {
          ilevel >>= d.sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = uint8_t(ilevel);
        info.limit = uint8_t(2 * level + ilevel);
        info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
      }
      info.inner = uint8_t(i4x4);
    }
  }
}

void parse_intra_mode(VP8Dec& d, BoolDec& br, uint8_t* top, uint8_t* left,
                      MBData& b) {
  b.segment = d.update_map
                  ? (!br.get(d.segment_p[0]) ? br.get(d.segment_p[1])
                                             : br.get(d.segment_p[2]) + 2)
                  : 0;
  if (d.use_skip) b.skip = uint8_t(br.get(d.skip_p));
  b.is_i4x4 = !br.get(145);
  if (!b.is_i4x4) {
    const int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED)
                                  : (br.get(163) ? V_PRED : DC_PRED);
    b.imodes[0] = uint8_t(ymode);
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = b.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
        int i = kYModesIntra4[br.get(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
        ymode = -i;
        top[x] = uint8_t(ymode);
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = uint8_t(ymode);
    }
  }
  b.uvmode = uint8_t(!br.get(142)   ? DC_PRED
                     : !br.get(114) ? V_PRED
                     : br.get(183)  ? TM_PRED
                                    : H_PRED);
}

int large_value(BoolDec& br, const uint8_t* p) {
  int v;
  if (!br.get(p[3])) {
    v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
  } else if (!br.get(p[6])) {
    if (!br.get(p[7])) {
      v = 5 + br.get(159);
    } else {
      v = 7 + 2 * br.get(165);
      v += br.get(145);
    }
  } else {
    const int bit1 = br.get(p[8]);
    const int bit0 = br.get(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
      v += v + br.get(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// libwebp's GetCoeffs: the position past the last coefficient read.
int get_coeffs(BoolDec& br, uint8_t (*bands)[3][11], int ctx, const int* dq,
               int n, int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;
    while (!br.get(p[1])) {
      ++n;
      if (n == 16) return 16;
      p = bands[kBands[n]][0];
    }
    int v;
    const int nb = kBands[n + 1];
    if (!br.get(p[2])) {
      v = 1;
      p = bands[nb][1];
    } else {
      v = large_value(br, p);
      p = bands[nb][2];
    }
    const int s = br.get(0x80) ? -v : v;
    out[kZigzag[n]] = int16_t(s * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= nz > 3 ? 3 : nz > 1 ? 2 : uint32_t(dc_nz);
  return nz_coeffs;
}

struct NZ {
  uint8_t nz = 0, nz_dc = 0;
};

// libwebp's ParseResiduals: true when every coefficient is zero.
bool parse_residuals(VP8Dec& d, NZ& mb, NZ& left, MBData& b, BoolDec& br) {
  const Quant& q = d.dqm[b.segment];
  int16_t* dst = b.coeffs;
  std::memset(dst, 0, sizeof(b.coeffs));
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  int first;
  uint8_t(*ac_proba)[3][11];
  if (!b.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = mb.nz_dc + left.nz_dc;
    const int nz = get_coeffs(br, d.proba[1], ctx, q.y2, 0, dc);
    mb.nz_dc = left.nz_dc = nz > 0;
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
    }
    first = 1;
    ac_proba = d.proba[0];
  } else {
    first = 0;
    ac_proba = d.proba[3];
  }
  uint8_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_proba, ctx, q.y1, first, dst);
      l = nz > first;
      tnz = uint8_t((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = uint8_t((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = uint8_t(mb.nz >> (4 + ch));
    lnz = uint8_t(left.nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, d.proba[2], ctx, q.uv, 0, dst);
        l = nz > 0;
        tnz = uint8_t((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = uint8_t((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= uint32_t(tnz << 4) << ch;
    out_l_nz |= uint32_t(lnz & 0xf0) << ch;
  }
  mb.nz = uint8_t(out_t_nz);
  left.nz = uint8_t(out_l_nz);
  b.non_zero_y = non_zero_y;
  b.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

struct TopSamples {
  uint8_t y[16], u[8], v[8];
};

// libwebp's ReconstructRow, into the planes.
void reconstruct_row(VP8Dec& d, int mb_y, std::vector<MBData>& row,
                     std::vector<TopSamples>& tops, uint8_t* yuv_b) {
  uint8_t* const y_dst = yuv_b + Y_OFF;
  uint8_t* const u_dst = yuv_b + U_OFF;
  uint8_t* const v_dst = yuv_b + V_OFF;
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
  for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
  if (mb_y > 0) {
    y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
  } else {
    std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    std::memset(u_dst - BPS - 1, 127, 8 + 1);
    std::memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
    const MBData& b = row[mb_x];
    if (mb_x > 0) {
      for (int j = -1; j < 16; ++j)
        std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
      for (int j = -1; j < 8; ++j) {
        std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
        std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
      }
    }
    TopSamples* top = &tops[mb_x];
    uint32_t bits = b.non_zero_y;
    if (mb_y > 0) {
      std::memcpy(y_dst - BPS, top[0].y, 16);
      std::memcpy(u_dst - BPS, top[0].u, 8);
      std::memcpy(v_dst - BPS, top[0].v, 8);
    }
    if (b.is_i4x4) {
      uint8_t* const top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= d.mb_w - 1)
          std::memset(top_right, top[0].y[15], 4);
        else
          std::memcpy(top_right, top[1].y, 4);
      }
      for (int k = 1; k <= 3; ++k)  // replicated below for rows 1-3
        std::memcpy(top_right + 4 * k * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* const dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        pred4(b.imodes[n], dst);
        do_transform(bits, b.coeffs + n * 16, dst);
      }
    } else {
      pred_block(check_mode(mb_x, mb_y, b.imodes[0]), y_dst, 16);
      if (bits != 0)
        for (int n = 0; n < 16; ++n, bits <<= 2)
          do_transform(bits, b.coeffs + n * 16,
                       y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    const int uvmode = check_mode(mb_x, mb_y, b.uvmode);
    pred_block(uvmode, u_dst, 8);
    pred_block(uvmode, v_dst, 8);
    do_uv_transform(b.non_zero_uv >> 0, b.coeffs + 16 * 16, u_dst);
    do_uv_transform(b.non_zero_uv >> 8, b.coeffs + 20 * 16, v_dst);
    if (mb_y < d.mb_h - 1) {
      std::memcpy(top[0].y, y_dst + 15 * BPS, 16);
      std::memcpy(top[0].u, u_dst + 7 * BPS, 8);
      std::memcpy(top[0].v, v_dst + 7 * BPS, 8);
    }
    uint8_t* yo = d.ybuf.data() + size_t(mb_y) * 16 * d.ystride + mb_x * 16;
    uint8_t* uo = d.ubuf.data() + size_t(mb_y) * 8 * d.uvstride + mb_x * 8;
    uint8_t* vo = d.vbuf.data() + size_t(mb_y) * 8 * d.uvstride + mb_x * 8;
    for (int j = 0; j < 16; ++j)
      std::memcpy(yo + j * d.ystride, y_dst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(uo + j * d.uvstride, u_dst + j * BPS, 8);
      std::memcpy(vo + j * d.uvstride, v_dst + j * BPS, 8);
    }
  }
}

// libwebp's DoFilter on one macroblock of the planes.
void filter_mb(VP8Dec& d, const FInfo& f, int mb_x, int mb_y) {
  const int limit = f.limit;
  if (limit == 0) return;
  const int ys = d.ystride, uvs = d.uvstride;
  uint8_t* y = d.ybuf.data() + size_t(mb_y) * 16 * ys + mb_x * 16;
  if (d.filter_type == 1) {  // simple, luma only
    if (mb_x > 0) simple_filter(y, 1, ys, limit + 4);
    if (f.inner)
      for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k, 1, ys, limit);
    if (mb_y > 0) simple_filter(y, ys, 1, limit + 4);
    if (f.inner)
      for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k * ys, ys, 1, limit);
    return;
  }
  uint8_t* u = d.ubuf.data() + size_t(mb_y) * 8 * uvs + mb_x * 8;
  uint8_t* v = d.vbuf.data() + size_t(mb_y) * 8 * uvs + mb_x * 8;
  const int il = f.ilevel, hev_t = f.hev_thresh;
  if (mb_x > 0) {
    filter_loop(y, 1, ys, 16, limit + 4, il, hev_t, true);
    filter_loop(u, 1, uvs, 8, limit + 4, il, hev_t, true);
    filter_loop(v, 1, uvs, 8, limit + 4, il, hev_t, true);
  }
  if (f.inner) {
    for (int k = 1; k <= 3; ++k)
      filter_loop(y + 4 * k, 1, ys, 16, limit, il, hev_t, false);
    filter_loop(u + 4, 1, uvs, 8, limit, il, hev_t, false);
    filter_loop(v + 4, 1, uvs, 8, limit, il, hev_t, false);
  }
  if (mb_y > 0) {
    filter_loop(y, ys, 1, 16, limit + 4, il, hev_t, true);
    filter_loop(u, uvs, 1, 8, limit + 4, il, hev_t, true);
    filter_loop(v, uvs, 1, 8, limit + 4, il, hev_t, true);
  }
  if (f.inner) {
    for (int k = 1; k <= 3; ++k)
      filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, hev_t, false);
    filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
    filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
  }
}

// The frame to its filtered planes (macroblock-padded, in d).
void decode_vp8_planes(VP8Dec& d, const uint8_t* data, size_t size) {
  parse_header(d, data, size);
  precompute_filter_strengths(d);
  d.ystride = d.mb_w * 16;
  d.uvstride = d.mb_w * 8;
  d.ybuf.assign(size_t(d.ystride) * d.mb_h * 16, 0);
  d.ubuf.assign(size_t(d.uvstride) * d.mb_h * 8, 0);
  d.vbuf.assign(size_t(d.uvstride) * d.mb_h * 8, 0);
  std::vector<uint8_t> intra_t(size_t(4) * d.mb_w, B_DC_PRED);
  std::vector<NZ> nz_top(d.mb_w);
  std::vector<MBData> row(d.mb_w);
  std::vector<TopSamples> tops(d.mb_w + 1);
  std::vector<FInfo> finfo(size_t(d.mb_w) * d.mb_h);
  std::vector<uint8_t> yuv_b(BPS * 17 + BPS * 9, 0);
  for (int mb_y = 0; mb_y < d.mb_h; ++mb_y) {
    BoolDec& tbr = d.parts[mb_y & d.num_parts_minus_one];
    uint8_t intra_l[4];
    std::memset(intra_l, B_DC_PRED, 4);
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      row[mb_x].skip = 0;
      parse_intra_mode(d, d.br, &intra_t[4 * mb_x], intra_l, row[mb_x]);
    }
    if (d.br.eof) fail("premature end of VP8 partition 0");
    NZ left;
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      MBData& b = row[mb_x];
      NZ& mb = nz_top[mb_x];
      bool skip = d.use_skip ? b.skip : false;
      if (!skip) {
        skip = parse_residuals(d, mb, left, b, tbr);
      } else {
        left.nz = mb.nz = 0;
        if (!b.is_i4x4) left.nz_dc = mb.nz_dc = 0;
        b.non_zero_y = 0;
        b.non_zero_uv = 0;
      }
      if (d.filter_type > 0) {
        FInfo& f = finfo[size_t(mb_y) * d.mb_w + mb_x];
        f = d.fstrengths[b.segment][b.is_i4x4];
        f.inner |= uint8_t(!skip);
      }
      if (tbr.eof) fail("premature end of VP8 data");
    }
    reconstruct_row(d, mb_y, row, tops, yuv_b.data());
  }
  if (d.filter_type > 0)
    for (int mb_y = 0; mb_y < d.mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < d.mb_w; ++mb_x)
        filter_mb(d, finfo[size_t(mb_y) * d.mb_w + mb_x], mb_x, mb_y);
}

// --- YUV -> RGB -----------------------------------------------------------

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) {
  return (v & ~16383) == 0 ? (v >> 6) : v < 0 ? 0 : 255;
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = uint8_t(yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
  rgb[1] = uint8_t(yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) -
                             mult_hi(v, 13320) + 8708));
  rgb[2] = uint8_t(yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
}

// libwebp's fancy upsampler for one output row: near is the nearer chroma
// row, far the other (the same row at the top and bottom edges).
void upsample_row(const uint8_t* y, const uint8_t* nu, const uint8_t* nv,
                  const uint8_t* fu, const uint8_t* fv, uint8_t* dst,
                  int len) {
  auto one = [](int a, int b, int c, int dd) {
    return (a + ((a + 3 * b + 3 * c + dd + 8) >> 3)) >> 1;
  };
  yuv_to_rgb(y[0], (3 * nu[0] + fu[0] + 2) >> 2, (3 * nv[0] + fv[0] + 2) >> 2,
             dst);
  const int last_pair = (len - 1) >> 1;
  for (int x = 1; x <= last_pair; ++x) {
    yuv_to_rgb(y[2 * x - 1], one(nu[x - 1], nu[x], fu[x - 1], fu[x]),
               one(nv[x - 1], nv[x], fv[x - 1], fv[x]), dst + (2 * x - 1) * 4);
    yuv_to_rgb(y[2 * x], one(nu[x], nu[x - 1], fu[x], fu[x - 1]),
               one(nv[x], nv[x - 1], fv[x], fv[x - 1]), dst + (2 * x) * 4);
  }
  if (!(len & 1)) {
    const int c = last_pair;
    yuv_to_rgb(y[len - 1], (3 * nu[c] + fu[c] + 2) >> 2,
               (3 * nv[c] + fv[c] + 2) >> 2, dst + (len - 1) * 4);
  }
}

void planes_to_rgba(const VP8Dec& d, uint8_t* rgba) {
  const int w = d.width, h = d.height;
  for (int y = 0; y < h; ++y) {
    int near_row, far_row;
    if (y == 0) {
      near_row = far_row = 0;
    } else if (y & 1) {
      near_row = (y - 1) >> 1;
      far_row = y + 1 < h ? near_row + 1 : near_row;
    } else {
      near_row = y >> 1;
      far_row = near_row - 1;
    }
    const uint8_t* nu = d.ubuf.data() + size_t(near_row) * d.uvstride;
    const uint8_t* nv = d.vbuf.data() + size_t(near_row) * d.uvstride;
    const uint8_t* fu = d.ubuf.data() + size_t(far_row) * d.uvstride;
    const uint8_t* fv = d.vbuf.data() + size_t(far_row) * d.uvstride;
    uint8_t* dst = rgba + size_t(y) * w * 4;
    upsample_row(d.ybuf.data() + size_t(y) * d.ystride, nu, nv, fu, fv, dst,
                 w);
    for (int x = 0; x < w; ++x) dst[4 * x + 3] = 255;
  }
}

int run(char* err, int errlen, void (*body)(void*), void* arg) {
  try {
    body(arg);
    return 0;
  } catch (const Fail& f) {
    std::snprintf(err, size_t(errlen), "%s", f.msg);
  } catch (const std::bad_alloc&) {
    std::snprintf(err, size_t(errlen), "out of memory");
  }
  return 1;
}

}  // namespace

extern "C" {

// A VP8L bitstream (its 5-byte header on) to width x height RGBA.
int gpt_webp_vp8l(const uint8_t* data, int64_t n, int32_t width,
                  int32_t height, uint8_t* rgba, char* err, int errlen) {
  struct Args {
    const uint8_t* data;
    int64_t n;
    int32_t w, h;
    uint8_t* rgba;
  } a{data, n, width, height, rgba};
  return run(err, errlen, [](void* p) {
    const Args& a = *static_cast<Args*>(p);
    LDec d(a.data, size_t(a.n));
    LBits& br = d.br;
    if (br.read(8) != 0x2f) fail("bad VP8L signature");
    const int w = int(br.read(14)) + 1, h = int(br.read(14)) + 1;
    br.read(1);  // alpha_is_used: a hint only
    if (br.read(3) != 0 || br.eos) fail("bad VP8L header");
    if (w != a.w || h != a.h) fail("VP8L size differs from the frame's");
    const std::vector<uint32_t> argb = decode_argb(d, w, h);
    for (size_t i = 0; i < argb.size(); ++i) {
      a.rgba[4 * i + 0] = uint8_t(argb[i] >> 16);
      a.rgba[4 * i + 1] = uint8_t(argb[i] >> 8);
      a.rgba[4 * i + 2] = uint8_t(argb[i]);
      a.rgba[4 * i + 3] = uint8_t(argb[i] >> 24);
    }
  }, &a);
}

// A VP8 frame (from its frame tag to the end of its chunk, padding
// included, as libwebp reads it) and its ALPH payload (alpha null: none)
// to width x height RGBA.
int gpt_webp_vp8(const uint8_t* data, int64_t n, const uint8_t* alpha,
                 int64_t alpha_n, int32_t width, int32_t height, uint8_t* rgba,
                 char* err, int errlen) {
  struct Args {
    const uint8_t* data;
    int64_t n;
    const uint8_t* alpha;
    int64_t alpha_n;
    int32_t w, h;
    uint8_t* rgba;
  } a{data, n, alpha, alpha_n, width, height, rgba};
  return run(err, errlen, [](void* p) {
    const Args& a = *static_cast<Args*>(p);
    VP8Dec d;
    decode_vp8_planes(d, a.data, size_t(a.n));
    if (d.width != a.w || d.height != a.h)
      fail("VP8 size differs from the frame's");
    planes_to_rgba(d, a.rgba);
    if (a.alpha != nullptr) {
      std::vector<uint8_t> plane(size_t(d.width) * d.height);
      decode_alpha(a.alpha, size_t(a.alpha_n), d.width, d.height,
                   plane.data());
      for (size_t i = 0; i < plane.size(); ++i) a.rgba[4 * i + 3] = plane[i];
    }
  }, &a);
}

}  // extern "C"
