// JPEG 2000 Part 1 codestreams decoded as Pillow 12.1.0 reads them through
// OpenJPEG 2.5.4, bit for bit: the codestream by opj_read_header, then tile
// by tile by opj_read_tile_header / opj_decode_tile_data in OpenJPEG's
// strict mode (Pillow sets no other), each tile's samples unpacked into
// Pillow's image by its Jpeg2KDecode.c unpackers.
//
//   - Markers (j2k.c): SIZ, COD, COC, QCD, QCC, RGN, POC, TLM, PLM, PLT,
//     PPM, PPT, CRG, COM, CAP, CPF, and Part 2's MCT, MCC, MCO and CBD
//     (their records; COD refuses the array transform that would apply
//     them, so MCO's DC level shifts and CBD's depths are what decodes
//     differently) in the main header, SOT / SOD
//     tile-parts, EOC; the checks OpenJPEG makes of each, its skip over
//     unknown markers in the main header, and the order in which it
//     decodes tiles. Packed packet headers: PPM's Nppm runs merged into
//     one stream the packets read on from, tile after tile; a tile's PPT
//     segments merged by Zppt.
//   - Tier 2 (t2.c, pi.c, tgt.c, bio.c): the five progression orders and
//     POC (one iterator a POC, their included-packet table shared), tag
//     trees, packet headers with SOP (a missing one warns) and EPH (a
//     missing one fails), code-block segments across layers by the bypass
//     / termall rules, HTJ2K's segments; the highest resolution a tile's
//     packets reach, which sets its wavelet levels and its packed size.
//   - Tier 1 (t1.c, mqc.c): the MQ decoder with OpenJPEG's synthetic FF FF
//     at a segment's end, the raw (bypass) decoder, the three passes with
//     reset, termall, vertically causal contexts and segmentation symbols,
//     then ROI max-shift and the reconstruction (integer halving for 5/3,
//     a float product by half the step size for 9/7). HTJ2K code-blocks
//     (ht_dec.c): the cleanup pass's MEL, VLC, UVLC and MagSgn, the
//     SigProp and MagRef passes, and OpenJPEG's checks of each block.
//   - The inverse wavelets (dwt.c): OpenJPEG's 5/3 lifting with its
//     one-pass boundary formulas, and its 9/7 in float with its constants,
//     the "two_invK" scale of the high band and its order of operations
//     (SSE adds and multiplies, one rounding each; this file is built with
//     -ffp-contract=off); RCT / ICT (mct.c), the DC level shift with
//     lrintf and the clamp (tcd.c), and the tile samples written as
//     opj_tcd_update_tile_data packs them.
//   - Pillow's unpackers (Jpeg2KDecode.c): precision shifts and signed
//     offsets into L, I;16, LA / PA, RGB, RGBA and CMYK pixels, sYCC
//     through Pillow's own YCbCr -> RGB tables, read from Pillow's tile
//     buffer as Pillow reads it (w / dx samples a row).
//
// C interface (ctypes): gpt_j2k_set_ycbcr and gpt_j2k_set_ht_tables take
// Pillow's YCbCr tables and OpenJPEG's HT VLC tables; gpt_j2k_info reads
// the main header; gpt_j2k_decode decodes every tile into Pillow's image.
// Both return 0, or -1 with a message where OpenJPEG or Pillow fails.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { kBroken = -1 };

struct Error {
  int code;
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg, int code = kBroken) {
  throw Error{code, msg};
}

// --- marker codes and decoder states (j2k.h) --------------------------------

enum : uint32_t {
  M_SOC = 0xff4f, M_SOT = 0xff90, M_SOD = 0xff93, M_EOC = 0xffd9,
  M_CAP = 0xff50, M_SIZ = 0xff51, M_COD = 0xff52, M_COC = 0xff53,
  M_CPF = 0xff59, M_TLM = 0xff55, M_PLM = 0xff57, M_PLT = 0xff58,
  M_QCD = 0xff5c, M_QCC = 0xff5d, M_RGN = 0xff5e, M_POC = 0xff5f,
  M_PPM = 0xff60, M_PPT = 0xff61, M_CRG = 0xff63, M_COM = 0xff64,
  M_CBD = 0xff78, M_MCC = 0xff75, M_MCT = 0xff74, M_MCO = 0xff77,
  M_SOP = 0xff91, M_UNK = 0
};

enum : uint32_t {
  S_MHSOC = 1, S_MHSIZ = 2, S_MH = 4, S_TPHSOT = 8, S_TPH = 16,
  S_NEOC = 64, S_DATA = 128, S_EOC = 256
};

// The handler table: the states in which a marker may appear (0 for SOP).
// Markers missing from it (SOC, SOD, EOC among them) are "unknown".
struct Handler {
  uint32_t id, states;
};

const Handler kHandlers[] = {
    {M_SOT, S_MH | S_TPHSOT}, {M_COD, S_MH | S_TPH}, {M_COC, S_MH | S_TPH},
    {M_RGN, S_MH | S_TPH},    {M_QCD, S_MH | S_TPH}, {M_QCC, S_MH | S_TPH},
    {M_POC, S_MH | S_TPH},    {M_SIZ, S_MHSIZ},      {M_TLM, S_MH},
    {M_PLM, S_MH},            {M_PLT, S_TPH},        {M_PPM, S_MH},
    {M_PPT, S_TPH},           {M_SOP, 0},            {M_CRG, S_MH},
    {M_COM, S_MH | S_TPH},    {M_MCT, S_MH | S_TPH}, {M_CBD, S_MH},
    {M_CAP, S_MH},            {M_CPF, S_MH},         {M_MCC, S_MH | S_TPH},
    {M_MCO, S_MH | S_TPH}};

Handler handler(uint32_t id) {
  for (const Handler& h : kHandlers)
    if (h.id == id) return h;
  return {M_UNK, S_MH | S_TPH};
}

// --- the stream (cio.c): reads stop at the end of the file -------------------

struct Stream {
  const uint8_t* d;
  int64_t n, pos;
  int64_t left() const { return n - pos; }
  // opj_stream_read_data: as many of k bytes as there are.
  int64_t read(int64_t k, const uint8_t** at) {
    int64_t m = k < left() ? k : left();
    if (m < 0) m = 0;
    *at = d + pos;
    pos += m;
    return m;
  }
  bool read2(uint32_t* v) {
    const uint8_t* p;
    if (read(2, &p) != 2) return false;
    *v = uint32_t(p[0]) << 8 | p[1];
    return true;
  }
};

uint32_t be(const uint8_t* p, int k) {
  uint32_t v = 0;
  for (int i = 0; i < k; ++i) v = v << 8 | p[i];
  return v;
}

// --- coding parameters (opj_tcp_t, opj_tccp_t) -------------------------------

const int kMaxRes = 33, kMaxBands = 3 * kMaxRes - 2;

struct StepSize {
  int32_t expn = 0, mant = 0;
};

struct TCCP {
  uint32_t csty = 0, numresolutions = 0, cblkw = 0, cblkh = 0, cblksty = 0;
  uint32_t qmfbid = 0, qntsty = 0, numgbits = 0;
  int32_t roishift = 0, dc_level_shift = 0;
  StepSize steps[kMaxBands];
  uint32_t prcw[kMaxRes] = {}, prch[kMaxRes] = {};
};

struct POC {
  uint32_t resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0;
  int32_t prg = 0;
};

const int32_t kProgUnknown = -1;

// Part 2's component transform records (opj_mct_data_t and
// opj_simple_mcc_decorrelation_data_t): an MCC names its records by their
// place in `mcts`, -1 for none.
struct MctRec {
  uint32_t index = 0, elem = 0;
  std::vector<uint8_t> data;
};

struct MccRec {
  uint32_t index = 0, nb_comps = 0;
  int32_t deco = -1, offs = -1;
};

struct TCP {
  uint32_t csty = 0, numlayers = 0, mct = 0;
  int32_t prg = 0;
  bool cod = false, has_poc = false;
  uint32_t numpocs = 0;
  POC pocs[32];
  std::vector<TCCP> tccps;
  int32_t cur_part = -1;
  uint32_t nb_parts = 0;
  bool has_data = false;
  std::vector<uint8_t> data;
  // PPT: the marker segments by Zppt, then their bytes merged.
  bool ppt = false, ppt_merged = false;
  std::vector<std::vector<uint8_t>> ppt_markers;
  std::vector<bool> ppt_have;
  std::vector<uint8_t> ppt_data;
  uint32_t ppt_pos = 0, ppt_len = 0;
  // MCT, MCC: the records read so far. `mcc_spare` is the slot past the
  // last MCC: an MCC OpenJPEG stops reading with a warning leaves its
  // fields there, and the next new MCC starts from them.
  std::vector<MctRec> mcts;
  std::vector<MccRec> mccs;
  MccRec mcc_spare;
};

struct Comp {
  uint32_t dx = 0, dy = 0, prec = 0, sgnd = 0, resno_decoded = 0;
};

int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t ceildivpow2(int64_t a, uint32_t b) {
  return (a + (int64_t(1) << b) - 1) >> b;
}
int64_t floordivpow2(int64_t a, uint32_t b) { return a >> b; }
uint32_t uadds(uint32_t a, uint32_t b) {
  uint64_t s = uint64_t(a) + b;
  return s > 0xffffffffu ? 0xffffffffu : uint32_t(s);
}

// --- tag trees (tgt.c) and the packet header bit reader (bio.c) --------------

struct TagTree {
  std::vector<int32_t> value, low, parent;
  void create(uint32_t w, uint32_t h) {
    std::vector<uint32_t> lw{w}, lh{h};
    uint32_t n = 0, total = 0;
    do {
      n = lw.back() * lh.back();
      total += n;
      uint32_t nw = (lw.back() + 1) / 2, nh = (lh.back() + 1) / 2;
      if (n <= 1) break;
      lw.push_back(nw);
      lh.push_back(nh);
    } while (true);
    value.assign(total, 999);
    low.assign(total, 0);
    parent.assign(total, -1);
    uint32_t base = 0;
    for (size_t l = 0; l + 1 < lw.size(); ++l) {
      uint32_t next = base + lw[l] * lh[l];
      for (uint32_t y = 0; y < lh[l]; ++y)
        for (uint32_t x = 0; x < lw[l]; ++x)
          parent[base + y * lw[l] + x] =
              int32_t(next + (y / 2) * lw[l + 1] + x / 2);
      base = next;
    }
  }
  void reset() {
    std::fill(value.begin(), value.end(), 999);
    std::fill(low.begin(), low.end(), 0);
  }
};

struct Bio {
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0, ct = 0;
  Bio(const uint8_t* p, uint32_t len) : start(p), bp(p), end(p + len) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp >= end) return;
    buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(uint32_t n) {
    uint32_t v = 0;
    for (uint32_t i = n - 1; i < n; --i) v |= bit() << i;
    return v;
  }
  // opj_bio_inalign: false where a header ends on 0xFF and its stuffed
  // byte lies past the end (OpenJPEG checks bytein's result only here).
  bool inalign() {
    if ((buf & 0xff) == 0xff) {
      bool more = bp < end;
      bytein();
      if (!more) return false;
    }
    ct = 0;
    return true;
  }
  int64_t numbytes() const { return bp - start; }
};

uint32_t tgt_decode(Bio& bio, TagTree& t, uint32_t leaf, int32_t threshold) {
  int32_t stk[64];
  int sp = 0;
  int32_t node = int32_t(leaf);
  while (t.parent[node] >= 0) {
    stk[sp++] = node;
    node = t.parent[node];
  }
  int32_t low = 0;
  for (;;) {
    if (low > t.low[node])
      t.low[node] = low;
    else
      low = t.low[node];
    while (low < threshold && low < t.value[node]) {
      if (bio.read(1))
        t.value[node] = low;
      else
        ++low;
    }
    t.low[node] = low;
    if (sp == 0) break;
    node = stk[--sp];
  }
  return t.value[node] < threshold ? 1 : 0;
}

// --- tile geometry (tcd.c) ---------------------------------------------------

struct Seg {
  uint32_t len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0;
  uint32_t numnewpasses = 0, newlen = 0;
};

struct Cblk {
  int32_t x0, y0, x1, y1;
  uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0;
  uint32_t real_num_segs = 0, mb = 0;
  std::vector<Seg> segs;
  std::vector<std::pair<uint32_t, uint32_t>> chunks;  // (offset, length)
};

struct Prec {
  int32_t x0, y0, x1, y1;
  uint32_t cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int32_t x0, y0, x1, y1;
  uint32_t bandno = 0;
  float stepsize = 0;
  int32_t numbps = 0;
  std::vector<Prec> precs;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
  int32_t x0, y0, x1, y1;
  uint32_t pw = 0, ph = 0, numbands = 0;
  Band bands[3];
};

struct TileComp {
  int32_t x0, y0, x1, y1;
  uint32_t numres = 0;
  std::vector<Res> res;
  std::vector<int32_t> data;
};

// --- the MQ and raw decoders (mqc.c, mqc_inl.h) ------------------------------

struct MQState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

const MQState kMQ[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0ac1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1c01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1c01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0ac1, 31, 28, 0}, {0x09c1, 32, 29, 0}, {0x08a1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02a1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

// Context numbers (t1.h): ZC 0-8, SC 9-13, MAG 14-16, AGG 17, UNI 18.
enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18,
       NUM_CTX = 19 };

struct MQ {
  const uint8_t* bp;
  uint32_t a = 0, c = 0, ct = 0;
  uint8_t state[NUM_CTX], mps[NUM_CTX];
  void reset_states() {
    memset(state, 0, sizeof state);
    memset(mps, 0, sizeof mps);
    state[CTX_UNI] = 46;
    state[CTX_AGG] = 3;
    state[CTX_ZC] = 4;
  }
  // `p` holds the segment and then the synthetic FF FF.
  void bytein() {
    uint32_t next = bp[1];
    if (*bp == 0xff) {
      if (next > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        ++bp;
        c += next << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += next << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* p, uint32_t len) {
    bp = p;
    c = len == 0 ? 0xffu << 16 : uint32_t(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void raw_init(const uint8_t* p) {
    bp = p;
    c = 0;
    ct = 0;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  uint32_t decode(int cx) {
    const MQState& s = kMQ[state[cx]];
    uint32_t d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        a = s.qe;
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        a = s.qe;
        d = !mps[cx];
        if (s.sw) mps[cx] = !mps[cx];
        state[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= uint32_t(s.qe) << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          d = !mps[cx];
          if (s.sw) mps[cx] = !mps[cx];
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  uint32_t raw() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
};

// --- tier 1 (t1.c) -----------------------------------------------------------

enum : uint32_t {
  CBLK_LAZY = 0x01, CBLK_RESET = 0x02, CBLK_TERMALL = 0x04, CBLK_VSC = 0x08,
  CBLK_PTERM = 0x10, CBLK_SEGSYM = 0x20, CBLK_HT = 0x40
};

// Per coefficient, the significance of its eight neighbours and the signs
// of the four it shares an edge with.
enum : uint16_t {
  NB_NW = 1, NB_N = 2, NB_NE = 4, NB_W = 8, NB_E = 16, NB_SW = 32, NB_S = 64,
  NB_SE = 128, NEG_N = 256, NEG_S = 512, NEG_W = 1024, NEG_E = 2048
};

struct T1Luts {
  uint8_t zc[4][256];      // the zero coding context by orientation
  uint8_t sc[256];         // the sign context | XOR bit << 7, by N S W E
  T1Luts() {
    for (int o = 0; o < 4; ++o)
      for (int f = 0; f < 256; ++f) {
        int hh = !!(f & NB_W) + !!(f & NB_E);
        int vv = !!(f & NB_N) + !!(f & NB_S);
        int dd = !!(f & NB_NW) + !!(f & NB_NE) + !!(f & NB_SW) + !!(f & NB_SE);
        int n;
        if (o == 3) {
          int hv = hh + vv;
          if (!dd)
            n = !hv ? 0 : hv == 1 ? 1 : 2;
          else if (dd == 1)
            n = !hv ? 3 : hv == 1 ? 4 : 5;
          else if (dd == 2)
            n = !hv ? 6 : 7;
          else
            n = 8;
        } else {
          if (o == 1) std::swap(hh, vv);
          if (!hh) {
            if (!vv)
              n = !dd ? 0 : dd == 1 ? 1 : 2;
            else
              n = vv == 1 ? 3 : 4;
          } else if (hh == 1) {
            n = vv ? 7 : (dd ? 6 : 5);
          } else {
            n = 8;
          }
        }
        zc[o][f] = uint8_t(CTX_ZC + n);
      }
    // Table D.3 over (N, S, W, E) significance and signs.
    static const int ctx[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
    static const int xr[3][3] = {{1, 1, 1}, {1, 0, 0}, {0, 0, 0}};
    for (int f = 0; f < 256; ++f) {
      auto c = [&](int sig, int neg) { return (f & sig) ? ((f & neg) ? -1 : 1)
                                                        : 0; };
      int hc = c(1, 16) + c(2, 32), vc = c(4, 64) + c(8, 128);
      hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
      vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
      sc[f] = uint8_t(ctx[hc + 1][vc + 1] | xr[hc + 1][vc + 1] << 7);
    }
  }
};

const T1Luts kT1;

struct T1 {
  uint32_t w = 0, h = 0;
  bool vsc = false;
  std::vector<int32_t> data;
  // Per coefficient, on a grid with a one-coefficient border: the
  // neighbour bits (NB_*, NEG_*) and its own state.
  enum : uint32_t { SIG = 1u << 12, PI = 1u << 13, MU = 1u << 14 };
  std::vector<uint32_t> nb;
  MQ mq;
  int orient = 0;

  size_t at(uint32_t x, uint32_t y) const {
    return size_t(y + 1) * (w + 2) + (x + 1);
  }
  int zc(size_t i) const { return kT1.zc[orient][nb[i] & 0xff]; }
  // The sign context and its XOR bit (Table D.3).
  int sc(size_t i, uint32_t* xorbit) const {
    uint16_t f = nb[i];
    int k = (f & NB_W ? 1 : 0) | (f & NB_E ? 2 : 0) | (f & NB_N ? 4 : 0) |
            (f & NB_S ? 8 : 0) | (f & NEG_W ? 16 : 0) | (f & NEG_E ? 32 : 0) |
            (f & NEG_N ? 64 : 0) | (f & NEG_S ? 128 : 0);
    *xorbit = kT1.sc[k] >> 7;
    return kT1.sc[k] & 0x7f;
  }
  int mag(size_t i) const {
    if (nb[i] & MU) return CTX_MAG + 2;
    return (nb[i] & 0xff) ? CTX_MAG + 1 : CTX_MAG;
  }
  // A coefficient turns significant: its neighbours learn it. Under
  // vertically causal contexts the last row of a stripe does not see the
  // next stripe.
  void set_sig(uint32_t x, uint32_t y, uint32_t negative) {
    size_t i = at(x, y), s = w + 2;
    nb[i] |= SIG;
    if (!(vsc && (y & 3) == 0)) {
      nb[i - s - 1] |= NB_SE;
      nb[i - s] |= NB_S | (negative ? NEG_S : 0);
      nb[i - s + 1] |= NB_SW;
    }
    nb[i + s - 1] |= NB_NE;
    nb[i + s] |= NB_N | (negative ? NEG_N : 0);
    nb[i + s + 1] |= NB_NW;
    nb[i - 1] |= NB_E | (negative ? NEG_E : 0);
    nb[i + 1] |= NB_W | (negative ? NEG_W : 0);
  }

  // Stripes of four rows, column by column; `fn(x, y, i)`.
  template <class F>
  void scan(F fn) {
    for (uint32_t k = 0; k < h; k += 4) {
      uint32_t ke = k + 4 < h ? k + 4 : h;
      for (uint32_t x = 0; x < w; ++x)
        for (uint32_t y = k; y < ke; ++y) fn(x, y, at(x, y));
    }
  }

  void sigpass(int32_t bpno, bool raw) {
    int32_t one = int32_t(1u << bpno), half = one >> 1;
    int32_t oph = one | half;
    scan([&](uint32_t x, uint32_t y, size_t i) {
      uint32_t f = nb[i];
      if ((f & (SIG | PI)) || !(f & 0xff)) return;
      uint32_t v;
      if (raw) {
        if (mq.raw()) {
          v = mq.raw();
          data[y * w + x] = v ? -oph : oph;
          set_sig(x, y, v);
        }
      } else {
        if (mq.decode(zc(i))) {
          uint32_t xb;
          int cx = sc(i, &xb);
          v = mq.decode(cx) ^ xb;
          data[y * w + x] = v ? -oph : oph;
          set_sig(x, y, v);
        }
      }
      nb[i] |= PI;
    });
  }

  void refpass(int32_t bpno, bool raw) {
    int32_t one = int32_t(1u << bpno), poshalf = one >> 1;
    scan([&](uint32_t x, uint32_t y, size_t i) {
      if ((nb[i] & (SIG | PI)) != SIG) return;
      uint32_t v = raw ? mq.raw() : mq.decode(mag(i));
      int32_t& d = data[y * w + x];
      d += (v ^ (d < 0)) ? poshalf : -poshalf;
      nb[i] |= MU;
    });
  }

  void clnpass(int32_t bpno, uint32_t cblksty) {
    int32_t one = int32_t(1u << bpno), half = one >> 1;
    int32_t oph = one | half;
    auto step = [&](uint32_t x, uint32_t y, bool partial) {
      size_t i = at(x, y);
      if (!partial && !mq.decode(zc(i))) return;
      uint32_t xb;
      int cx = sc(i, &xb);
      uint32_t v = mq.decode(cx) ^ xb;
      data[y * w + x] = v ? -oph : oph;
      set_sig(x, y, v);
    };
    size_t s = w + 2;
    uint32_t k = 0;
    for (; k + 4 <= h; k += 4) {
      for (uint32_t x = 0; x < w; ++x) {
        size_t i0 = at(x, k);
        bool run = true;
        for (uint32_t r = 0; r < 4 && run; ++r) {
          size_t i = i0 + r * s;
          run = !(nb[i] & (SIG | PI | 0xff));
        }
        if (run) {
          if (!mq.decode(CTX_AGG)) continue;
          uint32_t r = mq.decode(CTX_UNI);
          r = (r << 1) | mq.decode(CTX_UNI);
          step(x, k + r, true);
          for (uint32_t y = k + r + 1; y < k + 4; ++y) step(x, y, false);
        } else {
          for (uint32_t r = 0; r < 4; ++r) {
            size_t i = i0 + r * s;
            if (!(nb[i] & (SIG | PI))) step(x, k + r, false);
          }
        }
        for (uint32_t r = 0; r < 4; ++r) nb[i0 + r * s] &= ~uint32_t(PI);
      }
    }
    if (k < h) {
      for (uint32_t x = 0; x < w; ++x) {
        for (uint32_t y = k; y < h; ++y) {
          size_t i = at(x, y);
          if (!(nb[i] & (SIG | PI))) step(x, y, false);
        }
        for (uint32_t y = k; y < h; ++y) nb[at(x, y)] &= ~uint32_t(PI);
      }
    }
    if (cblksty & CBLK_SEGSYM) {
      for (int i = 0; i < 4; ++i) mq.decode(CTX_UNI);
    }
  }
};

// opj_t1_decode_cblk: the code-block's segments over `tile` (the tile's data,
// with room for the synthetic marker), its values into t1.data.
void decode_cblk(T1& t1, const Cblk& cb, const std::vector<uint8_t>& tile,
                 uint32_t orient, uint32_t roishift, uint32_t cblksty) {
  t1.w = uint32_t(cb.x1 - cb.x0);
  t1.h = uint32_t(cb.y1 - cb.y0);
  t1.vsc = (cblksty & CBLK_VSC) != 0;
  t1.orient = int(orient);
  size_t n = size_t(t1.w) * t1.h, g = size_t(t1.w + 2) * (t1.h + 2);
  t1.data.assign(n, 0);
  t1.nb.assign(g, 0);
  int32_t bpno_plus_one = int32_t(roishift + cb.numbps);
  if (bpno_plus_one >= 31) fail("unsupported bpno_plus_one >= 31");
  int passtype = 2;
  t1.mq.reset_states();
  std::vector<uint8_t> buf;
  for (const auto& ch : cb.chunks)
    buf.insert(buf.end(), tile.begin() + ch.first,
               tile.begin() + ch.first + ch.second);
  buf.resize(buf.size() + 4, 0);
  uint32_t index = 0;
  for (uint32_t segno = 0; segno < cb.real_num_segs; ++segno) {
    const Seg& seg = cb.segs[segno];
    bool raw = bpno_plus_one <= int32_t(cb.numbps) - 4 && passtype < 2 &&
               (cblksty & CBLK_LAZY);
    // The synthetic FF FF after the segment; the bytes it covers come back
    // once the segment is done.
    uint8_t keep[2] = {buf[index + seg.len], buf[index + seg.len + 1]};
    buf[index + seg.len] = 0xff;
    buf[index + seg.len + 1] = 0xff;
    if (raw)
      t1.mq.raw_init(buf.data() + index);
    else
      t1.mq.init(buf.data() + index, seg.len);
    for (uint32_t passno = 0;
         passno < seg.real_num_passes && bpno_plus_one >= 1; ++passno) {
      if (passtype == 0)
        t1.sigpass(bpno_plus_one, raw);
      else if (passtype == 1)
        t1.refpass(bpno_plus_one, raw);
      else
        t1.clnpass(bpno_plus_one, cblksty);
      if ((cblksty & CBLK_RESET) && !raw) t1.mq.reset_states();
      if (++passtype == 3) {
        passtype = 0;
        --bpno_plus_one;
      }
    }
    buf[index + seg.len] = keep[0];
    buf[index + seg.len + 1] = keep[1];
    index += seg.len;
  }
}

// --- HTJ2K code-blocks (ht_dec.c, opj_t1_ht_decode_cblk) --------------------
//
// The cleanup pass (MEL, VLC with the two context tables and the UVLC,
// MagSgn) and the SigProp and MagRef passes below it, read as OpenJPEG
// reads them: its bit readers (4 bytes at a time after a first 1-4 bytes
// that depend on the data's address modulo 4, with their unstuffing), its
// scan order, and its checks. The VLC tables (vlc_tbl0 for the first quad
// row, vlc_tbl1 for the others) come in through gpt_j2k_set_ht_tables.

uint16_t gVlc0[1024], gVlc1[1024];

inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

// The decoder's pointers as offsets into the code-block's bytes, with the
// address's residue modulo 4 (`base`) that sets how many bytes the first
// reads take.
struct HtMel {
  const uint8_t* d;
  int64_t pos;
  uint64_t tmp = 0;
  int bits = 0, size = 0, k = 0, num_runs = 0;
  bool unstuff = false;
  uint64_t runs = 0;

  bool init(const uint8_t* data, int lcup, int scup, uint32_t base) {
    d = data;
    pos = lcup - scup;
    size = scup - 1;
    int num = 4 - int((base + uint32_t(pos)) & 3);
    for (int i = 0; i < num; ++i) {
      if (unstuff && d[pos] > 0x8F) return false;
      uint64_t v = size > 0 ? d[pos] : 0xFF;
      if (size == 1) v |= 0xF;
      pos += size-- > 0;
      int d_bits = 8 - unstuff;
      tmp = (tmp << d_bits) | v;
      bits += d_bits;
      unstuff = (v & 0xFF) == 0xFF;
    }
    tmp <<= (64 - bits);
    return true;
  }
  void read() {
    if (bits > 32) return;
    uint32_t val = 0xFFFFFFFFu;
    if (size > 4) {
      val = le32(d + pos);
      pos += 4;
      size -= 4;
    } else if (size > 0) {
      int i = 0;
      while (size > 1) {
        uint32_t v = d[pos++];
        uint32_t m = ~(0xFFu << i);
        val = (val & m) | (v << i);
        --size;
        i += 8;
      }
      uint32_t v = d[pos++];
      v |= 0xF;
      uint32_t m = ~(0xFFu << i);
      val = (val & m) | (v << i);
      --size;
    }
    int nb = 32 - unstuff;
    uint32_t t = val & 0xFF;
    bool us = (val & 0xFF) == 0xFF;
    nb -= us;
    t <<= (8 - us);
    t |= (val >> 8) & 0xFF;
    us = ((val >> 8) & 0xFF) == 0xFF;
    nb -= us;
    t <<= (8 - us);
    t |= (val >> 16) & 0xFF;
    us = ((val >> 16) & 0xFF) == 0xFF;
    nb -= us;
    t <<= (8 - us);
    t |= (val >> 24) & 0xFF;
    unstuff = ((val >> 24) & 0xFF) == 0xFF;
    tmp |= uint64_t(t) << (64 - nb - bits);
    bits += nb;
  }
  void decode() {
    static const int kExp[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};
    if (bits < 6) read();
    while (bits >= 6 && num_runs < 8) {
      int eval = kExp[k];
      int run;
      if (tmp & (uint64_t(1) << 63)) {
        run = ((1 << eval) - 1) << 1;
        k = k + 1 < 12 ? k + 1 : 12;
        tmp <<= 1;
        bits -= 1;
      } else {
        run = int(tmp >> (63 - eval)) & ((1 << eval) - 1);
        k = k - 1 > 0 ? k - 1 : 0;
        tmp <<= eval + 1;
        bits -= eval + 1;
        run = (run << 1) + 1;
      }
      int at = num_runs * 7;
      runs &= ~(uint64_t(0x3F) << at);
      runs |= uint64_t(run) << at;
      ++num_runs;
    }
  }
  int get_run() {
    if (num_runs == 0) decode();
    int t = int(runs & 0x7F);
    runs >>= 7;
    --num_runs;
    return t;
  }
};

// VLC (rev_*) and MagRef (rev_*_mrp): backwards, unstuffing a 0x7F that
// follows a byte above 0x8F.
struct HtRev {
  const uint8_t* d;
  int64_t pos;
  uint64_t tmp = 0;
  uint32_t bits = 0;
  int size = 0;
  bool unstuff = false;

  void read() {
    if (bits > 32) return;
    uint32_t val = 0;
    if (size > 3) {
      val = le32(d + pos - 3);
      pos -= 4;
      size -= 4;
    } else if (size > 0) {
      int i = 24;
      while (size > 0) {
        uint32_t v = d[pos--];
        val |= v << i;
        --size;
        i -= 8;
      }
    }
    uint32_t t = val >> 24;
    uint32_t nb = 8u - ((unstuff && ((val >> 24) & 0x7F) == 0x7F) ? 1u : 0u);
    bool us = (val >> 24) > 0x8F;
    t |= ((val >> 16) & 0xFF) << nb;
    nb += 8u - ((us && ((val >> 16) & 0x7F) == 0x7F) ? 1u : 0u);
    us = ((val >> 16) & 0xFF) > 0x8F;
    t |= ((val >> 8) & 0xFF) << nb;
    nb += 8u - ((us && ((val >> 8) & 0x7F) == 0x7F) ? 1u : 0u);
    us = ((val >> 8) & 0xFF) > 0x8F;
    t |= (val & 0xFF) << nb;
    nb += 8u - ((us && (val & 0x7F) == 0x7F) ? 1u : 0u);
    us = (val & 0xFF) > 0x8F;
    tmp |= uint64_t(t) << bits;
    bits += nb;
    unstuff = us;
  }
  void init_vlc(const uint8_t* data, int lcup, int scup, uint32_t base) {
    d = data;
    pos = lcup - 2;
    size = scup - 2;
    uint32_t v = d[pos--];
    tmp = v >> 4;
    bits = 4 - ((tmp & 7) == 7);
    unstuff = (v | 0xF) > 0x8F;
    int num = 1 + int((base + uint32_t(pos)) & 3);
    int tnum = num < size ? num : size;
    for (int i = 0; i < tnum; ++i) {
      uint64_t b = d[pos--];
      uint32_t d_bits = 8u - ((unstuff && (b & 0x7F) == 0x7F) ? 1u : 0u);
      tmp |= b << bits;
      bits += d_bits;
      unstuff = b > 0x8F;
    }
    size -= tnum;
    read();
  }
  void init_mrp(const uint8_t* data, int lcup, int len2, uint32_t base) {
    d = data;
    pos = int64_t(lcup) + len2 - 1;
    size = len2;
    unstuff = true;
    int num = 1 + int((base + uint32_t(pos)) & 3);
    for (int i = 0; i < num; ++i) {
      uint64_t b = size-- > 0 ? d[pos--] : 0;
      uint32_t d_bits = 8u - ((unstuff && (b & 0x7F) == 0x7F) ? 1u : 0u);
      tmp |= b << bits;
      bits += d_bits;
      unstuff = b > 0x8F;
    }
    read();
  }
  uint32_t fetch() {
    if (bits < 32) {
      read();
      if (bits < 32) read();
    }
    return uint32_t(tmp);
  }
  uint32_t advance(uint32_t n) {
    tmp >>= n;
    bits -= n;
    return uint32_t(tmp);
  }
};

// MagSgn (X = 0xFF after the data) and SigProp (X = 0): forwards,
// unstuffing the bit after 0xFF.
struct HtFwd {
  const uint8_t* d;
  int64_t pos;
  uint64_t tmp = 0;
  uint32_t bits = 0, x = 0;
  bool unstuff = false;
  int size = 0;

  void read() {
    uint32_t val;
    if (size > 3) {
      val = le32(d + pos);
      pos += 4;
      size -= 4;
    } else if (size > 0) {
      int i = 0;
      val = x != 0 ? 0xFFFFFFFFu : 0;
      while (size > 0) {
        uint32_t v = d[pos++];
        uint32_t m = ~(0xFFu << i);
        val = (val & m) | (v << i);
        --size;
        i += 8;
      }
    } else {
      val = x != 0 ? 0xFFFFFFFFu : 0;
    }
    uint32_t nb = 8u - (unstuff ? 1u : 0u);
    uint32_t t = val & 0xFF;
    bool us = (val & 0xFF) == 0xFF;
    t |= ((val >> 8) & 0xFF) << nb;
    nb += 8u - (us ? 1u : 0u);
    us = ((val >> 8) & 0xFF) == 0xFF;
    t |= ((val >> 16) & 0xFF) << nb;
    nb += 8u - (us ? 1u : 0u);
    us = ((val >> 16) & 0xFF) == 0xFF;
    t |= ((val >> 24) & 0xFF) << nb;
    nb += 8u - (us ? 1u : 0u);
    unstuff = ((val >> 24) & 0xFF) == 0xFF;
    tmp |= uint64_t(t) << bits;
    bits += nb;
  }
  void init(const uint8_t* data, int64_t at, int sz, uint32_t fill,
            uint32_t base) {
    d = data;
    pos = at;
    size = sz;
    x = fill;
    int num = 4 - int((base + uint32_t(at)) & 3);
    for (int i = 0; i < num; ++i) {
      uint64_t b = size-- > 0 ? d[pos++] : x;
      tmp |= b << bits;
      bits += 8u - (unstuff ? 1u : 0u);
      unstuff = (b & 0xFF) == 0xFF;
    }
    read();
  }
  uint32_t fetch() {
    if (bits < 32) {
      read();
      if (bits < 32) read();
    }
    return uint32_t(tmp);
  }
  void advance(uint32_t n) {
    tmp >>= n;
    bits -= n;
  }
};

// decode_init_uvlc / decode_noninit_uvlc: u + 1 for both quads of a pair.
uint32_t uvlc(uint32_t vlc, uint32_t mode, bool initial, uint32_t* u) {
  static const uint8_t dec[8] = {
      3 | (5 << 2) | (5 << 5), 1 | (0 << 2) | (1 << 5),
      2 | (0 << 2) | (2 << 5), 1 | (0 << 2) | (1 << 5),
      3 | (1 << 2) | (3 << 5), 1 | (0 << 2) | (1 << 5),
      2 | (0 << 2) | (2 << 5), 1 | (0 << 2) | (1 << 5)};
  uint32_t consumed = 0;
  auto value = [&](uint32_t dd, uint32_t& v) {
    uint32_t suffix = (dd >> 2) & 7;
    consumed += suffix;
    uint32_t r = (dd >> 5) + (v & ((1u << suffix) - 1));
    v >>= suffix;
    return r;
  };
  if (mode == 0) {
    u[0] = u[1] = 1;
  } else if (mode <= 2) {
    uint32_t dd = dec[vlc & 7];
    vlc >>= dd & 3;
    consumed += dd & 3;
    uint32_t v = value(dd, vlc);
    u[0] = mode == 1 ? v + 1 : 1;
    u[1] = mode == 1 ? 1 : v + 1;
  } else if (mode == 3 && initial) {
    uint32_t d1 = dec[vlc & 7];
    vlc >>= d1 & 3;
    consumed += d1 & 3;
    if ((d1 & 3) > 2) {
      u[1] = (vlc & 1) + 1 + 1;
      ++consumed;
      vlc >>= 1;
      u[0] = value(d1, vlc) + 1;
    } else {
      uint32_t d2 = dec[vlc & 7];
      vlc >>= d2 & 3;
      consumed += d2 & 3;
      u[0] = value(d1, vlc) + 1;
      u[1] = value(d2, vlc) + 1;
    }
  } else if (mode == 3 || mode == 4) {
    uint32_t d1 = dec[vlc & 7];
    vlc >>= d1 & 3;
    consumed += d1 & 3;
    uint32_t d2 = dec[vlc & 7];
    vlc >>= d2 & 3;
    consumed += d2 & 3;
    uint32_t add = mode == 4 ? 3 : 1;
    u[0] = value(d1, vlc) + add;
    u[1] = value(d2, vlc) + add;
  }
  return consumed;
}

inline uint32_t clz32(uint32_t v) { return v ? __builtin_clz(v) : 32; }

// One code-block into `out` (w x h, OpenJPEG's sign-magnitude turned to
// two's complement). `data` holds its chunks back to back; `base` is the
// residue modulo 4 of the address OpenJPEG reads them at. Failures throw.
void ht_decode_cblk(const Cblk& cb, const uint8_t* data, uint32_t cblk_len,
                    uint32_t base, uint32_t roishift, uint32_t cblksty,
                    std::vector<int32_t>& out) {
  if (roishift != 0) fail("We do not support ROI in decoding HT codeblocks");
  const int32_t width = cb.x1 - cb.x0, height = cb.y1 - cb.y0;
  out.assign(size_t(width) * height, 0);
  if (cb.mb == 0 || cb.chunks.empty()) return;
  uint32_t zero_bplanes = (cb.mb + 1) - cb.numbps;
  uint32_t num_passes = cb.numsegs > 0 ? cb.segs[0].real_num_passes : 0;
  num_passes += cb.numsegs > 1 ? cb.segs[1].real_num_passes : 0;
  uint32_t lengths1 = num_passes > 0 ? cb.segs[0].len : 0;
  uint32_t lengths2 =
      num_passes > 1 ? (cb.segs.size() > 1 ? cb.segs[1].len : 0) : 0;
  const bool causal = (cblksty & CBLK_VSC) != 0;
  if (num_passes > 1 && lengths2 == 0) num_passes = 1;  // a warning
  if (num_passes > 3)
    fail("We do not support more than 3 coding passes in an HT codeblock");
  if (cb.mb > 30) fail("32 bits are not enough to decode this codeblock");
  if (zero_bplanes > cb.mb)
    fail("Malformed HT codeblock: more zero bitplanes than bitplanes");
  if (zero_bplanes == cb.mb && num_passes > 1) num_passes = 1;  // a warning
  const uint32_t p = cb.numbps, zero_bplanes_p1 = zero_bplanes + 1;
  if (lengths1 < 2 || lengths1 > cblk_len ||
      uint64_t(lengths1) + lengths2 > cblk_len)
    fail("Malformed HT codeblock. Invalid codeblock length values.");
  const int lcup = int(lengths1);
  const int scup = (int(data[lcup - 1]) << 4) + (data[lcup - 2] & 0xF);
  if (scup < 2 || scup > lcup || scup > 4079)
    fail("Malformed HT codeblock: 2 <= Scup <= min(Lcup, 4079) fails");
  HtMel mel;
  if (!mel.init(data, lcup, scup, base))
    fail("Malformed HT codeblock. Incorrect MEL segment sequence.");
  HtRev vlc, magref;
  vlc.init_vlc(data, lcup, scup, base);
  HtFwd magsgn, sigprop;
  magsgn.init(data, 0, lcup - scup, 0xFF, base);
  if (num_passes > 1)
    sigprop.init(data, lengths1, int(lengths2), 0, base);
  if (num_passes > 2) magref.init_mrp(data, lcup, int(lengths2), base);

  const int32_t stride = width;
  uint32_t* dd = reinterpret_cast<uint32_t*>(out.data());
  const size_t mstr = size_t((width + 7) >> 3) + 1;
  std::vector<uint32_t> sigbuf(4 * mstr + 8, 0);
  uint32_t *sigma1 = sigbuf.data(), *sigma2 = sigma1 + mstr;
  uint32_t *mbr1 = sigma2 + mstr, *mbr2 = mbr1 + mstr;
  std::vector<uint8_t> line_state(size_t(width) + 16, 0);
  uint8_t* lsp = line_state.data();
  uint32_t* sip = sigma1;
  uint32_t sip_shift = 0;

  // One sample of the MagSgn: `ek` / `e1` the EMB bits of sample n.
  auto sample = [&](uint32_t qinf, uint32_t U, int n, uint32_t* v_out) {
    uint32_t ms_val = magsgn.fetch();
    uint32_t m_n = U - ((qinf >> (12 + n)) & 1);
    magsgn.advance(m_n);
    uint32_t val = ms_val << 31;
    uint32_t v_n = ms_val & ((1u << m_n) - 1);
    v_n |= ((qinf >> (8 + n)) & 1) << m_n;
    v_n |= 1;
    *v_out = v_n;
    return val | ((v_n + 2) << (p - 1));
  };
  auto check_locs = [&](const uint32_t* qinf, uint32_t locs) {
    if ((((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs)
      fail("Malformed HT codeblock. VLC code produces significant samples "
           "outside the codeblock area.");
  };
  // The MagSgn of a quad pair at sp (rows sp[0], sp[stride]), line state
  // at lsp; `initial` zeroes the line state as the first quad row does.
  auto magsgn_pair = [&](const uint32_t* qinf, const uint32_t* U,
                         uint32_t locs, uint32_t* sp, uint8_t*& ls,
                         bool initial) {
    for (int q = 0; q < 2; ++q) {
      uint32_t v_n;
      int sh = 4 * q;
      if (qinf[q] & 0x10)
        sp[0] = sample(qinf[q], U[q], 0, &v_n);
      else if (locs & (0x1u << sh))
        sp[0] = 0;
      if (qinf[q] & 0x20) {
        sp[stride] = sample(qinf[q], U[q], 1, &v_n);
        uint32_t t = ls[0] & 0x7F;
        v_n = 32 - clz32(v_n);
        ls[0] = uint8_t(0x80 | (t > v_n ? t : v_n));
      } else if (locs & (0x2u << sh)) {
        sp[stride] = 0;
      }
      ++ls;
      ++sp;
      if (qinf[q] & 0x40)
        sp[0] = sample(qinf[q], U[q], 2, &v_n);
      else if (locs & (0x4u << sh))
        sp[0] = 0;
      if (initial) ls[0] = 0;
      if (qinf[q] & 0x80) {
        sp[stride] = sample(qinf[q], U[q], 3, &v_n);
        ls[0] = uint8_t(0x80 | (32 - clz32(v_n)));
      } else if (locs & (0x8u << sh)) {
        sp[stride] = 0;
      }
      ++sp;
    }
  };

  // the initial quad row
  lsp[0] = 0;
  int run = mel.get_run();
  uint32_t qinf[2] = {0, 0}, c_q = 0;
  uint32_t* sp = dd;
  uint8_t* ls = lsp;
  for (int32_t x = 0; x < width; x += 4) {
    uint32_t U_q[2];
    uint32_t vlc_val = vlc.fetch();
    qinf[0] = gVlc0[(c_q << 7) | (vlc_val & 0x7F)];
    if (c_q == 0) {
      run -= 2;
      qinf[0] = run == -1 ? qinf[0] : 0;
      if (run < 0) run = mel.get_run();
    }
    c_q = ((qinf[0] & 0x10) >> 4) | ((qinf[0] & 0xE0) >> 5);
    vlc_val = vlc.advance(qinf[0] & 7);
    *sip |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xC0) >> 2)) << sip_shift;
    qinf[1] = 0;
    if (x + 2 < width) {
      qinf[1] = gVlc0[(c_q << 7) | (vlc_val & 0x7F)];
      if (c_q == 0) {
        run -= 2;
        qinf[1] = run == -1 ? qinf[1] : 0;
        if (run < 0) run = mel.get_run();
      }
      c_q = ((qinf[1] & 0x10) >> 4) | ((qinf[1] & 0xE0) >> 5);
      vlc_val = vlc.advance(qinf[1] & 7);
    }
    *sip |= ((qinf[1] & 0x30) | ((qinf[1] & 0xC0) << 2)) << (4 + sip_shift);
    sip += x & 7 ? 1 : 0;
    sip_shift ^= 0x10;
    uint32_t mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
    if (mode == 3) {
      run -= 2;
      mode += run == -1 ? 1 : 0;
      if (run < 0) run = mel.get_run();
    }
    uint32_t consumed = uvlc(vlc_val, mode, true, U_q);
    if (U_q[0] > zero_bplanes_p1 || U_q[1] > zero_bplanes_p1)
      fail("Malformed HT codeblock. U_q is larger than zero bitplanes + 1");
    vlc_val = vlc.advance(consumed);
    uint32_t locs = 0xFF;
    if (x + 4 > width) locs >>= (x + 4 - width) << 1;
    locs = height > 1 ? locs : (locs & 0x55);
    check_locs(qinf, locs);
    magsgn_pair(qinf, U_q, locs, sp, ls, true);
    sp += 4;
  }

  // the other quad rows, with SigProp and MagRef a stripe behind
  auto mrp_stripe = [&](uint32_t* cur_sig, uint32_t* dpp) {
    uint32_t half = 1u << (p - 2);
    for (int32_t i = 0; i < width; i += 8) {
      uint32_t cwd = magref.fetch();
      uint32_t sig = *cur_sig++;
      uint32_t col_mask = 0xFu;
      uint32_t* dp = dpp + i;
      if (sig) {
        for (int j = 0; j < 8; ++j, ++dp) {
          if (sig & col_mask) {
            uint32_t sample_mask = 0x11111111u & col_mask;
            for (int r = 0; r < 4; ++r) {
              if (sig & sample_mask) {
                uint32_t sym = cwd & 1;
                dp[r * stride] ^= (1 - sym) << (p - 1);
                dp[r * stride] |= half;
                cwd >>= 1;
              }
              sample_mask += sample_mask;
            }
          }
          col_mask <<= 4;
        }
      }
      magref.advance(uint32_t(__builtin_popcount(sig)));
    }
  };
  auto mbr_stripe = [&](uint32_t* sig, uint32_t* mbr) {
    uint32_t prev = 0;
    for (int32_t i = 0; i < width; i += 8, ++mbr, ++sig) {
      mbr[0] = sig[0];
      mbr[0] |= prev >> 28;
      mbr[0] |= sig[0] << 4;
      mbr[0] |= sig[0] >> 4;
      mbr[0] |= sig[1] << 28;
      prev = sig[0];
      uint32_t t = mbr[0], z = mbr[0];
      z |= (t & 0x77777777u) << 1;
      z |= (t & 0xEEEEEEEEu) >> 1;
      mbr[0] = z & ~sig[0];
    }
  };
  auto from_next = [&](uint32_t* cur_sig, uint32_t* cur_mbr,
                       uint32_t* nxt_sig) {
    uint32_t prev = 0;
    for (int32_t i = 0; i < width;
         i += 8, ++cur_mbr, ++cur_sig, ++nxt_sig) {
      uint32_t t = nxt_sig[0];
      t |= prev >> 28;
      t |= nxt_sig[0] << 4;
      t |= nxt_sig[0] >> 4;
      t |= nxt_sig[1] << 28;
      prev = nxt_sig[0];
      if (!causal) cur_mbr[0] |= (t & 0x11111111u) << 3;
      cur_mbr[0] &= ~cur_sig[0];
    }
  };
  auto spp_stripe = [&](uint32_t* cur_sig, uint32_t* cur_mbr,
                        uint32_t* nxt_sig, uint32_t* nxt_mbr, int32_t row,
                        uint32_t pattern) {
    uint32_t val = 3u << (p - 2);
    for (int32_t i = 0; i < width;
         i += 8, ++cur_sig, ++cur_mbr, ++nxt_sig, ++nxt_mbr) {
      uint32_t mbr = *cur_mbr & pattern;
      uint32_t new_sig = 0;
      if (mbr) {
        for (int32_t n = 0; n < 8; n += 4) {
          uint32_t cwd = sigprop.fetch();
          uint32_t cnt = 0;
          uint32_t* dp = dd + size_t(row) * stride + i + n;
          uint32_t col_mask = 0xFu << (4 * n);
          uint32_t inv_sig = ~cur_sig[0] & pattern;
          int32_t end = n + 4 + i < width ? n + 4 : width - i;
          static const uint32_t prop[4] = {0x32u, 0x74u, 0xE8u, 0xC0u};
          for (int32_t j = n; j < end; ++j, ++dp, col_mask <<= 4) {
            if ((col_mask & mbr) == 0) continue;
            uint32_t sample_mask = 0x11111111u & col_mask;
            for (int r = 0; r < 4; ++r) {
              if (mbr & sample_mask) {
                if (cwd & 1) {
                  new_sig |= sample_mask;
                  uint32_t t = prop[r] << (j * 4);
                  mbr |= t & inv_sig;
                }
                cwd >>= 1;
                ++cnt;
              }
              sample_mask += sample_mask;
            }
          }
          if (new_sig & (0xFFFFu << (4 * n))) {
            uint32_t* dq = dd + size_t(row) * stride + i + n;
            uint32_t cm = 0xFu << (4 * n);
            for (int32_t j = n; j < end; ++j, ++dq, cm <<= 4) {
              if ((cm & new_sig) == 0) continue;
              uint32_t sample_mask = 0x11111111u & cm;
              for (int r = 0; r < 4; ++r) {
                if (new_sig & sample_mask) {
                  dq[r * stride] |= ((cwd & 1) << 31) | val;
                  cwd >>= 1;
                  ++cnt;
                }
                sample_mask += sample_mask;
              }
            }
          }
          sigprop.advance(cnt);
          if (n == 4) {
            uint32_t t = new_sig >> 28;
            t |= ((t & 0xE) >> 1) | ((t & 7) << 1);
            cur_mbr[1] |= t & ~cur_sig[1];
          }
        }
      }
      new_sig |= cur_sig[0];
      uint32_t ux = (new_sig & 0x88888888u) >> 3;
      uint32_t tx = ux | (ux << 4) | (ux >> 4);
      if (i > 0) nxt_mbr[-1] |= (ux << 28) & ~nxt_sig[-1];
      nxt_mbr[0] |= tx & ~nxt_sig[0];
      nxt_mbr[1] |= (ux >> 28) & ~nxt_sig[1];
    }
  };

  for (int32_t y = 2; y < height;) {
    sip_shift ^= 0x2;
    sip_shift &= 0xFFFFFFEFu;
    sip = y & 0x4 ? sigma2 : sigma1;
    ls = lsp;
    uint8_t ls0 = ls[0];
    ls[0] = 0;
    sp = dd + size_t(y) * stride;
    c_q = 0;
    for (int32_t x = 0; x < width; x += 4) {
      uint32_t U_q[2];
      c_q |= ls0 >> 7;
      c_q |= (ls[1] >> 5) & 0x4;
      uint32_t vlc_val = vlc.fetch();
      qinf[0] = gVlc1[(c_q << 7) | (vlc_val & 0x7F)];
      if (c_q == 0) {
        run -= 2;
        qinf[0] = run == -1 ? qinf[0] : 0;
        if (run < 0) run = mel.get_run();
      }
      c_q = ((qinf[0] & 0x40) >> 5) | ((qinf[0] & 0x80) >> 6);
      vlc_val = vlc.advance(qinf[0] & 7);
      *sip |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xC0) >> 2))
              << sip_shift;
      qinf[1] = 0;
      if (x + 2 < width) {
        c_q |= ls[1] >> 7;
        c_q |= (ls[2] >> 5) & 0x4;
        qinf[1] = gVlc1[(c_q << 7) | (vlc_val & 0x7F)];
        if (c_q == 0) {
          run -= 2;
          qinf[1] = run == -1 ? qinf[1] : 0;
          if (run < 0) run = mel.get_run();
        }
        c_q = ((qinf[1] & 0x40) >> 5) | ((qinf[1] & 0x80) >> 6);
        vlc_val = vlc.advance(qinf[1] & 7);
      }
      *sip |= ((qinf[1] & 0x30) | ((qinf[1] & 0xC0) << 2))
              << (4 + sip_shift);
      sip += x & 7 ? 1 : 0;
      sip_shift ^= 0x10;
      uint32_t mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
      uint32_t consumed = uvlc(vlc_val, mode, false, U_q);
      vlc_val = vlc.advance(consumed);
      if ((qinf[0] & 0xF0) & ((qinf[0] & 0xF0) - 1)) {
        uint32_t E = ls0 & 0x7Fu;
        E = E > (ls[1] & 0x7Fu) ? E : (ls[1] & 0x7Fu);
        U_q[0] += E > 2 ? E - 2 : 0;
      }
      if ((qinf[1] & 0xF0) & ((qinf[1] & 0xF0) - 1)) {
        uint32_t E = ls[1] & 0x7Fu;
        E = E > (ls[2] & 0x7Fu) ? E : (ls[2] & 0x7Fu);
        U_q[1] += E > 2 ? E - 2 : 0;
      }
      if (U_q[0] > zero_bplanes_p1 || U_q[1] > zero_bplanes_p1)
        fail("Malformed HT codeblock. U_q is larger than bitplanes + 1");
      ls0 = ls[2];
      ls[1] = ls[2] = 0;
      uint32_t locs = 0xFF;
      if (x + 4 > width) locs >>= (x + 4 - width) << 1;
      locs = y + 2 <= height ? locs : (locs & 0x55);
      check_locs(qinf, locs);
      magsgn_pair(qinf, U_q, locs, sp, ls, false);
      sp += 4;
    }
    y += 2;
    if (num_passes > 1 && (y & 3) == 0) {
      if (num_passes > 2)
        mrp_stripe(y & 0x4 ? sigma1 : sigma2, dd + size_t(y - 4) * stride);
      if (y >= 4)
        mbr_stripe(y & 0x4 ? sigma1 : sigma2, y & 0x4 ? mbr1 : mbr2);
      if (y >= 8) {
        uint32_t* cur_sig = y & 0x4 ? sigma2 : sigma1;
        uint32_t* cur_mbr = y & 0x4 ? mbr2 : mbr1;
        uint32_t* nxt_sig = y & 0x4 ? sigma1 : sigma2;
        uint32_t* nxt_mbr = y & 0x4 ? mbr1 : mbr2;
        from_next(cur_sig, cur_mbr, nxt_sig);
        spp_stripe(cur_sig, cur_mbr, nxt_sig, nxt_mbr, y - 8, 0xFFFFFFFFu);
        memset(cur_sig, 0, mstr * 4);
      }
    }
  }

  if (num_passes > 1) {
    if (num_passes > 2 && ((height & 3) == 1 || (height & 3) == 2))
      mrp_stripe(height & 0x4 ? sigma2 : sigma1,
                 dd + size_t(height & 0xFFFFFC) * stride);
    if ((height & 3) == 1 || (height & 3) == 2)
      mbr_stripe(height & 0x4 ? sigma2 : sigma1,
                 height & 0x4 ? mbr2 : mbr1);
    int32_t st = height;
    st -= height > 6 ? (((height + 1) & 3) + 3) : height;
    for (int32_t y = st; y < height; y += 4) {
      uint32_t pattern = 0xFFFFFFFFu;
      if (height - y == 3)
        pattern = 0x77777777u;
      else if (height - y == 2)
        pattern = 0x33333333u;
      else if (height - y == 1)
        pattern = 0x11111111u;
      uint32_t* cur_sig = y & 0x4 ? sigma2 : sigma1;
      uint32_t* cur_mbr = y & 0x4 ? mbr2 : mbr1;
      uint32_t* nxt_sig = y & 0x4 ? sigma1 : sigma2;
      uint32_t* nxt_mbr = y & 0x4 ? mbr1 : mbr2;
      if (height - y > 4) from_next(cur_sig, cur_mbr, nxt_sig);
      spp_stripe(cur_sig, cur_mbr, nxt_sig, nxt_mbr, y, pattern);
    }
  }

  for (size_t i = 0; i < out.size(); ++i) {
    uint32_t v = dd[i];
    int32_t m = int32_t(v & 0x7FFFFFFFu);
    out[i] = (v & 0x80000000u) ? -m : m;
  }
}

// --- the inverse wavelets (dwt.c) --------------------------------------------

inline int32_t wadd(int32_t a, int32_t b) {
  return int32_t(uint32_t(a) + uint32_t(b));
}
inline int32_t wsub(int32_t a, int32_t b) {
  return int32_t(uint32_t(a) - uint32_t(b));
}

// opj_idwt53_h / _v on one line: `in` holds the sn low then dn high
// coefficients, `out` gets the len samples.
void idwt53(const int32_t* in, int32_t sn, int32_t len, int cas,
            int32_t* out) {
  if (cas == 0) {
    if (len <= 1) {
      if (len == 1) out[0] = in[0];
      return;
    }
    const int32_t* ev = in;
    const int32_t* od = in + sn;
    int32_t i, j, d1c, d1n, s1n, s0c, s0n;
    s1n = ev[0];
    d1n = od[0];
    s0n = wsub(s1n, wadd(d1n, 1) >> 1);
    for (i = 0, j = 1; i < len - 3; i += 2, ++j) {
      d1c = d1n;
      s0c = s0n;
      s1n = ev[j];
      d1n = od[j];
      s0n = wsub(s1n, wadd(wadd(d1c, d1n), 2) >> 2);
      out[i] = s0c;
      out[i + 1] = wadd(d1c, wadd(s0c, s0n) >> 1);
    }
    out[i] = s0n;
    if (len & 1) {
      out[len - 1] = wsub(ev[(len - 1) / 2], wadd(d1n, 1) >> 1);
      out[len - 2] = wadd(d1n, wadd(s0n, out[len - 1]) >> 1);
    } else {
      out[len - 1] = wadd(d1n, s0n);
    }
    return;
  }
  if (len <= 1) {
    if (len == 1) out[0] = in[0] / 2;
    return;
  }
  const int32_t* ev = in + sn;  // the high band (even coordinates)
  const int32_t* od = in;       // the low band
  if (len == 2) {
    out[1] = wsub(od[0], wadd(ev[0], 1) >> 1);
    out[0] = wadd(ev[0], out[1]);
    return;
  }
  int32_t i, j, s1, s2, dc, dn;
  s1 = ev[1];
  dc = wsub(od[0], wadd(wadd(ev[0], s1), 2) >> 2);
  out[0] = wadd(ev[0], dc);
  for (i = 1, j = 1; i < len - 2 - !(len & 1); i += 2, ++j) {
    s2 = ev[j + 1];
    dn = wsub(od[j], wadd(wadd(s1, s2), 2) >> 2);
    out[i] = dc;
    out[i + 1] = wadd(s1, wadd(dn, dc) >> 1);
    dc = dn;
    s1 = s2;
  }
  out[i] = dc;
  if (!(len & 1)) {
    dn = wsub(od[len / 2 - 1], wadd(s1, 1) >> 1);
    out[len - 2] = wadd(s1, wadd(dn, dc) >> 1);
    out[len - 1] = dn;
  } else {
    out[len - 1] = wadd(s1, dc);
  }
}

const float kAlpha = -1.586134342f, kBeta = -0.052980118f;
const float kGamma = 0.882911075f, kDelta = 0.443506852f;
const float kK = 1.230174105f, kTwoInvK = 1.625732422f;

// opj_v8dwt_decode_step2 on one line of the interleaved signal `wv`:
// wv[a + 2i] += (wv[b + 2i - 1 ...]) per OpenJPEG's pointer walk.
void step2(float* l, float* w, uint32_t end, uint32_t m, float c) {
  // l: the first neighbour; w: the element after the one updated.
  uint32_t imax = end < m ? end : m;
  float* fl = l;
  float* fw = w;
  for (uint32_t i = 0; i < imax; ++i) {
    fw[-1] = fw[-1] + ((fl[0] + fw[0]) * c);
    fl = fw;
    fw += 2;
  }
  if (m < end) {
    float c2 = c + c;
    fw[-1] = fw[-1] + fw[-2] * c2;
  }
}

// opj_v8dwt_decode on one line: `wv` is the interleaved signal.
void idwt97(float* wv, int32_t sn, int32_t dn, int cas) {
  int a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0;
    b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1;
    b = 0;
  }
  for (int32_t i = 0; i < sn; ++i) wv[a + 2 * i] = wv[a + 2 * i] * kK;
  for (int32_t i = 0; i < dn; ++i) wv[b + 2 * i] = wv[b + 2 * i] * kTwoInvK;
  auto mn = [](int32_t x, int32_t y) { return uint32_t(x < y ? x : y); };
  step2(wv + b, wv + a + 1, uint32_t(sn), mn(sn, dn - a), -kDelta);
  step2(wv + a, wv + b + 1, uint32_t(dn), mn(dn, sn - b), -kGamma);
  step2(wv + b, wv + a + 1, uint32_t(sn), mn(sn, dn - a), -kBeta);
  step2(wv + a, wv + b + 1, uint32_t(dn), mn(dn, sn - b), -kAlpha);
}

// opj_dwt_decode_tile / opj_dwt_decode_tile_97: `numres` levels in place.
void dwt_decode(TileComp& tc, uint32_t numres, bool real) {
  if (numres <= 1) return;
  uint32_t w = uint32_t(tc.res[tc.numres - 1].x1 - tc.res[tc.numres - 1].x0);
  if (w == 0) return;
  int32_t* data = tc.data.data();
  const Res* tr = &tc.res[0];
  uint32_t rw = uint32_t(tr->x1 - tr->x0), rh = uint32_t(tr->y1 - tr->y0);
  std::vector<int32_t> line, out;
  std::vector<float> fl;
  while (--numres) {
    ++tr;
    int32_t hsn = int32_t(rw), vsn = int32_t(rh);
    rw = uint32_t(tr->x1 - tr->x0);
    rh = uint32_t(tr->y1 - tr->y0);
    int32_t hdn = int32_t(rw) - hsn, vdn = int32_t(rh) - vsn;
    int hcas = tr->x0 % 2, vcas = tr->y0 % 2;
    size_t n = rw > rh ? rw : rh;
    line.resize(n + 2);
    out.resize(n + 2);
    fl.resize(2 * n + 4);
    // Horizontal: every row of the new level.
    for (uint32_t j = 0; j < rh; ++j) {
      int32_t* row = data + size_t(j) * w;
      if (!real) {
        memcpy(line.data(), row, rw * sizeof(int32_t));
        idwt53(line.data(), hsn, int32_t(rw), hcas, out.data());
        if (rw) memcpy(row, out.data(), rw * sizeof(int32_t));
      } else {
        float* f = reinterpret_cast<float*>(row);
        for (int32_t i = 0; i < hsn; ++i) fl[hcas + 2 * i] = f[i];
        for (int32_t i = 0; i < hdn; ++i) fl[1 - hcas + 2 * i] = f[hsn + i];
        idwt97(fl.data(), hsn, hdn, hcas);
        for (uint32_t i = 0; i < rw; ++i) f[i] = fl[i];
      }
    }
    // Vertical: every column.
    for (uint32_t i = 0; i < rw; ++i) {
      if (!real) {
        for (uint32_t j = 0; j < rh; ++j) line[j] = data[size_t(j) * w + i];
        idwt53(line.data(), vsn, int32_t(rh), vcas, out.data());
        for (uint32_t j = 0; j < rh; ++j) data[size_t(j) * w + i] = out[j];
      } else {
        float* f = reinterpret_cast<float*>(data);
        for (int32_t j = 0; j < vsn; ++j)
          fl[vcas + 2 * j] = f[size_t(j) * w + i];
        for (int32_t j = 0; j < vdn; ++j)
          fl[1 - vcas + 2 * j] = f[size_t(vsn + j) * w + i];
        idwt97(fl.data(), vsn, vdn, vcas);
        for (uint32_t j = 0; j < rh; ++j) f[size_t(j) * w + i] = fl[j];
      }
    }
  }
}

// --- Pillow's YCbCr -> RGB (ConvertYCbCr.c), filled in by the caller ---------

int16_t gR_Cr[256], gG_Cb[256], gG_Cr[256], gB_Cb[256];

// --- the decoder -------------------------------------------------------------

struct Decoder {
  Stream s;
  uint32_t state = S_MHSOC;
  // SIZ
  uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0, tx0 = 0, ty0 = 0, tdx = 0, tdy = 0;
  uint32_t tw = 0, th = 0, numcomps = 0;
  std::vector<Comp> comps;
  uint32_t ihdr_w = 0, ihdr_h = 0;
  TCP deflt;
  std::vector<TCP> tcps;
  uint32_t cur_tile = 0;
  uint32_t sot_length = 0;
  bool last_tile_part = false, can_decode = false;
  // PPM: the marker segments by Zppm, then the packet headers merged.
  bool ppm = false;
  std::vector<std::vector<uint8_t>> ppm_markers;
  std::vector<bool> ppm_have;
  std::vector<uint8_t> ppm_data;
  uint32_t ppm_pos = 0, ppm_len = 0;

  TCP& tcp_here() { return state == S_TPH ? tcps[cur_tile] : deflt; }

  // --- main header markers ---
  void read_siz(const uint8_t* p, uint32_t size) {
    if (size < 36) fail("Error with SIZ marker size");
    uint32_t rem = size - 36;
    if (rem % 3 != 0) fail("Error with SIZ marker size");
    uint32_t nb = rem / 3;
    x1 = be(p + 2, 4);
    y1 = be(p + 6, 4);
    x0 = be(p + 10, 4);
    y0 = be(p + 14, 4);
    tdx = be(p + 18, 4);
    tdy = be(p + 22, 4);
    tx0 = be(p + 26, 4);
    ty0 = be(p + 30, 4);
    uint32_t csiz = be(p + 34, 2);
    if (csiz >= 16385)
      fail("Error with SIZ marker: illegal number of components");
    numcomps = csiz;
    if (numcomps != nb)
      fail("Error with SIZ marker: number of components is not compatible "
           "with the remaining number of parameters");
    if (x0 >= x1 || y0 >= y1)
      fail("Error with SIZ marker: negative or zero image size");
    if (tdx == 0 || tdy == 0) fail("Error with SIZ marker: invalid tile size");
    uint32_t ttx1 = uadds(tx0, tdx), tty1 = uadds(ty0, tdy);
    if (tx0 > x0 || ty0 > y0 || ttx1 <= x0 || tty1 <= y0)
      fail("Error with SIZ marker: illegal tile offset");
    if (ihdr_w > 0 && ihdr_h > 0 &&
        (ihdr_w != x1 - x0 || ihdr_h != y1 - y0))
      fail("Error with SIZ marker: IHDR w h vs. SIZ w h");
    comps.assign(numcomps, Comp());
    const uint8_t* q = p + 36;
    for (uint32_t i = 0; i < numcomps; ++i, q += 3) {
      comps[i].prec = (q[0] & 0x7f) + 1;
      comps[i].sgnd = q[0] >> 7;
      comps[i].dx = q[1];
      comps[i].dy = q[2];
      if (comps[i].dx < 1 || comps[i].dy < 1)
        fail("Invalid values for comp: dx, dy should be between 1 and 255");
      if (comps[i].prec > 31)
        fail("Invalid values for comp: prec (OpenJPEG supports up to 31)");
    }
    tw = uint32_t(ceildiv(int64_t(x1) - tx0, tdx));
    th = uint32_t(ceildiv(int64_t(y1) - ty0, tdy));
    if (tw == 0 || th == 0 || tw > 65535 / th)
      fail("Invalid number of tiles (maximum fixed by jpeg2000 norm is "
           "65535 tiles)");
    deflt = TCP();
    deflt.tccps.assign(numcomps, TCCP());
    for (uint32_t i = 0; i < numcomps; ++i)
      if (!comps[i].sgnd)
        deflt.tccps[i].dc_level_shift = int32_t(1u << (comps[i].prec - 1));
    state = S_MH;
  }

  void read_spcod_spcoc(uint32_t compno, const uint8_t*& p, uint32_t& size) {
    TCP& tcp = tcp_here();
    if (compno >= numcomps) fail("Error reading SPCod SPCoc element");
    TCCP& tc = tcp.tccps[compno];
    if (size < 5) fail("Error reading SPCod SPCoc element");
    tc.numresolutions = uint32_t(p[0]) + 1;
    if (tc.numresolutions > uint32_t(kMaxRes))
      fail("Invalid value for numresolutions");
    tc.cblkw = uint32_t(p[1]) + 2;
    tc.cblkh = uint32_t(p[2]) + 2;
    if (tc.cblkw > 10 || tc.cblkh > 10 || tc.cblkw + tc.cblkh > 12)
      fail("Error reading SPCod SPCoc element, Invalid cblkw/cblkh "
           "combination");
    tc.cblksty = p[3];
    if (tc.cblksty & 0x80)
      fail("Error reading SPCod SPCoc element, Invalid code-block style "
           "found");
    tc.qmfbid = p[4];
    if (tc.qmfbid > 1)
      fail("Error reading SPCod SPCoc element, Invalid transformation found");
    p += 5;
    size -= 5;
    if (tc.csty & 1) {
      if (size < tc.numresolutions) fail("Error reading SPCod SPCoc element");
      for (uint32_t i = 0; i < tc.numresolutions; ++i) {
        uint32_t t = p[i];
        if (i != 0 && ((t & 0xf) == 0 || (t >> 4) == 0))
          fail("Invalid precinct size");
        tc.prcw[i] = t & 0xf;
        tc.prch[i] = t >> 4;
      }
      p += tc.numresolutions;
      size -= tc.numresolutions;
    } else {
      for (uint32_t i = 0; i < tc.numresolutions; ++i) {
        tc.prcw[i] = 15;
        tc.prch[i] = 15;
      }
    }
  }

  void read_cod(const uint8_t* p, uint32_t size) {
    TCP& tcp = tcp_here();
    tcp.cod = true;
    if (size < 5) fail("Error reading COD marker");
    tcp.csty = p[0];
    if (tcp.csty & ~uint32_t(0x07)) fail("Unknown Scod value in COD marker");
    tcp.prg = p[1];
    if (tcp.prg > 4) tcp.prg = kProgUnknown;
    tcp.numlayers = be(p + 2, 2);
    if (tcp.numlayers < 1) fail("Invalid number of layers in COD marker");
    tcp.mct = p[4];
    if (tcp.mct > 1) fail("Invalid multiple component transformation");
    size -= 5;
    p += 5;
    for (uint32_t i = 0; i < numcomps; ++i) tcp.tccps[i].csty = tcp.csty & 1;
    read_spcod_spcoc(0, p, size);
    if (size != 0) fail("Error reading COD marker");
    // opj_j2k_copy_tile_component_parameters
    const TCCP& r = tcp.tccps[0];
    for (uint32_t i = 1; i < numcomps; ++i) {
      TCCP& t = tcp.tccps[i];
      t.numresolutions = r.numresolutions;
      t.cblkw = r.cblkw;
      t.cblkh = r.cblkh;
      t.cblksty = r.cblksty;
      t.qmfbid = r.qmfbid;
      memcpy(t.prcw, r.prcw, sizeof t.prcw);
      memcpy(t.prch, r.prch, sizeof t.prch);
    }
  }

  void read_coc(const uint8_t* p, uint32_t size) {
    TCP& tcp = tcp_here();
    uint32_t room = numcomps <= 256 ? 1 : 2;
    if (size < room + 1) fail("Error reading COC marker");
    size -= room + 1;
    uint32_t compno = be(p, int(room));
    p += room;
    if (compno >= numcomps)
      fail("Error reading COC marker (bad number of components)");
    tcp.tccps[compno].csty = *p++;
    read_spcod_spcoc(compno, p, size);
    if (size != 0) fail("Error reading COC marker");
  }

  void read_sqcd_sqcc(uint32_t compno, const uint8_t*& p, uint32_t& size) {
    TCP& tcp = tcp_here();
    if (compno >= numcomps) fail("Error reading SQcd or SQcc element");
    TCCP& tc = tcp.tccps[compno];
    if (size < 1) fail("Error reading SQcd or SQcc element");
    size -= 1;
    uint32_t t = *p++;
    tc.qntsty = t & 0x1f;
    tc.numgbits = t >> 5;
    uint32_t nband;
    if (tc.qntsty == 1)
      nband = 1;
    else
      nband = tc.qntsty == 0 ? size : size / 2;
    if (tc.qntsty == 0) {
      for (uint32_t b = 0; b < nband; ++b) {
        uint32_t v = *p++;
        if (b < uint32_t(kMaxBands)) {
          tc.steps[b].expn = int32_t(v >> 3);
          tc.steps[b].mant = 0;
        }
      }
      if (size < nband) fail("Error reading SQcd or SQcc element");
      size -= nband;
    } else {
      for (uint32_t b = 0; b < nband; ++b) {
        // A scalar derived segment of one byte reads past its end, as
        // OpenJPEG does, before it fails below.
        uint32_t v = size >= 2 * (b + 1) ? be(p, 2) : 0;
        p += 2;
        if (b < uint32_t(kMaxBands)) {
          tc.steps[b].expn = int32_t(v >> 11);
          tc.steps[b].mant = int32_t(v & 0x7ff);
        }
      }
      if (size < 2 * nband) fail("Error reading SQcd or SQcc element");
      size -= 2 * nband;
    }
    if (tc.qntsty == 1) {
      for (uint32_t b = 1; b < uint32_t(kMaxBands); ++b) {
        int32_t e = tc.steps[0].expn - int32_t((b - 1) / 3);
        tc.steps[b].expn = e > 0 ? e : 0;
        tc.steps[b].mant = tc.steps[0].mant;
      }
    }
  }

  void read_qcd(const uint8_t* p, uint32_t size) {
    read_sqcd_sqcc(0, p, size);
    if (size != 0) fail("Error reading QCD marker");
    TCP& tcp = tcp_here();
    for (uint32_t i = 1; i < numcomps; ++i) {
      tcp.tccps[i].qntsty = tcp.tccps[0].qntsty;
      tcp.tccps[i].numgbits = tcp.tccps[0].numgbits;
      memcpy(tcp.tccps[i].steps, tcp.tccps[0].steps, sizeof tcp.tccps[0].steps);
    }
  }

  void read_qcc(const uint8_t* p, uint32_t size) {
    uint32_t compno;
    if (numcomps <= 256) {
      if (size < 1) fail("Error reading QCC marker");
      compno = *p++;
      size -= 1;
    } else {
      if (size < 2) fail("Error reading QCC marker");
      compno = be(p, 2);
      p += 2;
      size -= 2;
    }
    if (compno >= numcomps) fail("Invalid component number in QCC");
    read_sqcd_sqcc(compno, p, size);
    if (size != 0) fail("Error reading QCC marker");
  }

  void read_rgn(const uint8_t* p, uint32_t size) {
    uint32_t room = numcomps <= 256 ? 1 : 2;
    if (size != 2 + room) fail("Error reading RGN marker");
    TCP& tcp = tcp_here();
    uint32_t compno = be(p, int(room));
    if (compno >= numcomps) fail("bad component number in RGN");
    tcp.tccps[compno].roishift = p[room + 1];
  }

  void read_poc(const uint8_t* p, uint32_t size) {
    uint32_t room = numcomps <= 256 ? 1 : 2;
    uint32_t chunk = 5 + 2 * room;
    uint32_t nb = size / chunk;
    if (nb == 0 || size % chunk != 0) fail("Error reading POC marker");
    TCP& tcp = tcp_here();
    uint32_t old = tcp.has_poc ? tcp.numpocs + 1 : 0;
    nb += old;
    if (nb >= 32) fail("Too many POCs");
    tcp.has_poc = true;
    for (uint32_t i = old; i < nb; ++i) {
      POC& c = tcp.pocs[i];
      c.resno0 = *p++;
      c.compno0 = be(p, int(room));
      p += room;
      c.layno1 = be(p, 2);
      c.layno1 = c.layno1 < tcp.numlayers ? c.layno1 : tcp.numlayers;
      p += 2;
      c.resno1 = *p++;
      c.compno1 = be(p, int(room));
      p += room;
      c.prg = *p++;
      c.compno1 = c.compno1 < numcomps ? c.compno1 : numcomps;
    }
    tcp.numpocs = nb - 1;
  }

  // TLM only serves OpenJPEG's seeks to a decode area: past its length
  // check, what it finds wrong is a warning.
  void read_tlm(uint32_t size) {
    if (size < 2) fail("Error reading TLM marker.");
  }

  void read_plt(const uint8_t* p, uint32_t size) {
    if (size < 1) fail("Error reading PLT marker");
    uint32_t len = 0;
    for (uint32_t i = 1; i < size; ++i) {
      len |= p[i] & 0x7f;
      if (p[i] & 0x80)
        len <<= 7;
      else
        len = 0;
    }
    if (len != 0) fail("Error reading PLT marker");
  }

  static void store(std::vector<std::vector<uint8_t>>& markers,
                    std::vector<bool>& have, const uint8_t* p,
                    uint32_t size, const char* again) {
    uint32_t z = p[0];
    if (markers.size() <= z) {
      markers.resize(z + 1);
      have.resize(z + 1, false);
    }
    if (have[z]) fail(again);
    have[z] = true;
    markers[z].assign(p + 1, p + size);
  }

  void read_ppm(const uint8_t* p, uint32_t size) {
    if (size < 2) fail("Error reading PPM marker");
    ppm = true;
    store(ppm_markers, ppm_have, p, size, "Zppm already read");
  }

  void read_ppt(const uint8_t* p, uint32_t size) {
    if (size < 2) fail("Error reading PPT marker");
    if (ppm)
      fail("Error reading PPT marker: packet header have been previously "
           "found in the main header (PPM marker).");
    TCP& tcp = tcps[cur_tile];
    tcp.ppt = true;
    store(tcp.ppt_markers, tcp.ppt_have, p, size, "Zppt already read");
  }

  // opj_j2k_merge_ppm: the Nppm-prefixed runs of every PPM segment in Zppm
  // order, as one stream of packet headers.
  void merge_ppm() {
    if (!ppm) return;
    uint32_t total = 0, remaining = 0;
    std::vector<uint8_t> out;
    for (size_t i = 0; i < ppm_markers.size(); ++i) {
      if (!ppm_have[i]) continue;
      const uint8_t* d = ppm_markers[i].data();
      uint32_t n = uint32_t(ppm_markers[i].size());
      if (remaining >= n) {
        out.insert(out.end(), d, d + n);
        remaining -= n;
        n = 0;
      } else {
        out.insert(out.end(), d, d + remaining);
        d += remaining;
        n -= remaining;
        remaining = 0;
      }
      while (n > 0) {
        if (n < 4) fail("Not enough bytes to read Nppm");
        uint32_t nppm = be(d, 4);
        d += 4;
        n -= 4;
        if (total > 0xffffffffu - nppm) fail("Too large value for Nppm");
        total += nppm;
        if (n >= nppm) {
          out.insert(out.end(), d, d + nppm);
          n -= nppm;
          d += nppm;
        } else {
          out.insert(out.end(), d, d + n);
          remaining = nppm - n;
          n = 0;
        }
      }
    }
    if (remaining != 0) fail("Corrupted PPM markers");
    ppm_data = std::move(out);
    ppm_len = uint32_t(ppm_data.size());
    ppm_markers.clear();
  }

  // opj_j2k_merge_ppt
  void merge_ppt(TCP& tcp) {
    if (tcp.ppt_merged) fail("opj_j2k_merge_ppt() has already been called");
    if (!tcp.ppt) return;
    tcp.ppt_merged = true;
    for (size_t i = 0; i < tcp.ppt_markers.size(); ++i)
      if (tcp.ppt_have[i])
        tcp.ppt_data.insert(tcp.ppt_data.end(), tcp.ppt_markers[i].begin(),
                            tcp.ppt_markers[i].end());
    tcp.ppt_len = uint32_t(tcp.ppt_data.size());
    tcp.ppt_markers.clear();
  }

  // --- Part 2: MCT, MCC, MCO, CBD (opj_j2k_read_mct / _mcc / _mco / _cbd).
  // OpenJPEG reads the records, but COD refuses the array transform
  // (SGcod 2) that would apply their matrix, so what reaches the samples is
  // MCO's DC level shifts (zeroed, then an offset record's) and CBD's
  // precisions and signs. A warning returns early and the decode goes on.
  void read_mct(const uint8_t* p, uint32_t size) {
    TCP& tcp = tcp_here();
    if (size < 2) fail("Error reading MCT marker");
    if (be(p, 2) != 0) return;  // "mct data within multiple MCT records"
    if (size <= 6) fail("Error reading MCT marker");
    uint32_t imct = be(p + 2, 2), index = imct & 0xff;
    size_t i = 0;
    while (i < tcp.mcts.size() && tcp.mcts[i].index != index) ++i;
    if (i == tcp.mcts.size()) tcp.mcts.emplace_back();
    MctRec& rec = tcp.mcts[i];
    rec.data.clear();
    rec.index = index;
    rec.elem = (imct >> 10) & 3;
    if (be(p + 4, 2) != 0) return;  // "multiple MCT markers": no data
    rec.data.assign(p + 6, p + size);
  }

  void read_mcc(const uint8_t* p, uint32_t size) {
    TCP& tcp = tcp_here();
    if (size < 2) fail("Error reading MCC marker");
    if (be(p, 2) != 0) return;  // "multiple data spanning"
    if (size < 7) fail("Error reading MCC marker");
    uint32_t index = p[2];
    size_t i = 0;
    while (i < tcp.mccs.size() && tcp.mccs[i].index != index) ++i;
    bool fresh = i == tcp.mccs.size();
    MccRec& rec = fresh ? tcp.mcc_spare : tcp.mccs[i];
    rec.index = index;
    if (be(p + 3, 2) != 0) return;  // Ymcc: "multiple data spanning"
    uint32_t ncoll = be(p + 5, 2);
    if (ncoll > 1) return;          // "multiple collections"
    const uint8_t* q = p + 7;
    size -= 7;
    for (uint32_t c = 0; c < ncoll; ++c) {
      if (size < 3) fail("Error reading MCC marker");
      if (q[0] != 1) return;        // not an array decorrelation
      uint32_t n = be(q + 1, 2);
      q += 3;
      size -= 3;
      uint32_t nb = 1 + (n >> 15);
      rec.nb_comps = n & 0x7fff;
      if (size < nb * rec.nb_comps + 2) fail("Error reading MCC marker");
      size -= nb * rec.nb_comps + 2;
      for (uint32_t j = 0; j < rec.nb_comps; ++j, q += nb)
        if (be(q, int(nb)) != j) return;  // "indix shuffle"
      n = be(q, 2);
      q += 2;
      nb = 1 + (n >> 15);
      if ((n & 0x7fff) != rec.nb_comps) return;
      if (size < nb * rec.nb_comps + 3) fail("Error reading MCC marker");
      size -= nb * rec.nb_comps + 3;
      for (uint32_t j = 0; j < rec.nb_comps; ++j, q += nb)
        if (be(q, int(nb)) != j) return;
      uint32_t t = be(q, 3);
      q += 3;
      rec.deco = rec.offs = -1;
      for (int k = 0; k < 2; ++k) {
        uint32_t want = k == 0 ? t & 0xff : (t >> 8) & 0xff;
        if (want == 0) continue;
        int32_t found = -1;
        for (size_t j = 0; j < tcp.mcts.size() && found < 0; ++j)
          if (tcp.mcts[j].index == want) found = int32_t(j);
        if (found < 0) fail("Error reading MCC marker");
        (k == 0 ? rec.deco : rec.offs) = found;
      }
    }
    if (size != 0) fail("Error reading MCC marker");
    if (fresh) {
      tcp.mccs.push_back(rec);
      tcp.mcc_spare = MccRec();
    }
  }

  // opj_j2k_add_mct: the MCC `index` names, its arrays' sizes checked,
  // its offsets as the DC level shifts.
  void add_mct(TCP& tcp, uint32_t index) {
    static const uint32_t kElemSize[4] = {2, 4, 4, 8};
    const MccRec* rec = nullptr;
    for (const MccRec& m : tcp.mccs)
      if (m.index == index) {
        rec = &m;
        break;
      }
    if (!rec || rec->nb_comps != numcomps) return;
    if (rec->deco >= 0) {
      const MctRec& d = tcp.mcts[rec->deco];
      if (d.data.size() != kElemSize[d.elem] * numcomps * numcomps)
        fail("an MCT decorrelation array of the wrong size");
    }
    if (rec->offs >= 0) {
      const MctRec& o = tcp.mcts[rec->offs];
      uint32_t es = kElemSize[o.elem];
      if (o.data.size() != es * numcomps)
        fail("an MCT offset array of the wrong size");
      for (uint32_t c = 0; c < numcomps; ++c) {
        const uint8_t* e = o.data.data() + es * c;
        int32_t v;
        if (o.elem == 0) {
          v = int32_t(be(e, 2));  // read unsigned, as OpenJPEG does
        } else if (o.elem == 1) {
          v = int32_t(be(e, 4));
        } else {
          double f;
          if (o.elem == 2) {
            uint32_t b = be(e, 4);
            float g;
            memcpy(&g, &b, 4);
            f = g;
          } else {
            uint64_t b = uint64_t(be(e, 4)) << 32 | be(e + 4, 4);
            memcpy(&f, &b, 8);
          }
          // cvttss2si / cvttsd2si: INT32_MIN where the value does not fit
          v = (f > -2147483649.0 && f < 2147483648.0) ? int32_t(f)
                                                      : INT32_MIN;
        }
        tcp.tccps[c].dc_level_shift = v;
      }
    }
  }

  void read_mco(const uint8_t* p, uint32_t size) {
    TCP& tcp = tcp_here();
    if (size < 1) fail("Error reading MCO marker");
    uint32_t stages = p[0];
    if (stages > 1) return;  // "multiple transformation stages"
    if (size != stages + 1) fail("Error reading MCO marker");
    for (uint32_t c = 0; c < numcomps; ++c) tcp.tccps[c].dc_level_shift = 0;
    for (uint32_t i = 0; i < stages; ++i) add_mct(tcp, p[1 + i]);
  }

  void read_cbd(const uint8_t* p, uint32_t size) {
    if (size != numcomps + 2 || be(p, 2) != numcomps)
      fail("Crror reading CBD marker");
    for (uint32_t c = 0; c < numcomps; ++c) {
      comps[c].sgnd = (p[2 + c] >> 7) & 1;
      comps[c].prec = (p[2 + c] & 0x7f) + 1u;
      if (comps[c].prec > 31)
        fail("Invalid values for comp: prec (OpenJPEG supports up to 31)");
    }
  }

  void read_marker(uint32_t id, const uint8_t* p, uint32_t size) {
    switch (id) {
      case M_SIZ: read_siz(p, size); break;
      case M_COD: read_cod(p, size); break;
      case M_COC: read_coc(p, size); break;
      case M_QCD: read_qcd(p, size); break;
      case M_QCC: read_qcc(p, size); break;
      case M_RGN: read_rgn(p, size); break;
      case M_POC: read_poc(p, size); break;
      case M_TLM: read_tlm(size); break;
      case M_PLM:
        if (size < 1) fail("Error reading PLM marker");
        break;
      case M_PLT: read_plt(p, size); break;
      case M_CRG:
        if (size != numcomps * 4) fail("Error reading CRG marker");
        break;
      case M_COM: case M_CAP: case M_CPF: break;
      case M_PPM: read_ppm(p, size); break;
      case M_PPT: read_ppt(p, size); break;
      case M_MCT: read_mct(p, size); break;
      case M_MCC: read_mcc(p, size); break;
      case M_MCO: read_mco(p, size); break;
      case M_CBD: read_cbd(p, size); break;
      case M_SOT: read_sot(p, size); break;
      default: fail("Not sure how that happened.");
    }
  }

  // opj_j2k_read_unk: skip two bytes at a time to the next known marker.
  uint32_t read_unk() {
    for (;;) {
      uint32_t m;
      if (!s.read2(&m)) fail("Stream too short");
      if (m >= 0xff00) {
        Handler h = handler(m);
        if (!(state & h.states))
          fail("Marker is not compliant with its position");
        if (h.id != M_UNK) return h.id;
      }
    }
  }

  void read_header() {
    state = S_MHSOC;
    uint32_t m;
    if (!s.read2(&m) || m != M_SOC) fail("Expected a SOC marker");
    state = S_MHSIZ;
    if (!s.read2(&m)) fail("Stream too short");
    bool has_siz = false, has_cod = false, has_qcd = false;
    while (m != M_SOT) {
      if (m < 0xff00) fail("A marker ID was expected (0xff--)");
      Handler h = handler(m);
      if (h.id == M_UNK) {
        m = read_unk();
        if (m == M_SOT) break;
        h = handler(m);
      }
      if (h.id == M_SIZ) has_siz = true;
      if (h.id == M_COD) has_cod = true;
      if (h.id == M_QCD) has_qcd = true;
      if (!(state & h.states))
        fail("Marker is not compliant with its position");
      uint32_t size;
      if (!s.read2(&size)) fail("Stream too short");
      if (size < 2) fail("Invalid marker size");
      size -= 2;
      const uint8_t* p;
      if (s.read(size, &p) != int64_t(size)) fail("Stream too short");
      read_marker(h.id, p, size);
      if (!s.read2(&m)) fail("Stream too short");
    }
    if (!has_siz) fail("required SIZ marker not found in main header");
    if (!has_cod) fail("required COD marker not found in main header");
    if (!has_qcd) fail("required QCD marker not found in main header");
    merge_ppm();
    state = S_TPHSOT;
    // opj_j2k_copy_default_tcp_and_create_tcd
    tcps.assign(size_t(tw) * th, deflt);
    for (TCP& t : tcps) {
      t.cod = false;
      t.cur_part = -1;
    }
  }

  // --- tile-parts ---
  void read_sot(const uint8_t* p, uint32_t size) {
    if (size != 8) fail("Error reading SOT marker");
    cur_tile = be(p, 2);
    uint32_t tot_len = be(p + 2, 4), part = p[6], num_parts = p[7];
    if (cur_tile >= tw * th) fail("Invalid tile number");
    TCP& tcp = tcps[cur_tile];
    if (tcp.cur_part + 1 != int32_t(part))
      fail("Invalid tile part index for tile number");
    tcp.cur_part = int32_t(part);
    if (tot_len != 0 && tot_len < 14 && tot_len != 12)
      fail("Psot value is not correct regards to the JPEG2000 norm");
    if (!tot_len) last_tile_part = true;
    if (tcp.nb_parts != 0 && part >= tcp.nb_parts) {
      last_tile_part = true;
      fail("In SOT marker, TPSot is not valid regards to the previous "
           "number of tile-part");
    }
    if (num_parts != 0) {
      if (tcp.nb_parts && part >= tcp.nb_parts) {
        last_tile_part = true;
        fail("In SOT marker, TPSot is not valid regards to the current "
             "number of tile-part");
      }
      if (part >= num_parts) {
        last_tile_part = true;
        fail("In SOT marker, TPSot is not valid regards to the current "
             "number of tile-part (header)");
      }
      tcp.nb_parts = num_parts;
    }
    if (tcp.nb_parts && tcp.nb_parts == part + 1) can_decode = true;
    sot_length = last_tile_part ? 0 : tot_len - 12;
    state = S_TPH;
  }

  void read_sod() {
    TCP& tcp = tcps[cur_tile];
    if (last_tile_part)
      sot_length = uint32_t(s.left() - 2);
    else if (sot_length >= 2)
      sot_length -= 2;
    bool pb = false;
    if (sot_length) {
      if (int64_t(sot_length) > s.left())
        fail("Tile part length size inconsistent with stream length");
      tcp.has_data = true;
    } else {
      pb = true;
    }
    int64_t got = 0;
    if (!pb) {
      const uint8_t* q;
      got = s.read(sot_length, &q);
      tcp.data.insert(tcp.data.end(), q, q + got);
    }
    state = got != int64_t(sot_length) ? S_NEOC : S_TPHSOT;
  }

  // opj_j2k_read_tile_header: false when no tile is left.
  bool read_tile_header() {
    uint32_t m = M_SOT;
    uint32_t ntiles = tw * th;
    if (state == S_EOC)
      m = M_EOC;
    else if (state != S_TPHSOT)
      fail("the codestream is not at a tile-part");
    while (!can_decode && m != M_EOC) {
      while (m != M_SOD) {
        if (s.left() == 0) {
          state = S_NEOC;
          break;
        }
        uint32_t size;
        if (!s.read2(&size)) fail("Stream too short");
        if (size < 2) fail("Inconsistent marker size");
        if (m == 0x8080 && s.left() == 0) {
          state = S_NEOC;
          break;
        }
        if ((state & S_TPH) && sot_length != 0) {
          if (sot_length < size + 2)
            fail("Sot length is less than marker size + marker ID");
          sot_length -= size + 2;
        }
        size -= 2;
        Handler h = handler(m);
        if (!(state & h.states))
          fail("Marker is not compliant with its position");
        if (h.id == M_UNK || h.id == M_SOP)
          fail("Not sure how that happened.");
        const uint8_t* p;
        if (s.read(size, &p) != int64_t(size)) fail("Stream too short");
        read_marker(h.id, p, size);
        if (!s.read2(&m)) fail("Stream too short");
      }
      if (s.left() == 0 && state == S_NEOC) break;
      read_sod();
      if (!can_decode) {
        if (!s.read2(&m)) {
          // Non conformant files whose last tiles have TPsot == TNsot == 0
          // and no EOC.
          if (cur_tile + 1 == ntiles) {
            uint32_t t = 0;
            for (; t < ntiles; ++t)
              if (tcps[t].cur_part == 0 && tcps[t].nb_parts == 0) break;
            if (t < ntiles) {
              cur_tile = t;
              m = M_EOC;
              state = S_EOC;
              break;
            }
          }
          fail("Stream too short");
        }
      }
    }
    if (m == M_EOC && state != S_EOC) {
      cur_tile = 0;
      state = S_EOC;
    }
    if (!can_decode) {
      while (cur_tile < ntiles && !tcps[cur_tile].has_data) ++cur_tile;
      if (cur_tile == ntiles) return false;
    }
    merge_ppt(tcps[cur_tile]);
    state |= S_DATA;
    return true;
  }

  // --- tile decoding ---
  uint32_t tile_x0, tile_y0, tile_x1, tile_y1;
  std::vector<TileComp> tcs;

  void tile_bounds(uint32_t tileno) {
    uint32_t p = tileno % tw, q = tileno / tw;
    uint32_t l_tx0 = tx0 + p * tdx, l_ty0 = ty0 + q * tdy;
    tile_x0 = l_tx0 > x0 ? l_tx0 : x0;
    tile_y0 = l_ty0 > y0 ? l_ty0 : y0;
    uint32_t a = uadds(l_tx0, tdx), b = uadds(l_ty0, tdy);
    tile_x1 = a < x1 ? a : x1;
    tile_y1 = b < y1 ? b : y1;
  }

  void init_tile(uint32_t tileno) {
    TCP& tcp = tcps[tileno];
    tile_bounds(tileno);
    tcs.assign(numcomps, TileComp());
    uint64_t budget = 0;
    for (uint32_t c = 0; c < numcomps; ++c) {
      TileComp& tc = tcs[c];
      const TCCP& tccp = tcp.tccps[c];
      comps[c].resno_decoded = 0;  // the highest resolution a packet of
                                   // this tile reaches, tile by tile
      tc.x0 = int32_t(ceildiv(tile_x0, comps[c].dx));
      tc.y0 = int32_t(ceildiv(tile_y0, comps[c].dy));
      tc.x1 = int32_t(ceildiv(tile_x1, comps[c].dx));
      tc.y1 = int32_t(ceildiv(tile_y1, comps[c].dy));
      tc.numres = tccp.numresolutions;
      tc.res.assign(tc.numres, Res());
      for (uint32_t r = 0; r < tc.numres; ++r) {
        Res& res = tc.res[r];
        uint32_t level = tc.numres - 1 - r;
        res.x0 = int32_t(ceildivpow2(tc.x0, level));
        res.y0 = int32_t(ceildivpow2(tc.y0, level));
        res.x1 = int32_t(ceildivpow2(tc.x1, level));
        res.y1 = int32_t(ceildivpow2(tc.y1, level));
        uint32_t pdx = tccp.prcw[r], pdy = tccp.prch[r];
        int64_t px0 = floordivpow2(res.x0, pdx) << pdx;
        int64_t py0 = floordivpow2(res.y0, pdy) << pdy;
        int64_t px1 = ceildivpow2(res.x1, pdx) << pdx;
        int64_t py1 = ceildivpow2(res.y1, pdy) << pdy;
        if (px1 > 0x7fffffff || py1 > 0x7fffffff) fail("Integer overflow");
        res.pw = res.x0 == res.x1 ? 0 : uint32_t((px1 - px0) >> pdx);
        res.ph = res.y0 == res.y1 ? 0 : uint32_t((py1 - py0) >> pdy);
        uint64_t nprec = uint64_t(res.pw) * res.ph;
        if (nprec > (1u << 24)) fail("Size of tile data exceeds system limits");
        int64_t cbgx, cbgy;
        uint32_t cbgw, cbgh;
        if (r == 0) {
          cbgx = px0;
          cbgy = py0;
          cbgw = pdx;
          cbgh = pdy;
          res.numbands = 1;
        } else {
          cbgx = ceildivpow2(px0, 1);
          cbgy = ceildivpow2(py0, 1);
          cbgw = pdx - 1;
          cbgh = pdy - 1;
          res.numbands = 3;
        }
        uint32_t cbw = tccp.cblkw < cbgw ? tccp.cblkw : cbgw;
        uint32_t cbh = tccp.cblkh < cbgh ? tccp.cblkh : cbgh;
        for (uint32_t bi = 0; bi < res.numbands; ++bi) {
          Band& band = res.bands[bi];
          if (r == 0) {
            band.bandno = 0;
            band.x0 = res.x0;
            band.y0 = res.y0;
            band.x1 = res.x1;
            band.y1 = res.y1;
          } else {
            band.bandno = bi + 1;
            int64_t xb = band.bandno & 1, yb = band.bandno >> 1;
            band.x0 = int32_t(ceildivpow2(tc.x0 - (xb << level), level + 1));
            band.y0 = int32_t(ceildivpow2(tc.y0 - (yb << level), level + 1));
            band.x1 = int32_t(ceildivpow2(tc.x1 - (xb << level), level + 1));
            band.y1 = int32_t(ceildivpow2(tc.y1 - (yb << level), level + 1));
          }
          const StepSize& ss =
              tccp.steps[r == 0 ? 0 : 3 * (r - 1) + bi + 1];
          int32_t log2_gain = tccp.qmfbid == 0 ? 0
                              : band.bandno == 0 ? 0
                              : band.bandno == 3 ? 2 : 1;
          int32_t rb = int32_t(comps[c].prec) + log2_gain;
          band.stepsize = float((1.0 + ss.mant / 2048.0) *
                                pow(2.0, double(rb - ss.expn))) * 1.0f;
          band.numbps = ss.expn + int32_t(tccp.numgbits) - 1;
          band.precs.assign(nprec, Prec());
          for (uint32_t pn = 0; pn < nprec; ++pn) {
            Prec& pr = band.precs[pn];
            int64_t sx = cbgx + int64_t(pn % res.pw) * (int64_t(1) << cbgw);
            int64_t sy = cbgy + int64_t(pn / res.pw) * (int64_t(1) << cbgh);
            int64_t ex = sx + (int64_t(1) << cbgw);
            int64_t ey = sy + (int64_t(1) << cbgh);
            pr.x0 = int32_t(sx > band.x0 ? sx : band.x0);
            pr.y0 = int32_t(sy > band.y0 ? sy : band.y0);
            pr.x1 = int32_t(ex < band.x1 ? ex : band.x1);
            pr.y1 = int32_t(ey < band.y1 ? ey : band.y1);
            int64_t bx0 = floordivpow2(pr.x0, cbw) << cbw;
            int64_t by0 = floordivpow2(pr.y0, cbh) << cbh;
            int64_t bx1 = ceildivpow2(pr.x1, cbw) << cbw;
            int64_t by1 = ceildivpow2(pr.y1, cbh) << cbh;
            pr.cw = uint32_t((bx1 - bx0) >> cbw);
            pr.ch = uint32_t((by1 - by0) >> cbh);
            uint64_t ncb = uint64_t(pr.cw) * pr.ch;
            budget += ncb;
            if (budget > (1u << 24))
              fail("Size of tile data exceeds system limits");
            pr.cblks.assign(ncb, Cblk());
            for (uint32_t k = 0; k < ncb; ++k) {
              Cblk& cb = pr.cblks[k];
              int64_t csx = bx0 + int64_t(k % pr.cw) * (int64_t(1) << cbw);
              int64_t csy = by0 + int64_t(k / pr.cw) * (int64_t(1) << cbh);
              int64_t cex = csx + (int64_t(1) << cbw);
              int64_t cey = csy + (int64_t(1) << cbh);
              cb.x0 = int32_t(csx > pr.x0 ? csx : pr.x0);
              cb.y0 = int32_t(csy > pr.y0 ? csy : pr.y0);
              cb.x1 = int32_t(cex < pr.x1 ? cex : pr.x1);
              cb.y1 = int32_t(cey < pr.y1 ? cey : pr.y1);
            }
            pr.incl.create(pr.cw, pr.ch);
            pr.imsb.create(pr.cw, pr.ch);
          }
        }
      }
    }
  }

  // --- the packet iterator (pi.c), each POC's packets in order ---
  struct Packet {
    uint32_t layno, resno, compno, precno;
  };
  struct PiRes {
    uint32_t pdx, pdy, pw, ph;
  };

  std::vector<std::vector<Packet>> packets(uint32_t tileno, bool* unknown) {
    TCP& tcp = tcps[tileno];
    tile_bounds(tileno);
    uint32_t max_res = 0, max_prec = 0;
    std::vector<std::vector<PiRes>> pres(numcomps);
    for (uint32_t c = 0; c < numcomps; ++c) {
      const TCCP& tccp = tcp.tccps[c];
      uint32_t tcx0 = uint32_t(ceildiv(tile_x0, comps[c].dx));
      uint32_t tcy0 = uint32_t(ceildiv(tile_y0, comps[c].dy));
      uint32_t tcx1 = uint32_t(ceildiv(tile_x1, comps[c].dx));
      uint32_t tcy1 = uint32_t(ceildiv(tile_y1, comps[c].dy));
      if (tccp.numresolutions > max_res) max_res = tccp.numresolutions;
      uint32_t level = tccp.numresolutions - 1;
      for (uint32_t r = 0; r < tccp.numresolutions; ++r, --level) {
        PiRes pr;
        pr.pdx = tccp.prcw[r];
        pr.pdy = tccp.prch[r];
        uint64_t rx0 = ceildivpow2(tcx0, level), ry0 = ceildivpow2(tcy0, level);
        uint64_t rx1 = ceildivpow2(tcx1, level), ry1 = ceildivpow2(tcy1, level);
        uint64_t px0 = (rx0 >> pr.pdx) << pr.pdx;
        uint64_t py0 = (ry0 >> pr.pdy) << pr.pdy;
        uint64_t px1 = uint64_t(ceildivpow2(int64_t(rx1), pr.pdx)) << pr.pdx;
        uint64_t py1 = uint64_t(ceildivpow2(int64_t(ry1), pr.pdy)) << pr.pdy;
        pr.pw = rx0 == rx1 ? 0 : uint32_t((px1 - px0) >> pr.pdx);
        pr.ph = ry0 == ry1 ? 0 : uint32_t((py1 - py0) >> pr.pdy);
        if (pr.pw * pr.ph > max_prec) max_prec = pr.pw * pr.ph;
        pres[c].push_back(pr);
      }
    }
    uint64_t step_c = max_prec, step_r = uint64_t(numcomps) * step_c;
    uint64_t step_l = uint64_t(max_res) * step_r;
    uint64_t include_size = (uint64_t(tcp.numlayers) + 1) * step_l;
    if (include_size > (uint64_t(1) << 28))
      fail("the packet iterator needs too much memory");
    std::vector<uint8_t> include(include_size, 0);
    uint32_t npi = tcp.numpocs + 1;
    std::vector<std::vector<Packet>> out(npi);
    *unknown = false;
    for (uint32_t pino = 0; pino < npi; ++pino) {
      uint32_t resno0, compno0, layno0 = 0, resno1, compno1, layno1;
      int32_t prg;
      if (tcp.has_poc) {
        const POC& c = tcp.pocs[pino];
        prg = c.prg;
        resno0 = c.resno0;
        compno0 = c.compno0;
        resno1 = c.resno1;
        compno1 = c.compno1;
        layno1 = c.layno1 < tcp.numlayers ? c.layno1 : tcp.numlayers;
      } else {
        prg = tcp.prg;
        resno0 = 0;
        compno0 = 0;
        resno1 = max_res;
        compno1 = numcomps;
        layno1 = tcp.numlayers;
      }
      if (prg == kProgUnknown) {
        *unknown = true;
        return out;
      }
      std::vector<Packet>& seq = out[pino];
      auto emit = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t p) -> int {
        uint64_t index = l * step_l + r * step_r + c * step_c + p;
        if (index >= include_size) return -1;  // ends this iterator
        if (!include[index]) {
          include[index] = 1;
          seq.push_back({l, r, c, p});
        }
        return 0;
      };
      if (prg > 4) continue;
      if (compno0 >= numcomps || compno1 >= numcomps + 1) continue;
      if (prg == 0 || prg == 1) {  // LRCP, RLCP
        bool stop = false;
        auto body = [&](uint32_t l, uint32_t r) {
          for (uint32_t c = compno0; c < compno1 && !stop; ++c) {
            if (r >= tcp.tccps[c].numresolutions) continue;
            uint32_t np = pres[c][r].pw * pres[c][r].ph;
            for (uint32_t p = 0; p < np && !stop; ++p)
              if (emit(l, r, c, p) < 0) stop = true;
          }
        };
        if (prg == 0) {
          for (uint32_t l = layno0; l < layno1 && !stop; ++l)
            for (uint32_t r = resno0; r < resno1 && !stop; ++r) body(l, r);
        } else {
          for (uint32_t r = resno0; r < resno1 && !stop; ++r)
            for (uint32_t l = layno0; l < layno1 && !stop; ++l) body(l, r);
        }
        continue;
      }
      // RPCL, PCRL, CPRL: positions on the reference grid.
      auto steps = [&](uint32_t c0, uint32_t c1, uint32_t* dx, uint32_t* dy) {
        *dx = *dy = 0;
        for (uint32_t c = c0; c < c1; ++c) {
          uint32_t nr = tcp.tccps[c].numresolutions;
          for (uint32_t r = 0; r < nr; ++r) {
            const PiRes& pr = pres[c][r];
            uint32_t ex = pr.pdx + nr - 1 - r, ey = pr.pdy + nr - 1 - r;
            if (ex < 32 && comps[c].dx <= 0xffffffffu / (1u << ex)) {
              uint32_t v = comps[c].dx * (1u << ex);
              *dx = !*dx ? v : (*dx < v ? *dx : v);
            }
            if (ey < 32 && comps[c].dy <= 0xffffffffu / (1u << ey)) {
              uint32_t v = comps[c].dy * (1u << ey);
              *dy = !*dy ? v : (*dy < v ? *dy : v);
            }
          }
        }
      };
      // One (x, y, c, r) position: the precinct it starts, or -1.
      auto prec_at = [&](uint32_t x, uint32_t y, uint32_t c,
                         uint32_t r) -> int64_t {
        uint32_t nr = tcp.tccps[c].numresolutions;
        if (r >= nr) return -1;
        const PiRes& pr = pres[c][r];
        uint32_t level = nr - 1 - r;
        uint64_t cdx = comps[c].dx, cdy = comps[c].dy;
        if (uint32_t((cdx << level) >> level) != cdx ||
            uint32_t((cdy << level) >> level) != cdy)
          return -1;
        uint64_t dxl = cdx << level, dyl = cdy << level;
        uint32_t trx0 = uint32_t((tile_x0 + dxl - 1) / dxl);
        uint32_t try0 = uint32_t((tile_y0 + dyl - 1) / dyl);
        uint32_t trx1 = uint32_t((tile_x1 + dxl - 1) / dxl);
        uint32_t try1 = uint32_t((tile_y1 + dyl - 1) / dyl);
        uint32_t rpx = pr.pdx + level, rpy = pr.pdy + level;
        if (rpx >= 64 || rpy >= 64 ||
            uint32_t((cdx << rpx) >> rpx) != cdx ||
            uint32_t((cdy << rpy) >> rpy) != cdy)
          return -1;
        if (!((uint64_t(y) % (cdy << rpy) == 0) ||
              (y == tile_y0 &&
               ((uint64_t(try0) << level) % (uint64_t(1) << rpy)))))
          return -1;
        if (!((uint64_t(x) % (cdx << rpx) == 0) ||
              (x == tile_x0 &&
               ((uint64_t(trx0) << level) % (uint64_t(1) << rpx)))))
          return -1;
        if (pr.pw == 0 || pr.ph == 0) return -1;
        if (trx0 == trx1 || try0 == try1) return -1;
        uint32_t prci = uint32_t(((x + dxl - 1) / dxl) >> pr.pdx) -
                        (trx0 >> pr.pdx);
        uint32_t prcj = uint32_t(((y + dyl - 1) / dyl) >> pr.pdy) -
                        (try0 >> pr.pdy);
        return int64_t(prci) + int64_t(prcj) * pr.pw;
      };
      bool stop = false;
      auto layers = [&](uint32_t r, uint32_t c, int64_t p) {
        for (uint32_t l = layno0; l < layno1 && !stop; ++l)
          if (emit(l, r, c, uint32_t(p)) < 0) stop = true;
      };
      auto adv = [](uint32_t v, uint32_t d) { return v + (d - (v % d)); };
      if (prg == 2 || prg == 3) {  // RPCL, PCRL
        uint32_t dx, dy;
        steps(0, numcomps, &dx, &dy);
        if (dx == 0 || dy == 0) continue;
        if (prg == 2) {
          for (uint32_t r = resno0; r < resno1 && !stop; ++r)
            for (uint32_t y = tile_y0; y < tile_y1 && !stop; y = adv(y, dy))
              for (uint32_t x = tile_x0; x < tile_x1 && !stop; x = adv(x, dx))
                for (uint32_t c = compno0; c < compno1 && !stop; ++c) {
                  int64_t p = prec_at(x, y, c, r);
                  if (p >= 0) layers(r, c, p);
                }
        } else {
          for (uint32_t y = tile_y0; y < tile_y1 && !stop; y = adv(y, dy))
            for (uint32_t x = tile_x0; x < tile_x1 && !stop; x = adv(x, dx))
              for (uint32_t c = compno0; c < compno1 && !stop; ++c) {
                uint32_t nr = tcp.tccps[c].numresolutions;
                uint32_t rend = resno1 < nr ? resno1 : nr;
                for (uint32_t r = resno0; r < rend && !stop; ++r) {
                  int64_t p = prec_at(x, y, c, r);
                  if (p >= 0) layers(r, c, p);
                }
              }
        }
        continue;
      }
      // CPRL
      for (uint32_t c = compno0; c < compno1 && !stop; ++c) {
        uint32_t dx, dy;
        steps(c, c + 1, &dx, &dy);
        if (dx == 0 || dy == 0) break;
        uint32_t nr = tcp.tccps[c].numresolutions;
        uint32_t rend = resno1 < nr ? resno1 : nr;
        for (uint32_t y = tile_y0; y < tile_y1 && !stop; y = adv(y, dy))
          for (uint32_t x = tile_x0; x < tile_x1 && !stop; x = adv(x, dx))
            for (uint32_t r = resno0; r < rend && !stop; ++r) {
              int64_t p = prec_at(x, y, c, r);
              if (p >= 0) layers(r, c, p);
            }
      }
    }
    return out;
  }

  // --- tier 2 (t2.c) ---
  static void init_seg(Cblk& cb, uint32_t index, uint32_t cblksty,
                       bool first) {
    if (cb.segs.size() <= index) cb.segs.resize(index + 1);
    Seg& s = cb.segs[index];
    s = Seg();
    if (cblksty & CBLK_TERMALL)
      s.maxpasses = 1;
    else if (cblksty & CBLK_LAZY) {
      if (first)
        s.maxpasses = 10;
      else
        s.maxpasses = (cb.segs[index - 1].maxpasses == 1 ||
                       cb.segs[index - 1].maxpasses == 10) ? 2 : 1;
    } else {
      s.maxpasses = 109;
    }
  }

  static uint32_t numpasses(Bio& b) {
    if (!b.read(1)) return 1;
    if (!b.read(1)) return 2;
    uint32_t n = b.read(2);
    if (n != 3) return 3 + n;
    n = b.read(5);
    if (n != 31) return 6 + n;
    return 37 + b.read(7);
  }

  // One packet: its header, then its data. Returns the bytes used.
  uint32_t read_packet(TCP& tcp, const Packet& pk, uint32_t off,
                       uint32_t max_len) {
    const uint8_t* src = tcp.data.data() + off;
    Res& res = tcs[pk.compno].res[pk.resno];
    uint32_t cblksty = tcp.tccps[pk.compno].cblksty;
    if (pk.layno == 0) {
      for (uint32_t b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        if (pk.precno >= band.precs.size()) fail("Invalid precinct");
        Prec& pr = band.precs[pk.precno];
        pr.incl.reset();
        pr.imsb.reset();
        for (Cblk& cb : pr.cblks) {
          cb.numsegs = 0;
          cb.real_num_segs = 0;
        }
      }
    }
    const uint8_t* cur = src;
    if (tcp.csty & 2) {  // SOP
      if (max_len >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
    }
    // The header comes from PPM, PPT or the packet itself.
    const uint8_t* hdr;
    uint32_t* remaining;
    uint32_t* hpos = nullptr;
    uint32_t own;
    if (ppm) {
      hdr = ppm_data.data() + ppm_pos;
      remaining = &ppm_len;
      hpos = &ppm_pos;
    } else if (tcp.ppt) {
      hdr = tcp.ppt_data.data() + tcp.ppt_pos;
      remaining = &tcp.ppt_len;
      hpos = &tcp.ppt_pos;
    } else {
      hdr = cur;
      own = uint32_t(src + max_len - cur);
      remaining = &own;
    }
    Bio bio(hdr, *remaining);
    bool present = bio.read(1);
    if (present) {
      for (uint32_t b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        Prec& pr = band.precs[pk.precno];
        for (uint32_t k = 0; k < pr.cblks.size(); ++k) {
          Cblk& cb = pr.cblks[k];
          uint32_t included;
          if (!cb.numsegs)
            included = tgt_decode(bio, pr.incl, k, int32_t(pk.layno + 1));
          else
            included = bio.read(1);
          if (!included) {
            cb.numnewpasses = 0;
            continue;
          }
          if (!cb.numsegs) {
            uint32_t i = 0;
            while (!tgt_decode(bio, pr.imsb, k, int32_t(i))) ++i;
            cb.mb = uint32_t(band.numbps);
            cb.numbps = uint32_t(band.numbps) + 1 - i;
            cb.numlenbits = 3;
          }
          cb.numnewpasses = numpasses(bio);
          uint32_t inc = 0;
          while (bio.read(1)) ++inc;
          cb.numlenbits += inc;
          uint32_t segno = 0;
          if (!cb.numsegs) {
            init_seg(cb, 0, cblksty, true);
          } else {
            segno = cb.numsegs - 1;
            if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
              ++segno;
              init_seg(cb, segno, cblksty, false);
            }
          }
          int32_t n = int32_t(cb.numnewpasses);
          bool ht = (cblksty & CBLK_HT) != 0;
          do {
            Seg& sg = cb.segs[segno];
            int32_t room = int32_t(sg.maxpasses - sg.numpasses);
            // HTJ2K: the cleanup pass alone in the first segment, the
            // others together in the next.
            if (ht)
              sg.numnewpasses = segno == 0 ? 1 : uint32_t(n);
            else
              sg.numnewpasses = uint32_t(room < n ? room : n);
            uint32_t bits = cb.numlenbits;
            if (sg.numnewpasses) bits += 31 - __builtin_clz(sg.numnewpasses);
            if (bits > 32) fail("Invalid bit number in packet header");
            sg.newlen = bio.read(bits);
            n -= int32_t(sg.numnewpasses);
            if (n > 0) {
              ++segno;
              init_seg(cb, segno, cblksty, false);
            }
          } while (n > 0);
        }
      }
    }
    if (!bio.inalign()) fail("a packet header ends on 0xFF at the data's end");
    const uint8_t* p = hdr + bio.numbytes();
    if (tcp.csty & 4) {  // EPH: a missing one fails (SOP's only warns)
      if (*remaining - uint32_t(p - hdr) < 2)
        fail("Not enough space for required EPH marker");
      if (p[0] != 0xff || p[1] != 0x92) fail("Expected EPH marker");
      p += 2;
    }
    uint32_t hlen = uint32_t(p - hdr);
    *remaining -= hlen;
    if (hpos) {
      *hpos += hlen;
      p = cur;
    }
    uint32_t used = uint32_t(p - src);
    if (!present) return used;
    // opj_t2_read_packet_data
    uint32_t dmax = max_len - used;
    uint32_t dpos = 0;
    for (uint32_t b = 0; b < res.numbands; ++b) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Prec& pr = band.precs[pk.precno];
      for (Cblk& cb : pr.cblks) {
        if (!cb.numnewpasses) continue;
        uint32_t si;
        if (!cb.numsegs) {
          si = 0;
          ++cb.numsegs;
        } else {
          si = cb.numsegs - 1;
          if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
            ++si;
            ++cb.numsegs;
          }
        }
        do {
          Seg& sg = cb.segs[si];
          if (uint64_t(dpos) + sg.newlen > dmax)
            fail("read: segment too long");
          cb.chunks.push_back({off + used + dpos, sg.newlen});
          dpos += sg.newlen;
          sg.len += sg.newlen;
          sg.numpasses += sg.numnewpasses;
          cb.numnewpasses -= sg.numnewpasses;
          sg.real_num_passes = sg.numpasses;
          if (cb.numnewpasses > 0) {
            ++si;
            ++cb.numsegs;
          }
        } while (cb.numnewpasses > 0);
        cb.real_num_segs = cb.numsegs;
      }
    }
    return used + dpos;
  }

  void decode_tile(uint32_t tileno) {
    TCP& tcp = tcps[tileno];
    // tier 2
    bool unknown;
    auto seqs = packets(tileno, &unknown);
    if (unknown) fail("an unknown progression order");
    tcp.data.resize(tcp.data.size() + 2);  // room for the synthetic marker
    uint32_t max_len = uint32_t(tcp.data.size() - 2), off = 0;
    for (const auto& seq : seqs) {
      for (const Packet& pk : seq) {
        uint32_t used = read_packet(tcp, pk, off, max_len - off);
        Comp& ic = comps[pk.compno];
        if (pk.resno > ic.resno_decoded) ic.resno_decoded = pk.resno;
        off += used;
      }
    }
    // tier 1
    T1 t1;
    std::vector<uint8_t> ht_buf;
    for (uint32_t c = 0; c < numcomps; ++c) {
      TileComp& tc = tcs[c];
      const TCCP& tccp = tcp.tccps[c];
      const Res& top = tc.res[tc.numres - 1];
      uint32_t w = uint32_t(top.x1 - top.x0), h = uint32_t(top.y1 - top.y0);
      tc.data.assign(size_t(w) * h, 0);
      for (uint32_t r = 0; r < tc.numres; ++r) {
        Res& res = tc.res[r];
        for (uint32_t b = 0; b < res.numbands; ++b) {
          Band& band = res.bands[b];
          for (Prec& pr : band.precs) {
            for (Cblk& cb : pr.cblks) {
              if (cb.x1 < cb.x0 || cb.y1 < cb.y0) continue;
              if (tccp.cblksty & CBLK_HT) {
                // One chunk is read in place in the tile's bytes (16-byte
                // aligned), several from a copy of their own.
                ht_buf.clear();
                for (const auto& ch : cb.chunks)
                  ht_buf.insert(ht_buf.end(), tcp.data.begin() + ch.first,
                                tcp.data.begin() + ch.first + ch.second);
                uint32_t base =
                    cb.chunks.size() == 1 ? cb.chunks[0].first & 3 : 0;
                ht_decode_cblk(cb, ht_buf.data(), uint32_t(ht_buf.size()),
                               base, uint32_t(tccp.roishift), tccp.cblksty,
                               t1.data);
                t1.w = uint32_t(cb.x1 - cb.x0);
                t1.h = uint32_t(cb.y1 - cb.y0);
              } else {
                decode_cblk(t1, cb, tcp.data, band.bandno,
                            uint32_t(tccp.roishift), tccp.cblksty);
              }
              int32_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
              if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
              if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
              uint32_t cw = t1.w, ch = t1.h;
              int32_t* d = t1.data.data();
              if (tccp.roishift) {
                if (tccp.roishift >= 31) {
                  std::fill(t1.data.begin(), t1.data.end(), 0);
                } else {
                  int32_t thresh = int32_t(1u << tccp.roishift);
                  for (size_t i = 0; i < size_t(cw) * ch; ++i) {
                    int32_t v = d[i];
                    int32_t m = v < 0 ? -v : v;
                    if (m >= thresh) {
                      m >>= tccp.roishift;
                      d[i] = v < 0 ? -m : m;
                    }
                  }
                }
              }
              int32_t* tile = tc.data.data() + size_t(y) * w + x;
              if (tccp.qmfbid == 1) {
                for (uint32_t j = 0; j < ch; ++j)
                  for (uint32_t i = 0; i < cw; ++i)
                    tile[size_t(j) * w + i] = d[j * cw + i] / 2;
              } else {
                float step = 0.5f * band.stepsize;
                for (uint32_t j = 0; j < ch; ++j)
                  for (uint32_t i = 0; i < cw; ++i) {
                    float f = float(d[j * cw + i]) * step;
                    memcpy(&tile[size_t(j) * w + i], &f, 4);
                  }
              }
            }
          }
        }
      }
    }
    // the wavelets
    for (uint32_t c = 0; c < numcomps; ++c)
      dwt_decode(tcs[c], comps[c].resno_decoded + 1, tcp.tccps[c].qmfbid == 0);
    // the component transform
    if (tcp.mct) {
      const Res& r0 = tcs[0].res[tcs[0].numres - 1];
      size_t samples = size_t(r0.x1 - r0.x0) * size_t(r0.y1 - r0.y0);
      if (numcomps >= 3) {
        if (tcs[0].numres != tcs[1].numres || tcs[0].numres != tcs[2].numres)
          fail("Tiles don't all have the same dimension");
        const Res& r1 = tcs[1].res[tcs[0].numres - 1];
        const Res& r2 = tcs[2].res[tcs[0].numres - 1];
        if (comps[0].resno_decoded != comps[1].resno_decoded ||
            comps[0].resno_decoded != comps[2].resno_decoded ||
            size_t(r1.x1 - r1.x0) * size_t(r1.y1 - r1.y0) != samples ||
            size_t(r2.x1 - r2.x0) * size_t(r2.y1 - r2.y0) != samples)
          fail("Tiles don't all have the same dimension");
        int32_t *c0 = tcs[0].data.data(), *c1 = tcs[1].data.data(),
                *c2 = tcs[2].data.data();
        if (tcp.tccps[0].qmfbid == 1) {
          for (size_t i = 0; i < samples; ++i) {
            int32_t y = c0[i], u = c1[i], v = c2[i];
            int32_t g = wsub(y, wadd(u, v) >> 2);
            c0[i] = wadd(v, g);
            c1[i] = g;
            c2[i] = wadd(u, g);
          }
        } else {
          float *f0 = reinterpret_cast<float*>(c0),
                *f1 = reinterpret_cast<float*>(c1),
                *f2 = reinterpret_cast<float*>(c2);
          for (size_t i = 0; i < samples; ++i) {
            float y = f0[i], u = f1[i], v = f2[i];
            float r = y + (v * 1.402f);
            float g = y - (u * 0.34413f);
            g = g - (v * 0.71414f);
            float b = y + (u * 1.772f);
            f0[i] = r;
            f1[i] = g;
            f2[i] = b;
          }
        }
      }
    }
    // the DC level shift and the clamp
    for (uint32_t c = 0; c < numcomps; ++c) {
      TileComp& tc = tcs[c];
      const Res& rd = tc.res[comps[c].resno_decoded];
      const Res& top = tc.res[tc.numres - 1];
      uint32_t w = uint32_t(rd.x1 - rd.x0), h = uint32_t(rd.y1 - rd.y0);
      uint32_t stride = uint32_t(top.x1 - top.x0);
      int32_t lo, hi;
      if (comps[c].sgnd) {
        lo = -int32_t(1u << (comps[c].prec - 1));
        hi = int32_t((1u << (comps[c].prec - 1)) - 1);
      } else {
        lo = 0;
        hi = int32_t((1u << comps[c].prec) - 1);
      }
      int32_t shift = tcp.tccps[c].dc_level_shift;
      for (uint32_t j = 0; j < h; ++j) {
        int32_t* row = tc.data.data() + size_t(j) * stride;
        for (uint32_t i = 0; i < w; ++i) {
          if (tcp.tccps[c].qmfbid == 1) {
            int32_t v = wadd(row[i], shift);
            row[i] = v < lo ? lo : v > hi ? hi : v;
          } else {
            float f;
            memcpy(&f, &row[i], 4);
            if (f > float(INT32_MAX))
              row[i] = hi;
            else if (f < float(INT32_MIN))
              row[i] = lo;
            else {
              int64_t v = int64_t(lrintf(f)) + shift;
              row[i] = int32_t(v < lo ? lo : v > hi ? hi : v);
            }
          }
        }
      }
    }
  }

  // opj_tcd_update_tile_data: each component's samples at its decoded
  // resolution, 1, 2 or 4 bytes each, one component after another.
  void pack_tile(std::vector<uint8_t>& buf) {
    size_t at = 0;
    for (uint32_t c = 0; c < numcomps; ++c) {
      TileComp& tc = tcs[c];
      const Res& rd = tc.res[comps[c].resno_decoded];
      const Res& top = tc.res[tc.numres - 1];
      uint32_t w = uint32_t(rd.x1 - rd.x0), h = uint32_t(rd.y1 - rd.y0);
      uint32_t stride = uint32_t(top.x1 - top.x0);
      uint32_t sz = (comps[c].prec + 7) >> 3;
      if (sz == 3) sz = 4;
      for (uint32_t j = 0; j < h; ++j)
        for (uint32_t i = 0; i < w; ++i) {
          int32_t v = tc.data[size_t(j) * stride + i];
          if (sz == 1) {
            buf[at] = uint8_t(comps[c].sgnd ? int8_t(v) : (v & 0xff));
          } else if (sz == 2) {
            uint16_t u = uint16_t(int16_t(v));
            memcpy(&buf[at], &u, 2);
          } else {
            memcpy(&buf[at], &v, 4);
          }
          at += sz;
        }
    }
  }

  // opj_tcd_get_decoded_tile_size at the full resolution.
  uint64_t tile_size() const {
    uint64_t total = 0;
    for (uint32_t c = 0; c < numcomps; ++c) {
      const TileComp& tc = tcs[c];
      const Res& top = tc.res[tc.numres - 1];
      uint64_t sz = (comps[c].prec + 7) >> 3;
      if (sz == 3) sz = 4;
      total += uint64_t(top.x1 - top.x0) * uint64_t(top.y1 - top.y0) * sz;
    }
    return total;
  }
};

// --- Pillow's unpackers (Jpeg2KDecode.c) -------------------------------------

enum Unpacker {
  U_GRAY_L = 1, U_GRAY_I = 2, U_GRAYA_LA = 3, U_GRAY_RGB = 4, U_SRGB_RGB = 5,
  U_SYCC_RGB = 6, U_SRGBA_RGBA = 7, U_SYCCA_RGBA = 8
};

inline uint32_t pshift(uint32_t x, int n) { return n < 0 ? x >> -n : x << n; }

struct Unpack {
  const Decoder& d;
  const uint8_t* tiledata;
  uint8_t* im;  // Pillow's image: rows of im_w pixels of `pixel` bytes
  uint32_t im_w, pixel;
  uint32_t x0, y0, w, h;

  void params(uint32_t c, int target, int* shift, int* offset,
              int* csiz) const {
    const Comp& k = d.comps[c];
    *shift = target - int(k.prec);
    *offset = k.sgnd ? int(1u << (k.prec - 1)) : 0;
    *csiz = int((k.prec + 7) >> 3);
    if (*csiz == 3) *csiz = 4;
    if (*shift < 0) *offset += int(1u << (-*shift - 1));
  }
  static uint32_t word(const uint8_t* p, int csiz, size_t i) {
    if (csiz == 1) return p[i];
    if (csiz == 2) {
      uint16_t v;
      memcpy(&v, p + 2 * i, 2);
      return v;
    }
    uint32_t v;
    memcpy(&v, p + 4 * i, 4);
    return v;
  }
  uint8_t* row(uint32_t y) const {
    return im + (size_t(y0 + y) * im_w + x0) * pixel;
  }

  void gray_l() {
    int shift, offset, csiz;
    params(0, 8, &shift, &offset, &csiz);
    for (uint32_t y = 0; y < h; ++y) {
      const uint8_t* data = tiledata + size_t(csiz) * y * w;
      uint8_t* r = row(y);
      for (uint32_t x = 0; x < w; ++x)
        r[x] = uint8_t(pshift(uint32_t(offset) + word(data, csiz, x), shift));
    }
  }
  void gray_i() {
    int shift, offset, csiz;
    params(0, 16, &shift, &offset, &csiz);
    for (uint32_t y = 0; y < h; ++y) {
      const uint8_t* data = tiledata + size_t(csiz) * y * w;
      uint8_t* r = row(y);
      for (uint32_t x = 0; x < w; ++x) {
        uint16_t v = uint16_t(pshift(uint32_t(offset) + word(data, csiz, x),
                                     shift));
        memcpy(r + 2 * x, &v, 2);
      }
    }
  }
  void gray_rgb() {
    int shift, offset, csiz;
    params(0, 8, &shift, &offset, &csiz);
    for (uint32_t y = 0; y < h; ++y) {
      const uint8_t* data = tiledata + size_t(csiz) * y * w;
      uint8_t* r = row(y);
      for (uint32_t x = 0; x < w; ++x) {
        uint8_t b = uint8_t(pshift(uint32_t(offset) + word(data, csiz, x),
                                   shift));
        r[4 * x] = r[4 * x + 1] = r[4 * x + 2] = b;
        r[4 * x + 3] = 0xff;
      }
    }
  }
  void graya_la() {
    int shift, offset, csiz, ashift, aoffset, acsiz;
    params(0, 8, &shift, &offset, &csiz);
    params(1, 8, &ashift, &aoffset, &acsiz);
    const uint8_t* atile = tiledata + size_t(csiz) * w * h;
    for (uint32_t y = 0; y < h; ++y) {
      const uint8_t* data = tiledata + size_t(csiz) * y * w;
      const uint8_t* adata = atile + size_t(acsiz) * y * w;
      uint8_t* r = row(y);
      for (uint32_t x = 0; x < w; ++x) {
        uint32_t b = pshift(uint32_t(offset) + word(data, csiz, x), shift);
        r[4 * x] = r[4 * x + 1] = r[4 * x + 2] = uint8_t(b);
        r[4 * x + 3] = uint8_t(pshift(uint32_t(aoffset) +
                                      word(adata, acsiz, x), ashift));
      }
    }
  }
  // j2ku_srgb_rgb (n = 3) and j2ku_srgba_rgba (n = 4).
  void srgb(uint32_t n) {
    int shifts[4], offsets[4], csiz[4];
    uint32_t dx[4], dy[4];
    const uint8_t* cdata[4];
    const uint8_t* cptr = tiledata;
    for (uint32_t c = 0; c < n; ++c) {
      cdata[c] = cptr;
      params(c, 8, &shifts[c], &offsets[c], &csiz[c]);
      dx[c] = d.comps[c].dx;
      dy[c] = d.comps[c].dy;
      cptr += size_t(csiz[c]) * (w / dx[c]) * (h / dy[c]);
    }
    for (uint32_t y = 0; y < h; ++y) {
      const uint8_t* data[4];
      uint8_t* r = row(y);
      for (uint32_t c = 0; c < n; ++c)
        data[c] = cdata[c] + size_t(csiz[c]) * (y / dy[c]) * (w / dx[c]);
      for (uint32_t x = 0; x < w; ++x) {
        for (uint32_t c = 0; c < n; ++c)
          r[4 * x + c] = uint8_t(pshift(uint32_t(offsets[c]) +
                                        word(data[c], csiz[c], x / dx[c]),
                                        shifts[c]));
        if (n == 3) r[4 * x + 3] = 0xff;
      }
    }
  }
  void ycbcr() {
    for (uint32_t y = 0; y < h; ++y) {
      uint8_t* r = row(y);
      for (uint32_t x = 0; x < w; ++x) {
        uint8_t* p = r + 4 * x;
        int yy = p[0], cb = p[1], cr = p[2];
        int rr = yy + (gR_Cr[cr] >> 6);
        int gg = yy + ((gG_Cb[cb] + gG_Cr[cr]) >> 6);
        int bb = yy + (gB_Cb[cb] >> 6);
        p[0] = uint8_t(rr <= 0 ? 0 : rr >= 255 ? 255 : rr);
        p[1] = uint8_t(gg <= 0 ? 0 : gg >= 255 ? 255 : gg);
        p[2] = uint8_t(bb <= 0 ? 0 : bb >= 255 ? 255 : bb);
      }
    }
  }
  void run(int which) {
    switch (which) {
      case U_GRAY_L: gray_l(); break;
      case U_GRAY_I: gray_i(); break;
      case U_GRAYA_LA: graya_la(); break;
      case U_GRAY_RGB: gray_rgb(); break;
      case U_SRGB_RGB: srgb(3); break;
      case U_SYCC_RGB: srgb(3); ycbcr(); break;
      case U_SRGBA_RGBA: srgb(4); break;
      case U_SYCCA_RGBA: srgb(4); ycbcr(); break;
    }
  }
};

void put_msg(char* msg, int64_t cap, const std::string& m) {
  if (cap <= 0) return;
  size_t n = m.size() < size_t(cap - 1) ? m.size() : size_t(cap - 1);
  memcpy(msg, m.data(), n);
  msg[n] = 0;
}

}  // namespace

extern "C" {

// OpenJPEG's HT VLC tables: vlc_tbl0 then vlc_tbl1, 1024 entries each.
void gpt_j2k_set_ht_tables(const uint16_t* tables) {
  memcpy(gVlc0, tables, sizeof gVlc0);
  memcpy(gVlc1, tables + 1024, sizeof gVlc1);
}

// Pillow's YCbCr -> RGB tables (256 entries each: R_Cr, G_Cb, G_Cr, B_Cb).
void gpt_j2k_set_ycbcr(const int16_t* tables) {
  memcpy(gR_Cr, tables, 512);
  memcpy(gG_Cb, tables + 256, 512);
  memcpy(gG_Cr, tables + 512, 512);
  memcpy(gB_Cb, tables + 768, 512);
}

// The main header of the codestream at `start` of the file's `n` bytes:
// info[0..4] = x0, y0, x1, y1, numcomps, then per component (at most
// `max_comps`) dx, dy, prec, sgnd. ihdr_w / ihdr_h: the JP2 ihdr's size (0
// for a bare codestream), which SIZ must match.
int gpt_j2k_info(const uint8_t* data, int64_t n, int64_t start,
                 uint32_t ihdr_w, uint32_t ihdr_h, int64_t* info,
                 int max_comps, char* msg, int64_t msg_cap) {
  try {
    Decoder d;
    d.s = Stream{data, n, start};
    d.ihdr_w = ihdr_w;
    d.ihdr_h = ihdr_h;
    d.read_header();
    info[0] = d.x0;
    info[1] = d.y0;
    info[2] = d.x1;
    info[3] = d.y1;
    info[4] = d.numcomps;
    for (uint32_t c = 0; c < d.numcomps && int(c) < max_comps; ++c) {
      info[5 + 4 * c] = d.comps[c].dx;
      info[6 + 4 * c] = d.comps[c].dy;
      info[7 + 4 * c] = d.comps[c].prec;
      info[8 + 4 * c] = d.comps[c].sgnd;
    }
    return 0;
  } catch (const Error& e) {
    put_msg(msg, msg_cap, e.msg);
    return e.code;
  } catch (const std::bad_alloc&) {
    put_msg(msg, msg_cap, "out of memory");
    return kBroken;
  }
}

// Every tile into Pillow's image `im` (im_w x im_h pixels of `pixel`
// bytes, zeroed by the caller) through unpacker `unpacker`; end_pos gets
// the stream position after the codestream (for the JP2 boxes that
// follow).
int gpt_j2k_decode(const uint8_t* data, int64_t n, int64_t start,
                   uint32_t ihdr_w, uint32_t ihdr_h,
                   int unpacker, uint8_t* im, uint32_t im_w, uint32_t im_h,
                   uint32_t pixel, int64_t* end_pos, char* msg,
                   int64_t msg_cap) {
  try {
    Decoder d;
    d.s = Stream{data, n, start};
    d.ihdr_w = ihdr_w;
    d.ihdr_h = ihdr_h;
    d.read_header();
    std::vector<uint8_t> buffer;  // Pillow's tile buffer
    for (;;) {
      if (!d.read_tile_header()) break;
      uint32_t tileno = d.cur_tile;
      d.init_tile(tileno);
      uint64_t data_size = d.tile_size();
      int32_t tx0 = int32_t(d.tile_x0), ty0 = int32_t(d.tile_y0);
      int32_t tx1 = int32_t(d.tile_x1), ty1 = int32_t(d.tile_y1);
      if (tx0 >= tx1 || ty0 >= ty1 || tx0 < 0 || ty0 < 0 ||
          uint32_t(tx0) < d.x0 || uint32_t(ty0) < d.y0 ||
          int64_t(tx1) - d.x0 > int64_t(im_w) ||
          int64_t(ty1) - d.y0 > int64_t(im_h))
        fail("a tile outside the image (Pillow: broken data stream)");
      uint64_t tile_w = uint64_t(tx1 - tx0), tile_h = uint64_t(ty1 - ty0);
      uint64_t width = 0;
      for (uint32_t c = 0; c < d.numcomps; ++c) {
        uint32_t sz = (d.comps[c].prec + 7) >> 3;
        width += sz == 3 ? 4 : sz;
      }
      uint64_t tile_bytes = tile_w * tile_h * width;
      if (tile_bytes > 0xffffffffu) fail("a tile too large for Pillow");
      if (tile_bytes > data_size) data_size = tile_bytes;
      // Pillow's tile buffer grows as needed and is zeroed before each
      // tile, as far as the tile's data size.
      if (buffer.size() < data_size) buffer.resize(data_size);
      std::fill(buffer.begin(), buffer.begin() + data_size, 0);
      if (!d.tcps[tileno].has_data) fail("a tile without data");
      d.decode_tile(tileno);
      d.pack_tile(buffer);
      d.tcps[tileno].data.clear();
      d.tcps[tileno].data.shrink_to_fit();
      d.tcps[tileno].has_data = false;
      d.can_decode = false;
      d.state &= ~uint32_t(S_DATA);
      if (!(d.s.left() == 0 && d.state == S_NEOC) && d.state != S_EOC) {
        uint32_t m;
        if (!d.s.read2(&m)) fail("Stream too short");
        if (m == M_EOC) {
          d.cur_tile = 0;
          d.state = S_EOC;
        } else if (m != M_SOT) {
          if (d.s.left() == 0) {
            d.state = S_NEOC;
          } else {
            fail("Stream too short");
          }
        }
      }
      Unpack u{d, buffer.data(), im, im_w, pixel,
               uint32_t(tx0) - d.x0, uint32_t(ty0) - d.y0,
               uint32_t(tile_w), uint32_t(tile_h)};
      u.run(unpacker);
    }
    *end_pos = d.s.pos;
    return 0;
  } catch (const Error& e) {
    put_msg(msg, msg_cap, e.msg);
    return e.code;
  } catch (const std::bad_alloc&) {
    put_msg(msg, msg_cap, "out of memory");
    return kBroken;
  }
}

}  // extern "C"
