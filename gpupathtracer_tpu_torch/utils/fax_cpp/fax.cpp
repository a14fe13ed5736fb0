// The bilevel and 4-bit TIFF decoders of libtiff 4.7.1 that PIL (Pillow
// 12.1.0) reads through, each bit for bit libtiff's:
//
//   - CCITT (tif_fax3.c with the tables of tif_fax3sm.c): Modified Huffman
//     rows aligned to bytes (compression 2) or to 16 bits (32771), T.4 1-D
//     and 2-D with EOLs (3) and T.6 (4). The decoders keep libtiff's run
//     arrays, its resynchronisation on EOLs, its clean-up of a row that is
//     too long or too short after a bad code word, and its end of a strip:
//     data that ends in a row fails, but for T.6, which keeps the rows it
//     decoded once one is complete (a badly terminated strip).
//   - ThunderScan (tif_thunder.c): 4-bit grey in runs, 2- and 3-bit deltas
//     and raw pixels, a row at a time.
//   - Old-style LZW (tif_lzw.c LZWDecodeCompat): codes least significant
//     bit first, each width change a code later than TIFF 6.0's.
//
// C interface (ctypes): each function returns the rows it filled (the rest
// of the strip is left as it was), or -1 where libtiff fails the strip.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// --- the code tables (tif_fax3sm.c, as mkg3states builds them) ---------------

enum {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
  S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct Ent {
  uint8_t state, width;
  uint32_t param;
};

struct Code {
  const char* bits;  // the code, first bit first
  uint32_t param;
};

const Code kTermW[] = {
    {"00110101", 0},  {"000111", 1},    {"0111", 2},      {"1000", 3},
    {"1011", 4},      {"1100", 5},      {"1110", 6},      {"1111", 7},
    {"10011", 8},     {"10100", 9},     {"00111", 10},    {"01000", 11},
    {"001000", 12},   {"000011", 13},   {"110100", 14},   {"110101", 15},
    {"101010", 16},   {"101011", 17},   {"0100111", 18},  {"0001100", 19},
    {"0001000", 20},  {"0010111", 21},  {"0000011", 22},  {"0000100", 23},
    {"0101000", 24},  {"0101011", 25},  {"0010011", 26},  {"0100100", 27},
    {"0011000", 28},  {"00000010", 29}, {"00000011", 30}, {"00011010", 31},
    {"00011011", 32}, {"00010010", 33}, {"00010011", 34}, {"00010100", 35},
    {"00010101", 36}, {"00010110", 37}, {"00010111", 38}, {"00101000", 39},
    {"00101001", 40}, {"00101010", 41}, {"00101011", 42}, {"00101100", 43},
    {"00101101", 44}, {"00000100", 45}, {"00000101", 46}, {"00001010", 47},
    {"00001011", 48}, {"01010010", 49}, {"01010011", 50}, {"01010100", 51},
    {"01010101", 52}, {"00100100", 53}, {"00100101", 54}, {"01011000", 55},
    {"01011001", 56}, {"01011010", 57}, {"01011011", 58}, {"01001010", 59},
    {"01001011", 60}, {"00110010", 61}, {"00110011", 62}, {"00110100", 63}};
const Code kMakeUpW[] = {
    {"11011", 64},      {"10010", 128},     {"010111", 192},
    {"0110111", 256},   {"00110110", 320},  {"00110111", 384},
    {"01100100", 448},  {"01100101", 512},  {"01101000", 576},
    {"01100111", 640},  {"011001100", 704}, {"011001101", 768},
    {"011010010", 832}, {"011010011", 896}, {"011010100", 960},
    {"011010101", 1024}, {"011010110", 1088}, {"011010111", 1152},
    {"011011000", 1216}, {"011011001", 1280}, {"011011010", 1344},
    {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536},
    {"010011010", 1600}, {"011000", 1664},    {"010011011", 1728}};
const Code kTermB[] = {
    {"0000110111", 0},    {"010", 1},           {"11", 2},
    {"10", 3},            {"011", 4},           {"0011", 5},
    {"0010", 6},          {"00011", 7},         {"000101", 8},
    {"000100", 9},        {"0000100", 10},      {"0000101", 11},
    {"0000111", 12},      {"00000100", 13},     {"00000111", 14},
    {"000011000", 15},    {"0000010111", 16},   {"0000011000", 17},
    {"0000001000", 18},   {"00001100111", 19},  {"00001101000", 20},
    {"00001101100", 21},  {"00000110111", 22},  {"00000101000", 23},
    {"00000010111", 24},  {"00000011000", 25},  {"000011001010", 26},
    {"000011001011", 27}, {"000011001100", 28}, {"000011001101", 29},
    {"000001101000", 30}, {"000001101001", 31}, {"000001101010", 32},
    {"000001101011", 33}, {"000011010010", 34}, {"000011010011", 35},
    {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38},
    {"000011010111", 39}, {"000001101100", 40}, {"000001101101", 41},
    {"000011011010", 42}, {"000011011011", 43}, {"000001010100", 44},
    {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47},
    {"000001100100", 48}, {"000001100101", 49}, {"000001010010", 50},
    {"000001010011", 51}, {"000000100100", 52}, {"000000110111", 53},
    {"000000111000", 54}, {"000000100111", 55}, {"000000101000", 56},
    {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62},
    {"000001100111", 63}};
const Code kMakeUpB[] = {
    {"0000001111", 64},      {"000011001000", 128},  {"000011001001", 192},
    {"000001011011", 256},   {"000000110011", 320},  {"000000110100", 384},
    {"000000110101", 448},   {"0000001101100", 512}, {"0000001101101", 576},
    {"0000001001010", 640},  {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832},  {"0000001110010", 896}, {"0000001110011", 960},
    {"0000001110100", 1024}, {"0000001110101", 1088},
    {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344},
    {"0000001010100", 1408}, {"0000001010101", 1472},
    {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728}};
// The extended make-up codes, shared by both colours.
const Code kMakeUp[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};
const Code kEOL[] = {{"00000000000", 0}};  // 11 zeros; the 1 is found later
const Code kPass[] = {{"0001", 0}};
const Code kHoriz[] = {{"001", 0}};
const Code kV0[] = {{"1", 0}};
const Code kVR[] = {{"011", 1}, {"000011", 2}, {"0000011", 3}};
const Code kVL[] = {{"010", 1}, {"000010", 2}, {"0000010", 3}};
const Code kExt[] = {{"0000001", 0}};
const Code kEOLV[] = {{"0000000", 0}};

template <size_t N>
void fill_table(Ent* t, int size, const Code (&codes)[N], uint8_t state) {
  for (const Code& c : codes) {
    int w = int(strlen(c.bits));
    uint32_t v = 0;  // the code as the LSB-first accumulator holds it
    for (int i = 0; i < w; i++) v |= uint32_t(c.bits[i] == '1') << i;
    for (uint32_t idx = v; idx < (1u << size); idx += 1u << w)
      t[idx] = Ent{state, uint8_t(w), c.param};
  }
}

struct Tables {
  Ent main[128], white[4096], black[8192];
  uint8_t rev[256];
  Tables() {
    memset(main, 0, sizeof main);
    memset(white, 0, sizeof white);
    memset(black, 0, sizeof black);
    fill_table(main, 7, kPass, S_Pass);
    fill_table(main, 7, kHoriz, S_Horiz);
    fill_table(main, 7, kV0, S_V0);
    fill_table(main, 7, kVR, S_VR);
    fill_table(main, 7, kVL, S_VL);
    fill_table(main, 7, kExt, S_Ext);
    fill_table(main, 7, kEOLV, S_EOL);
    fill_table(white, 12, kMakeUpW, S_MakeUpW);
    fill_table(white, 12, kMakeUp, S_MakeUp);
    fill_table(white, 12, kTermW, S_TermW);
    fill_table(white, 12, kEOL, S_EOL);
    fill_table(black, 13, kMakeUpB, S_MakeUpB);
    fill_table(black, 13, kMakeUp, S_MakeUp);
    fill_table(black, 13, kTermB, S_TermB);
    fill_table(black, 13, kEOL, S_EOL);
    for (int i = 0; i < 256; i++) {
      int r = 0;
      for (int b = 0; b < 8; b++) r |= ((i >> b) & 1) << (7 - b);
      rev[i] = uint8_t(r);
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// libtiff's _TIFFFax3fillruns: white runs clear bits, black runs set them,
// runs past the row's end cut there (and in the run array).
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  static const uint8_t masks[] = {0x00, 0x80, 0xc0, 0xe0, 0xf0,
                                  0xf8, 0xfc, 0xfe, 0xff};
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int colour = 0; colour < 2; colour++) {
      uint32_t run = runs[colour];
      if (x + run > lastx || run > lastx) run = runs[colour] = lastx - x;
      if (!run) continue;
      uint8_t* cp = buf + (x >> 3);
      uint32_t bx = x & 7;
      if (run > 8 - bx) {
        if (bx) {
          if (colour)
            *cp++ |= uint8_t(0xff >> bx);
          else
            *cp++ &= uint8_t(0xff << (8 - bx));
          run -= 8 - bx;
        }
        uint32_t nb = run >> 3;
        memset(cp, colour ? 0xff : 0, nb);
        cp += nb;
        run &= 7;
        if (run) {
          if (colour)
            cp[0] = uint8_t((cp[0] | (0xff00 >> run)) & 0xff);
          else
            cp[0] &= uint8_t(0xff >> run);
        }
      } else {
        if (colour)
          cp[0] |= uint8_t(masks[run] >> bx);
        else
          cp[0] &= uint8_t(~(masks[run] >> bx));
      }
      x += runs[colour];
    }
  }
}

enum Mode { kRLE = 1, kRLEW = 2, kG3_1D = 3, kG3_2D = 4, kG4 = 5 };
enum Status { kDone = 0, kEof = 1, kFail = -1 };
// What a run's codes end on.
enum RunEnd { kRunStop = 0, kRunTerm = 1, kRunEof = 2 };

struct Fax {
  const Tables& T = tables();
  const uint8_t* bitmap;
  const uint8_t* cp;
  const uint8_t* ep;
  int64_t file_off;  // where the strip starts in the file (its alignment)
  const uint8_t* start;
  uint32_t acc = 0;
  int avail = 0, eolcnt = 0;
  int lastx;
  uint32_t* runs;   // 2 * nruns entries: the current and the reference row
  int64_t nruns;
  uint32_t *curruns, *refruns;
  // The row being decoded (libtiff's cached state).
  int a0 = 0, run_length = 0, b1 = 0;
  uint32_t *pa = nullptr, *thisrun = nullptr, *pb = nullptr;
  const Ent* ent = nullptr;

  bool need8(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= uint32_t(bitmap[*cp++]) << avail;
        avail += 8;
      }
    }
    return true;
  }
  bool need16(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= uint32_t(bitmap[*cp++]) << avail;
        if ((avail += 8) < n) {
          if (cp >= ep) {
            avail = n;
          } else {
            acc |= uint32_t(bitmap[*cp++]) << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int n) const { return acc & ((1u << n) - 1); }
  void clr(int n) {
    avail -= n;
    acc >>= n;
  }
  bool lookup8(int w, const Ent* t) {
    if (!need8(w)) return false;
    ent = t + get(w);
    clr(ent->width);
    return true;
  }
  bool lookup16(int w, const Ent* t) {
    if (!need16(w)) return false;
    ent = t + get(w);
    clr(ent->width);
    return true;
  }
  bool setvalue(uint32_t x) {
    if (pa >= thisrun + nruns) return false;  // "Buffer overflow"
    *pa++ = uint32_t(run_length) + x;
    a0 = int(uint32_t(a0) + x);
    run_length = 0;
    return true;
  }
  bool cleanup() {
    if (run_length && !setvalue(0)) return false;
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 = int(uint32_t(a0) - *--pa);
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if (((pa - thisrun) & 1) && !setvalue(0)) return false;
        if (!setvalue(uint32_t(lastx - a0))) return false;
      } else if (a0 > lastx) {
        if (!setvalue(uint32_t(lastx)) || !setvalue(0)) return false;
      }
    }
    return true;
  }
  // SYNC_EOL: skip to past the next EOL (its 11 zeros already read when
  // eolcnt is set): 0; 1 at the end of the data while looking for the
  // zeros; 2 when the data ends in the zeros after them (libtiff then
  // takes the strip as one without EOLs and decodes it again).
  int sync_eol() {
    if (eolcnt == 0) {
      for (;;) {
        if (!need16(11)) return 1;
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need8(8)) return 2;
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    eolcnt = 0;
    return 0;
  }
  // A run of `colour` (0 white, 1 black) in make-up and terminating codes:
  // kRunTerm on its terminating code, kRunStop on an EOL (eolcnt set) or a
  // bad code, kRunEof at the end of the data, kFail on an overflow.
  // `eol_ok`: EXPAND1D (an EOL ends the row); else EXPAND2D's horizontal
  // mode.
  int run(int colour, bool eol_ok) {
    for (;;) {
      bool ok = colour ? lookup16(13, T.black) : lookup16(12, T.white);
      if (!ok) return kRunEof;
      uint8_t s = ent->state;
      if (s == S_EOL && eol_ok) {
        eolcnt = 1;
        return kRunStop;
      }
      if (s == (colour ? S_TermB : S_TermW))
        return setvalue(ent->param) ? kRunTerm : kFail;
      if (s == (colour ? S_MakeUpB : S_MakeUpW) || s == S_MakeUp) {
        a0 += int(ent->param);
        run_length += int(ent->param);
        continue;
      }
      return kRunStop;  // unexpected
    }
  }
  // EXPAND1D; kDone or kEof (each after CLEANUP_RUNS) or kFail.
  int expand1d() {
    for (;;) {
      for (int colour = 0; colour < 2; colour++) {
        int r = run(colour, true);
        if (r == kFail) return kFail;
        if (r == kRunEof) return cleanup() ? kEof : kFail;
        if (r == kRunStop || a0 >= lastx) return cleanup() ? kDone : kFail;
      }
      if (pa[-1] == 0 && pa[-2] == 0) pa -= 2;
    }
  }
  bool check_b1() {
    if (pa != thisrun)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= refruns + nruns) return false;
        b1 = int(uint32_t(b1) + pb[0] + pb[1]);
        pb += 2;
      }
    return true;
  }
  // EXPAND2D; kDone or kEof (each after CLEANUP_RUNS) or kFail.
  int expand2d() {
    auto eof = [&]() { return cleanup() ? kEof : kFail; };
    auto eol = [&]() { return cleanup() ? kDone : kFail; };
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) return kFail;
      if (!lookup8(7, T.main)) return eof();
      switch (ent->state) {
        case S_Pass:
          if (!check_b1()) return kFail;
          if (pb + 1 >= refruns + nruns) return kFail;
          b1 = int(uint32_t(b1) + *pb++);
          run_length = int(uint32_t(run_length) + uint32_t(b1 - a0));
          a0 = b1;
          b1 = int(uint32_t(b1) + *pb++);
          break;
        case S_Horiz: {
          int first = (pa - thisrun) & 1;
          for (int c : {first, 1 - first}) {
            int r = run(c, false);
            if (r == kFail) return kFail;
            if (r == kRunEof) return eof();
            if (r == kRunStop) return eol();  // a bad code word
          }
          if (!check_b1()) return kFail;
          break;
        }
        case S_V0:
        case S_VR:
          if (!check_b1()) return kFail;
          if (!setvalue(uint32_t(b1 - a0) +
                        (ent->state == S_VR ? ent->param : 0)))
            return kFail;
          if (pb >= refruns + nruns) return kFail;
          b1 = int(uint32_t(b1) + *pb++);
          break;
        case S_VL:
          if (!check_b1()) return kFail;
          if (b1 < int(uint32_t(a0) + ent->param)) return eol();
          if (!setvalue(uint32_t(b1 - a0) - ent->param)) return kFail;
          if (pb - 1 < runs) return kFail;  // before libtiff's buffer
          b1 = int(uint32_t(b1) - *--pb);
          break;
        case S_Ext:
          *pa++ = uint32_t(lastx - a0);
          return eol();
        case S_EOL:
          *pa++ = uint32_t(lastx - a0);
          if (!need8(4)) return eof();
          clr(4);
          eolcnt = 1;
          return eol();
        default:
          return eol();
      }
    }
    if (run_length) {
      if (run_length + a0 < lastx) {
        if (!need8(1)) return eof();
        if (!get(1)) return eol();
        clr(1);
      }
      if (!setvalue(0)) return kFail;
    }
    return eol();
  }
  void row_start() {
    a0 = 0;
    run_length = 0;
  }
};

}  // namespace

extern "C" {

// One CCITT strip or tile: `rows` rows of `rowbytes` bytes into `out`,
// `width` pixels a row. mode: 1 compression 2 (rows byte-aligned), 2
// 32771 (16-bit aligned, by the file offset `file_off` of the strip), 3
// T.4 1-D, 4 T.4 2-D, 5 T.6. fill_order 2: the bits of each byte least
// significant first. `runs` holds 2 * nruns entries and `noeol` one flag,
// both living as long as the image (libtiff allocates the runs once a
// directory, zeroed; a T.4 strip found without EOLs sets the flag, and
// the strips after it are decoded without them too).
int64_t gpt_fax(const uint8_t* src, int64_t n, int32_t mode,
                int32_t fill_order, int64_t file_off, int32_t width,
                uint8_t* out, int64_t rows, int64_t rowbytes, uint32_t* runs,
                int64_t nruns, int32_t* noeol) {
  Fax f;
  f.bitmap = fill_order == 2 ? nullptr : f.T.rev;
  static uint8_t ident[256];
  if (!f.bitmap) {
    for (int i = 0; i < 256; i++) ident[i] = uint8_t(i);
    f.bitmap = ident;
  }
  f.cp = f.start = src;
  f.ep = src + n;
  f.file_off = file_off;
  f.lastx = width;
  f.runs = runs;
  f.nruns = nruns;
  f.curruns = runs;
  f.refruns = nullptr;
  if (mode >= kG3_2D) {
    f.refruns = runs + nruns;
    f.refruns[0] = uint32_t(width);
    f.refruns[1] = 0;
  }
  for (int64_t line = 0; line < rows; line++) {
    uint8_t* buf = out + line * rowbytes;
    f.row_start();
    f.pa = f.thisrun = f.curruns;
    if (mode == kRLE || mode == kRLEW) {
      int r = f.expand1d();
      if (r == kFail) return -1;
      fill_runs(buf, f.thisrun, f.pa, uint32_t(width));
      if (r == kEof) return -1;
      if (mode == kRLE) {
        f.clr(f.avail - (f.avail & ~7));
      } else {
        f.clr(f.avail - (f.avail & ~15));
        if (f.avail == 0 && ((f.file_off + (f.cp - f.start)) & 1)) f.cp++;
      }
      continue;
    }
    if (mode == kG3_1D || mode == kG3_2D) {
      int sync = *noeol ? 0 : f.sync_eol();
      if (sync == 2) {
        // No EOL: libtiff decodes the strip again from its start, from
        // this row on, without looking for EOLs.
        *noeol = 1;
        f.cp = f.start;
        f.acc = 0;
        f.avail = 0;
        f.eolcnt = 0;
        line--;
        continue;
      }
      bool is1d = mode == kG3_1D;
      if (sync == 0 && !is1d) {
        if (f.need8(1)) {
          is1d = f.get(1);
          f.clr(1);
        } else {
          sync = 1;
        }
      }
      if (sync == 1) {
        if (!f.cleanup()) return -1;
        fill_runs(buf, f.thisrun, f.pa, uint32_t(width));
        return -1;
      }
      if (mode == kG3_2D) {
        f.pb = f.refruns;
        f.b1 = int(*f.pb++);
      }
      int r = is1d ? f.expand1d() : f.expand2d();
      if (r == kFail) return -1;
      fill_runs(buf, f.thisrun, f.pa, uint32_t(width));
      if (r == kEof) return -1;
      if (mode == kG3_2D) {
        if (f.pa < f.thisrun + f.nruns) f.setvalue(0);
        uint32_t* t = f.curruns;
        f.curruns = f.refruns;
        f.refruns = t;
      }
      continue;
    }
    // T.6
    f.pb = f.refruns;
    f.b1 = int(*f.pb++);
    int r = f.expand2d();
    if (r == kFail) return -1;
    if (r == kEof || f.eolcnt) {
      // EOFG4: past the EOFB, the row filled; the strip is good if a row
      // before this one was decoded.
      f.need16(13);
      f.clr(13);
      fill_runs(buf, f.thisrun, f.pa, uint32_t(width));
      return line ? line + 1 : -1;
    }
    fill_runs(buf, f.thisrun, f.pa, uint32_t(width));
    if (!f.setvalue(0)) return -1;
    uint32_t* t = f.curruns;
    f.curruns = f.refruns;
    f.refruns = t;
  }
  return rows;
}

// One ThunderScan strip: `rows` rows of `width` 4-bit pixels, (width + 1)
// / 2 bytes each, as libtiff's ThunderDecodeRow decodes it (a run past the
// row's end is not written). Returns rows, or -1 where a row has not
// enough or too much data.
int64_t gpt_thunderscan(const uint8_t* src, int64_t n, int32_t width,
                        uint8_t* out, int64_t rows) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const uint8_t* bp = src;
  int64_t cc = n, row_bytes = (int64_t(width) + 1) / 2;
  for (int64_t r = 0; r < rows; r++) {
    uint8_t* op0 = out + r * row_bytes;
    uint8_t* op = op0;
    unsigned lastpixel = 0;
    int64_t npixels = 0, maxpixels = width;
    auto setpixel = [&](unsigned v) {
      lastpixel = v & 0xf;
      if (npixels < maxpixels) {
        if (npixels++ & 1)
          *op++ |= uint8_t(lastpixel);
        else
          op[0] = uint8_t(lastpixel << 4);
      }
    };
    while (cc > 0 && npixels < maxpixels) {
      int k = *bp++, delta;
      cc--;
      switch (k & 0xc0) {
        case 0x00: {  // a run of the last pixel, k & 0x3f long
          int m = k & 0x3f;
          if (npixels & 1) {
            op[0] |= uint8_t(lastpixel);
            lastpixel = *op++;
            npixels++;
            m--;
          } else {
            lastpixel |= lastpixel << 4;
          }
          npixels += m;
          if (npixels <= maxpixels)
            for (; m > 0; m -= 2) *op++ = uint8_t(lastpixel);
          if (m == -1) *--op &= 0xf0;
          lastpixel &= 0xf;
          break;
        }
        case 0x40:  // three 2-bit deltas
          if ((delta = (k >> 4) & 3) != 2)
            setpixel(unsigned(int(lastpixel) + two[delta]));
          if ((delta = (k >> 2) & 3) != 2)
            setpixel(unsigned(int(lastpixel) + two[delta]));
          if ((delta = k & 3) != 2)
            setpixel(unsigned(int(lastpixel) + two[delta]));
          break;
        case 0x80:  // two 3-bit deltas
          if ((delta = (k >> 3) & 7) != 4)
            setpixel(unsigned(int(lastpixel) + three[delta]));
          if ((delta = k & 7) != 4)
            setpixel(unsigned(int(lastpixel) + three[delta]));
          break;
        default:  // a raw pixel
          setpixel(unsigned(k));
          break;
      }
    }
    if (npixels != maxpixels) {
      if (op < op0 + row_bytes) memset(op, 0, size_t(op0 + row_bytes - op));
      return -1;
    }
  }
  return rows;
}

// An old-style LZW strip or tile into `occ` bytes, as LZWDecodeCompat
// decodes it after LZWPreDecode: 0, or -1 where libtiff fails (a corrupt
// table, data that ends before the output is full).
int64_t gpt_lzw_compat(const uint8_t* src, int64_t n, uint8_t* out,
                       int64_t occ) {
  struct CodeEnt {
    int32_t next;  // index of the prefix's entry, -1 for none
    uint16_t length;
    uint8_t value, firstchar;
  };
  const int kClear = 256, kEoi = 257, kFirst = 258, kSize = 4095 + 1024;
  std::vector<CodeEnt> tab(kSize, CodeEnt{-1, 0, 0, 0});
  for (int c = 0; c < 256; c++)
    tab[c] = CodeEnt{-1, 1, uint8_t(c), uint8_t(c)};
  const int kNone = -2;  // &dec_codetab[-1]
  int nbits = 9, free_ent = kFirst, oldcode = kNone;
  int64_t nbitsmask = 511, maxcode = 511 - 1;
  uint64_t nextdata = 0, bitsleft = uint64_t(n) << 3;
  int64_t nextbits = 0;
  const uint8_t* bp = src;
  uint8_t* op = out;
  auto next_code = [&]() -> int {
    if (bitsleft < uint64_t(nbits)) return kEoi;  // not terminated with EOI
    nextdata |= uint64_t(*bp++) << nextbits;
    nextbits += 8;
    if (nextbits < nbits) {
      nextdata |= uint64_t(*bp++) << nextbits;
      nextbits += 8;
    }
    int code = int(nextdata & uint64_t(nbitsmask));
    nextdata >>= nbits;
    nextbits -= nbits;
    bitsleft -= uint64_t(nbits);
    return code;
  };
  while (occ > 0) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int i = kFirst; i < kSize; i++) tab[i] = CodeEnt{-1, 0, 0, 0};
        nbits = 9;
        nbitsmask = 511;
        maxcode = nbitsmask;
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return -1;
      *op++ = uint8_t(code);
      occ--;
      oldcode = code;
      continue;
    }
    if (free_ent >= kSize || oldcode < 0) return -1;
    CodeEnt& fe = tab[free_ent];
    fe.next = oldcode;
    fe.firstchar = tab[oldcode].firstchar;
    fe.length = uint16_t(tab[oldcode].length + 1);
    fe.value = code < free_ent ? tab[code].firstchar : fe.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > 12) nbits = 12;
      nbitsmask = (int64_t(1) << nbits) - 1;
      maxcode = nbitsmask;
    }
    oldcode = code;
    if (code >= 256) {
      int c = code;
      if (tab[c].length == 0) return -1;
      if (tab[c].length > occ) {
        do c = tab[c].next;
        while (tab[c].length > occ);
        uint8_t* tp = op + occ;
        do {
          *--tp = tab[c].value;
          c = tab[c].next;
        } while (--occ);
        break;
      }
      int len = tab[c].length;
      uint8_t* tp = op + len;
      do {
        *--tp = tab[c].value;
        c = tab[c].next;
      } while (c >= 0 && tp > op);
      op += len;
      occ -= len;
    } else {
      *op++ = uint8_t(code);
      occ--;
    }
  }
  return occ > 0 ? -1 : 0;
}

}  // extern "C"
