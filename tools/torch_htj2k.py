"""A small HTJ2K (ITU-T T.814) codestream writer for the port's JPEG 2000
fixtures and tests: OpenJPEG 2.5.4 decodes HT code-blocks but writes
none, and no other encoder in reach does.

- ``encode_block``: one code-block's HT cleanup pass (MEL, VLC with its
  two context tables and the UVLC, MagSgn) and, below it, the SigProp and
  MagRef passes of one more bit-plane; each pass is written by running the
  decoder's own scan (OpenJPEG's ht_dec.c order) and emitting the bits it
  reads, so its membership and line-state rules are the decoder's.
- ``write_codestream``: SIZ, CAP, COD (code-block style 0x40), QCD, tiles
  of LRCP packets with tag trees and Lblock lengths, over a forward 5/3
  (with RCT: lossless) or 9/7 (with ICT, a step size a band) wavelet.
- ``vlc_tables``: the decoder's VLC tables (utils/ht_vlc.bin, written by
  ``python tools/torch_image_fixtures.py --ht-vlc-table``).

Quantization indices sit in OpenJPEG's layout: the cleanup pass carries a
coefficient's bits from plane ``p`` up (p = 1: every bit; p = 2: the
refinement passes carry plane 0), and the packet header's zero bit-planes
are ``Mb - p``, as OpenJPEG reads p back (numbps).
"""

from __future__ import annotations

import os
import struct

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VLC_BIN = os.path.join(REPO, "gpupathtracer_tpu_torch", "utils",
                       "ht_vlc.bin")
MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)


def vlc_tables() -> tuple:
    t = np.fromfile(VLC_BIN, "<u2").astype(np.int64)
    return t[:1024], t[1024:]


def find_vlc_tables(blob: bytes) -> bytes:
    """The two 1024-entry uint16 VLC tables (initial and later quad rows)
    in an OpenJPEG library image: the first offset where two adjacent
    tables each decode as a prefix code (every index agrees with the
    entry its codeword's length selects) with every entry set, and each
    entry's EMB patterns lie inside its significance pattern."""
    u = np.frombuffer(blob[:len(blob) // 2 * 2], "<u2").astype(np.int64)
    rho, e1, ek = (u >> 4) & 15, (u >> 8) & 15, (u >> 12) & 15
    ok = ((e1 & ~rho) == 0) & ((ek & ~rho) == 0) & ((u & 7) > 0)
    run = np.convolve(ok, np.ones(2048, np.int64), "valid") == 2048

    def prefix_code(t):
        idx = np.arange(1024)
        length = t & 7
        base = (idx >> 7 << 7) | (idx & ((1 << length) - 1))
        return bool((t[base] == t).all())
    for s in np.flatnonzero(run):
        t0, t1 = u[s:s + 1024], u[s + 1024:s + 2048]
        if prefix_code(t0) and prefix_code(t1) and t0[0] != t1[0]:
            return u[s:s + 2048].astype("<u2").tobytes()
    raise ValueError("no HT VLC tables in this library")


# --- bit writers -------------------------------------------------------------

class _Fwd:
    """MagSgn and SigProp: bits LSB first, a byte after 0xFF carries 7."""

    def __init__(self):
        self.out, self.cur, self.n, self.cap = bytearray(), 0, 0, 8

    def put(self, v: int, n: int = 1) -> None:
        for i in range(n):
            self.cur |= ((v >> i) & 1) << self.n
            self.n += 1
            if self.n == self.cap:
                self._byte()

    def _byte(self):
        self.out.append(self.cur)
        self.cap = 7 if self.cur == 0xFF else 8
        self.cur = self.n = 0

    def done(self, fill: int) -> bytes:
        if self.n:
            while self.n < self.cap:
                self.cur |= fill << self.n
                self.n += 1
            self._byte()
        return bytes(self.out)


class _Rev:
    """VLC and MagRef: bits LSB first into bytes read backwards; after a
    byte above 0x8F, seven 1s end a byte (its MSB a stuffed 0). The VLC
    starts in the upper nibble of the byte before Scup's last."""

    def __init__(self, nibble: bool):
        self.units, self.cur, self.n = [], 0, 0
        self.big = True
        self.nibble = nibble

    def put(self, v: int, n: int = 1) -> None:
        for i in range(n):
            self.cur |= ((v >> i) & 1) << self.n
            self.n += 1
            if self.nibble and not self.units:
                if (self.n == 3 and self.cur == 7) or self.n == 4:
                    self.units.append(self.cur)
                    self.big = self.cur >= 9
                    self.cur = self.n = 0
            elif (self.n == 7 and self.big and self.cur == 0x7F) or \
                    self.n == 8:
                self.units.append(self.cur)
                self.big = self.cur > 0x8F
                self.cur = self.n = 0

    def done(self) -> list:
        if self.n or (self.nibble and not self.units):
            self.units.append(self.cur)
            self.cur = self.n = 0
        return self.units


class _Mel:
    def __init__(self):
        self.k = self.run = 0
        self.out, self.cur, self.n, self.cap = bytearray(), 0, 0, 8

    def _bit(self, b):
        self.cur = (self.cur << 1) | b
        self.n += 1
        if self.n == self.cap:
            self.out.append(self.cur)
            self.cap = 7 if self.cur == 0xFF else 8
            self.cur = self.n = 0

    def event(self, b: int) -> None:
        e = MEL_EXP[self.k]
        if not b:
            self.run += 1
            if self.run == 1 << e:
                self._bit(1)
                self.run = 0
                self.k = min(self.k + 1, 12)
        else:
            self._bit(0)
            for i in range(e - 1, -1, -1):
                self._bit((self.run >> i) & 1)
            self.run = 0
            self.k = max(self.k - 1, 0)

    def done(self) -> bytes:
        if self.run:
            self._bit(1)
        while self.n:
            self._bit(0)
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)
        return bytes(self.out)


def _uvlc(u: int) -> tuple:
    """The prefix and suffix (bits, length) of u >= 1."""
    if u == 1:
        return (1, 1), (0, 0)
    if u == 2:
        return (2, 2), (0, 0)
    if u <= 4:
        return (4, 3), (u - 3, 1)
    return (0, 3), (u - 5, 5)


# --- one code-block ----------------------------------------------------------

def _bitlen(v: int) -> int:
    return int(v).bit_length()


class _Tables:
    """Per context and (rho, u_off): the codewords, shortest first."""

    def __init__(self):
        self.t = []
        for tbl in vlc_tables():
            d = {}
            for i in range(1024):
                e = int(tbl[i])
                length = e & 7
                key = (i >> 7, (e >> 4) & 15, (e >> 3) & 1)
                entry = (length, i & ((1 << length) - 1), (e >> 12) & 15,
                         (e >> 8) & 15)
                d.setdefault(key, set()).add(entry)
            self.t.append({k: sorted(v) for k, v in d.items()})

    def pick(self, which, cq, rho, uoff, emax_set) -> tuple:
        """(length, codeword, e_k, e_1): the shortest whose EMB is valid:
        e_1 marks the samples of e_k at the exponent U (emax_set); EMB
        bits are avoided where U is 1."""
        for length, cwd, ek, e1 in self.t[which][(cq, rho, uoff)]:
            if e1 == ek & emax_set[0] and (ek == 0 or emax_set[1] > 1):
                return length, cwd, ek, e1
        raise ValueError(f"no VLC codeword for {cq, rho, uoff}")


_TABLES = None


def encode_block(mag: np.ndarray, neg: np.ndarray, p: int = 1,
                 passes: int = 1, causal: bool = False) -> tuple:
    """HT passes of one code-block of quantization index magnitudes `mag`
    (int, [h, w]) and signs `neg`: the cleanup pass carries mag >> (p - 1)
    (p is 1 or 2); with p = 2, passes 2 and 3 add SigProp and MagRef for
    plane 0. Returns (cleanup bytes, refinement bytes)."""
    global _TABLES
    if _TABLES is None:
        _TABLES = _Tables()
    h, w = mag.shape
    mu = (mag >> (p - 1)).astype(np.int64)
    mel, vlc, ms = _Mel(), _Rev(True), _Fwd()
    nq = (w + 1) // 2
    ls = [0] * (nq + 3)                      # the decoder's line_state
    sig = np.zeros((h + 2, w + 2), bool)     # cleanup significance

    def quad(x, y):
        rho, es, vs = 0, [0] * 4, [0] * 4
        for n, (dx, dy) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            if x + dx < w and y + dy < h and mu[y + dy, x + dx]:
                m = int(mu[y + dy, x + dx])
                rho |= 1 << n
                es[n] = _bitlen(2 * m - 1)
                vs[n] = 2 * (m - 1) + int(neg[y + dy, x + dx])
                sig[y + dy, x + dx] = True
        return rho, es, vs

    for y in range(0, h, 2):
        first = y == 0
        ls0 = ls[0]
        if not first:
            ls[0] = 0
        else:
            ls[0] = 0
        cq = 0
        for x in range(0, w, 4):
            qs = [quad(x, y), quad(x + 2, y) if x + 2 < w else (0, [0] * 4,
                                                                 [0] * 4)]
            U, kappa = [1, 1], [1, 1]
            q_idx = x // 2
            for k in range(2):
                rho, es, _ = qs[k]
                if not first and rho & (rho - 1):
                    if k == 0:
                        E = max(ls0 & 0x7F, ls[q_idx + 1] & 0x7F)
                    else:
                        E = max(ls[q_idx + 1] & 0x7F, ls[q_idx + 2] & 0x7F)
                    kappa[k] = max(1, E - 1)
                U[k] = max(max(es), kappa[k])
            u = [U[k] - kappa[k] if qs[k][0] else 0 for k in range(2)]
            cws = []
            for k in range(2):
                if k == 1 and x + 2 >= w:
                    break
                rho, es, vs = qs[k]
                if not first:
                    if k == 0:
                        cq |= (ls0 >> 7) | ((ls[q_idx + 1] >> 5) & 4)
                    else:
                        cq |= (ls[q_idx + 1] >> 7) | ((ls[q_idx + 2] >> 5) & 4)
                if cq == 0:
                    mel.event(1 if rho else 0)
                if rho or cq:
                    emax = sum(1 << n for n in range(4) if es[n] == U[k] and
                               rho >> n & 1)
                    cw = _TABLES.pick(0 if first else 1, cq, rho,
                                      1 if u[k] else 0, (emax, U[k]))
                    cws.append(cw)
                    vlc.put(cw[1], cw[0])
                else:
                    cws.append((0, 0, 0, 0))
                if first:
                    cq = ((rho | rho >> 1) & 1) | (rho >> 1 & 2) | \
                        (rho >> 1 & 4)
                else:
                    cq = (((rho >> 2) & 1) | ((rho >> 3) & 1)) << 1
            if len(cws) == 1:
                cws.append((0, 0, 0, 0))
            mode = (1 if u[0] else 0) | (2 if u[1] else 0)
            if mode == 3 and first:
                both = u[0] > 2 and u[1] > 2
                mel.event(1 if both else 0)
                if both:
                    (p1, s1), (p2, s2) = _uvlc(u[0] - 2), _uvlc(u[1] - 2)
                    vlc.put(*p1)
                    vlc.put(*p2)
                    vlc.put(*s1)
                    vlc.put(*s2)
                else:
                    p1, s1 = _uvlc(u[0])
                    vlc.put(*p1)
                    if u[0] > 2:
                        vlc.put(u[1] - 1, 1)
                        vlc.put(*s1)
                    else:
                        p2, s2 = _uvlc(u[1])
                        vlc.put(*p2)
                        vlc.put(*s1)
                        vlc.put(*s2)
            elif mode == 3:
                (p1, s1), (p2, s2) = _uvlc(u[0]), _uvlc(u[1])
                vlc.put(*p1)
                vlc.put(*p2)
                vlc.put(*s1)
                vlc.put(*s2)
            elif mode:
                pf, sf = _uvlc(u[0] if mode == 1 else u[1])
                vlc.put(*pf)
                vlc.put(*sf)
            if not first:
                ls0 = ls[q_idx + 2]
                ls[q_idx + 1] = ls[q_idx + 2] = 0
            # MagSgn, and the line state as the decoder keeps it
            for k in range(2):
                rho, es, vs = qs[k]
                ek, e1 = cws[k][2], cws[k][3]
                qi = q_idx + k
                for n in range(4):
                    if n == 3 and first:
                        ls[qi + 1] = 0
                    if not rho >> n & 1:
                        continue
                    m_n = U[k] - (ek >> n & 1)
                    ms.put(vs[n], m_n)
                    if n == 1:
                        ls[qi] = 0x80 | max(ls[qi] & 0x7F, es[n])
                    elif n == 3:
                        ls[qi + 1] = 0x80 | es[n]
    cleanup_ms = ms.done(1)
    mel_b = mel.done()
    units = vlc.done()
    nib, rest = units[0], units[1:]
    scup = len(mel_b) + len(rest) + 2
    if scup > 4079:
        raise ValueError("a code-block too large for one HT cleanup pass")
    cup = cleanup_ms + mel_b + bytes(reversed(rest)) + bytes(
        [(nib << 4) | (scup & 0xF), scup >> 4])
    if passes == 1:
        return cup, b""
    spp, mrp = _refine(mag, neg, sig[:h, :w], passes, causal)
    return cup, spp + mrp


# Where a sample that turns significant in SigProp makes its neighbours
# members, by its row in the stripe: (row step, column step), the rows of
# its own column below it and the next column's beside it.
_SPREAD = (((0, 1), (1, 0), (1, 1)), ((-1, 1), (0, 1), (1, 1), (1, 0)),
           ((-1, 1), (0, 1), (1, 1), (1, 0)), ((-1, 1), (0, 1)))


def _refine(mag, neg, sig, passes, causal) -> tuple:
    """SigProp (and with 3 passes MagRef) of plane 0 below a cleanup at
    p = 2, in the decoder's stripe order (ht_dec.c's non-causal
    membership, propagation across columns and stripes)."""
    h, w = mag.shape
    bit0 = (mag & 1).astype(bool)
    sp, mr = _Fwd(), _Rev(False)
    if passes > 2:
        for y0 in range(0, h, 4):
            for x0 in range(0, w, 8):
                for x in range(x0, min(x0 + 8, w)):
                    for y in range(y0, min(y0 + 4, h)):
                        if sig[y, x]:
                            mr.put(int(bit0[y, x]))
    # membership and significance in 4-row stripes, 8-column words
    nst = (h + 3) // 4
    member = np.zeros((nst + 1, 4, w + 9), bool)
    sgn = np.zeros((nst + 1, 4, w + 9), bool)
    for s in range(nst):
        for r in range(4):
            y = 4 * s + r
            if y < h:
                sgn[s, r, :w] = sig[y]
    for s in range(nst):                 # mbr: within the stripe
        z = sgn[s].copy()
        z[:, 1:] |= sgn[s, :, :-1]
        z[:, :-1] |= sgn[s, :, 1:]
        zz = z.copy()
        zz[1:] |= z[:-1]
        zz[:-1] |= z[1:]
        member[s] = zz & ~sgn[s]
    new_all = np.zeros((nst + 1, 4, w + 9), bool)
    for s in range(nst):
        rows = min(4, h - 4 * s)
        if s + 1 < nst and not causal:    # the next stripe's first row
            t = sgn[s + 1, 0].copy()
            t[1:] |= sgn[s + 1, 0, :-1]
            t[:-1] |= sgn[s + 1, 0, 1:]
            member[s, 3] |= t
        member[s] &= ~sgn[s]
        mb = member[s]
        mb[rows:] = False
        for x0 in range(0, w, 8):
            for n in (0, 4):
                cols = range(x0 + n, min(x0 + n + 4, w))
                news = []
                for x in cols:
                    for r in range(4):
                        if not mb[r, x]:
                            continue
                        b = bool(bit0[4 * s + r, x]) if r < rows else False
                        sp.put(int(b))
                        if b:
                            news.append((r, x))
                            new_all[s, r, x] = True
                            for dr, dx in _SPREAD[r]:
                                rr, xx = r + dr, x + dx
                                if rr < rows and xx < w + 8 and not \
                                        sgn[s, rr, xx]:
                                    mb[rr, xx] = True
                for r, x in news:
                    sp.put(int(neg[4 * s + r, x]))
        # the last row's significance enters the next stripe's first row
        if s + 1 < nst:
            last = new_all[s, 3] | sgn[s, 3]
            t = last.copy()
            t[1:] |= last[:-1]
            t[:-1] |= last[1:]
            member[s + 1, 0] |= t & ~sgn[s + 1, 0]
    return sp.done(0), bytes(reversed(mr.done()))


# --- tier 2: tag trees and packet headers ------------------------------------

class _Bio:
    """Packet header bits, MSB first; a byte after 0xFF carries 7."""

    def __init__(self):
        self.out, self.cur, self.n, self.cap = bytearray(), 0, 0, 8

    def put(self, v: int, n: int = 1) -> None:
        for i in range(n - 1, -1, -1):
            self.cur = (self.cur << 1) | ((v >> i) & 1)
            self.n += 1
            if self.n == self.cap:
                self.out.append(self.cur)
                self.cap = 7 if self.cur == 0xFF else 8
                self.cur = self.n = 0

    def done(self) -> bytes:
        while self.n:
            self.put(0)
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)
        return bytes(self.out)


class _TagTree:
    """opj_tgt_encode over a w x h grid of leaf values."""

    def __init__(self, values: np.ndarray):
        self.levels = [values.astype(np.int64)]
        while self.levels[-1].size > 1:
            v = self.levels[-1]
            hh, ww = (v.shape[0] + 1) // 2, (v.shape[1] + 1) // 2
            pad = np.full((2 * hh, 2 * ww), 1 << 30, np.int64)
            pad[:v.shape[0], :v.shape[1]] = v
            self.levels.append(pad.reshape(hh, 2, ww, 2).min(axis=(1, 3)))
        self.low = [np.zeros_like(v) for v in self.levels]
        self.known = [np.zeros(v.shape, bool) for v in self.levels]

    def encode(self, bio: _Bio, y: int, x: int, threshold: int) -> None:
        path = [(len(self.levels) - 1 - k, y >> (len(self.levels) - 1 - k),
                 x >> (len(self.levels) - 1 - k))
                for k in range(len(self.levels))]
        low = 0
        for lv, yy, xx in path:
            if low > self.low[lv][yy, xx]:
                self.low[lv][yy, xx] = low
            else:
                low = int(self.low[lv][yy, xx])
            while low < threshold:
                if low >= self.levels[lv][yy, xx]:
                    if not self.known[lv][yy, xx]:
                        bio.put(1)
                        self.known[lv][yy, xx] = True
                    break
                bio.put(0)
                low += 1
            self.low[lv][yy, xx] = low


def _numpasses(bio: _Bio, n: int) -> None:
    if n == 1:
        bio.put(0)
    elif n == 2:
        bio.put(2, 2)
    elif n <= 5:
        bio.put(3, 2)
        bio.put(n - 3, 2)
    elif n <= 36:
        bio.put(15, 4)
        bio.put(n - 6, 5)
    else:
        bio.put(0x1FF, 9)
        bio.put(n - 37, 7)


# --- the wavelets ------------------------------------------------------------

def _fwd53(x: np.ndarray) -> np.ndarray:
    """One level of the reversible 5/3 along axis 0 (even start, symmetric
    extension): the low then the high coefficients."""
    n = x.shape[0]
    if n == 1:
        return x.copy()
    s, d = x[0::2].copy(), x[1::2].copy()
    nd = d.shape[0]
    right = np.concatenate([s[1:], s[-1:]])[:nd] if n % 2 == 0 else s[1:]
    d = d - ((s[:nd] + right) >> 1)
    left = np.concatenate([d[:1], d])[:s.shape[0]]
    here = np.concatenate([d, d[-1:]])[:s.shape[0]]
    return np.concatenate([s + ((left + here + 2) >> 2), d])


ALPHA, BETA = -1.586134342, -0.052980118
GAMMA, DELTA, K = 0.882911075, 0.443506852, 1.230174105


def _fwd97(x: np.ndarray) -> np.ndarray:
    """One level of the 9/7 along axis 0 (even start, symmetric extension),
    in float64: OpenJPEG's inverse scales the low band by K and the high
    band by 2 / K."""
    n = x.shape[0]
    if n == 1:
        return x.copy()
    period = 2 * (n - 1)
    idx = np.abs((np.arange(-4, n + 4) + period) % period)
    idx = np.where(idx >= n, period - idx, idx)
    y = x[idx].astype(np.float64)
    for c, odd in ((ALPHA, 1), (BETA, 0), (GAMMA, 1), (DELTA, 0)):
        at = np.arange(1, y.shape[0] - 1)
        at = at[(at - 4) % 2 == odd]
        y[at] = y[at] + c * (y[at - 1] + y[at + 1])
    core = y[4:4 + n]
    return np.concatenate([core[0::2] / K, core[1::2] * (K / 2)])


def dwt2(img: np.ndarray, levels: int, real: bool) -> np.ndarray:
    """Mallat levels of each LL in turn."""
    out = img.astype(np.float64 if real else np.int64).copy()
    h, w = out.shape
    fn = _fwd97 if real else _fwd53
    for _ in range(levels):             # columns, then rows: the
        if h > 1:                       # inverse's order reversed
            out[:h, :w] = fn(out[:h, :w])
        if w > 1:
            out[:h, :w] = fn(out[:h, :w].T).T
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


# --- the codestream ----------------------------------------------------------

def _seg(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def _bands(w: int, h: int, levels: int) -> list:
    """(resolution, band number, x0, y0, x1, y1) of a tile whose origin is
    a multiple of 2^levels, in the Mallat layout of dwt2, by resolution."""
    out = [(0, 0, 0, 0, -(-w >> levels), -(-h >> levels))]
    for r in range(1, levels + 1):
        lv = levels - r
        pw, ph = -(-w >> (lv + 1)), -(-h >> (lv + 1))   # the lower level
        cw, ch = -(-w >> lv), -(-h >> lv)
        out += [(r, 1, pw, 0, cw, ph), (r, 2, 0, ph, pw, ch),
                (r, 3, pw, ph, cw, ch)]
    return out


def _edges(start: int, n: int, size: int) -> list:
    """The code-blocks' local (begin, end) along a band of n coefficients
    whose first sits at `start` on a grid of `size`."""
    out, at = [], 0
    while at < max(n, 1):
        end = min(n, at + size - (start + at) % size)
        out.append((at, max(end, at)))
        if end <= at:
            break
        at = end
    return out


def write_codestream(planes, levels: int = 2, cblk=(4, 4), tile=None,
                     real: bool = False, layers: int = 1, p: int = 1,
                     passes: int = 1, style: int = 0x40, split=False,
                     steps=None, late: bool = False, zb_shift: int = 0,
                     extra_passes: int = 0) -> bytes:
    """An HTJ2K codestream (Rsiz and CAP of Part 15) of same-size 8-bit
    planes: 5/3 (lossless with p = 1) or 9/7 (`real`; band b's step
    2^-steps[b], default 1), RCT / ICT for 3 or more planes, tiles of
    `tile` = (w, h) (multiples of 2^levels), code-blocks of 2^cblk, LRCP
    packets over `layers` layers: every pass in the first, or with
    `split` the cleanup pass in the first and the refinement passes in
    the second; with `late`, resolution r's code-blocks first in layer
    min(r, layers - 1). `style` is COD's code-block style byte. For
    OpenJPEG's checks: `zb_shift` added to the signalled zero
    bit-planes, `extra_passes` added to each code-block's passes (bytes
    of none). The guard bits are the fewest of 2 or more that hold the
    coefficients."""
    planes = [np.asarray(c, np.int64) for c in planes]
    h, w = planes[0].shape
    nc = len(planes)
    tw, th = tile or (w, h)
    assert (tw % (1 << levels) == 0 or tw >= w) and (
        th % (1 << levels) == 0 or th >= h), "tiles on the wavelet's grid"
    x = [c - 128 for c in planes]
    if nc >= 3:
        r, g, b = x[0], x[1], x[2]
        if real:
            x[:3] = [0.299 * r + 0.587 * g + 0.114 * b,
                     -0.16875 * r - 0.331260 * g + 0.5 * b,
                     0.5 * r - 0.41869 * g - 0.08131 * b]
        else:
            x[:3] = [(r + 2 * g + b) >> 2, b - g, r - g]
    nb = 3 * levels + 1
    steps = steps or [0] * nb
    gains = [0] + [1, 1, 2] * levels
    expn = [8 + (steps[b] if real else gains[b]) for b in range(nb)]
    # the tiles' code-blocks, their passes and the guard bits they need
    tiles, need = [], 0
    for ty in range(0, h, th):
        for tx in range(0, w, tw):
            comps = []
            for c in range(nc):
                t = x[c][ty:ty + th, tx:tx + tw]
                cf = dwt2(t, levels, real)
                tt = t.shape
                blocks = []
                for bi, (res, bn, bx0, by0, bx1, by1) in enumerate(
                        _bands(tt[1], tt[0], levels)):
                    band = cf[by0:by1, bx0:bx1]
                    if real:
                        q = np.trunc(np.abs(band) / 2.0 ** -steps[bi])
                        q = q.astype(np.int64)
                    else:
                        q = np.abs(band)
                    neg = band < 0
                    cw, ch = 1 << cblk[0], 1 << cblk[1]
                    # code-blocks on the grid of the band's own coordinates
                    lv = levels - res
                    sx = (tx >> levels) if res == 0 else -((-(tx - (
                        bn & 1) * (1 << lv))) >> (lv + 1))
                    sy = (ty >> levels) if res == 0 else -((-(ty - (
                        bn >> 1) * (1 << lv))) >> (lv + 1))
                    xs = _edges(sx, bx1 - bx0, cw)
                    ys = _edges(sy, by1 - by0, ch)
                    grid = []
                    for y0, y1 in ys:
                        row = []
                        for x0, x1 in xs:
                            mq = q[y0:y1, x0:x1]
                            row.append((mq, neg[y0:y1, x0:x1]))
                            if mq.size and mq.max() > 0:
                                need = max(need, (2 * int(mq.max()) - 1)
                                           .bit_length() + p - 1 - expn[bi])
                        grid.append(row)
                    blocks.append((res, bn, bi, grid, by1 > by0 and bx1 > bx0))
                comps.append(blocks)
            tiles.append(comps)
    g = max(2, need)
    head = b"\xff\x4f" + _seg(0xFF51, struct.pack(
        ">HIIIIIIIIH", 0x4000, w, h, 0, 0, tw, th, 0, 0, nc) + bytes(
        [7, 1, 1] * nc))
    head += _seg(0xFF50, struct.pack(">IH", 0x00020000, 0))
    head += _seg(0xFF52, struct.pack(">BBHB", 0, 0, layers,
                                     1 if nc >= 3 else 0) + bytes(
        [levels, cblk[0] - 2, cblk[1] - 2, style, 0 if real else 1]))
    if real:
        qcd = bytes([(g << 5) | 2]) + b"".join(struct.pack(">H", e << 11)
                                                for e in expn)
    else:
        qcd = bytes([g << 5]) + bytes(e << 3 for e in expn)
    head += _seg(0xFF5C, qcd)
    out = head
    for tno, comps in enumerate(tiles):
        body = _tile_packets(comps, levels, layers, p, passes, split, late,
                             [e + g - 1 - p + zb_shift for e in expn],
                             bool(style & 8), extra_passes)
        out += _seg(0xFF90, struct.pack(">HIBB", tno, 14 + len(body), 0, 1)
                    ) + b"\xff\x93" + body
    return out + b"\xff\xd9"


def _tile_packets(comps, levels, layers, p, passes, split, late, zbs,
                  causal, extra):
    # every code-block's passes, once
    coded = []
    for blocks in comps:
        cb = []
        for res, bn, bi, grid, nonempty in blocks:
            g = []
            for row in grid:
                r = []
                for mq, neg in row:
                    if not nonempty or mq.size == 0 or not mq.any():
                        r.append(None)
                        continue
                    cup, ref = encode_block(mq, neg, p, passes, causal)
                    n = passes if ref else 1
                    r.append((cup, ref, n))
                g.append(r)
            cb.append((res, bi, g, nonempty))
        coded.append(cb)
    out = b""
    state = {}
    for layer in range(layers):
        for res in range(levels + 1):
            for c, cb in enumerate(coded):
                bio, data = _Bio(), b""
                mine = [x for x in cb if x[0] == res]
                bio.put(1)
                for _, bi, g, nonempty in mine:
                    if not nonempty:
                        continue
                    key = (c, bi)
                    if key not in state:
                        first = min(res, layers - 1) if late else 0
                        incl = np.array([[(first if e is not None else 1 << 20)
                                          for e in row] for row in g])
                        zb = np.full(incl.shape, zbs[bi])
                        state[key] = (_TagTree(incl), _TagTree(zb), {})
                    tincl, tzb, blk = state[key]
                    for yy, row in enumerate(g):
                        for xx, e in enumerate(row):
                            st = blk.get((yy, xx))
                            if e is None:
                                tincl.encode(bio, yy, xx, layer + 1)
                                continue
                            cup, ref, n = e
                            first = min(res, layers - 1) if late else 0
                            if layer < first or (layer > first and not (
                                    split and layer == first + 1 and n > 1)):
                                todo = []
                            elif split and n > 1:
                                todo = [(cup, 1)] if layer == first else \
                                    [(ref, n - 1)]
                            else:
                                todo = [(cup, 1)] + ([(ref, n - 1)] if n > 1
                                                     else [])
                            if st is None:
                                tincl.encode(bio, yy, xx, layer + 1)
                                if layer < first:
                                    continue
                                tzb.encode(bio, yy, xx, 999)
                                st = blk[(yy, xx)] = {"lb": 3}
                            else:
                                bio.put(1 if todo else 0)
                            if not todo:
                                continue
                            npass = sum(k for _, k in todo) + extra
                            _numpasses(bio, npass)
                            # OpenJPEG's HT segments: the first of a packet
                            # holds one pass, the next the rest
                            nps = [1] + ([npass - 1] if npass > 1 else [])
                            lens = [len(d) for d, _ in todo]
                            lens += [0] * (len(nps) - len(lens))
                            need = max(ln.bit_length() - (k.bit_length() - 1)
                                       for ln, k in zip(lens, nps))
                            inc = max(0, need - st["lb"])
                            bio.put((1 << (inc + 1)) - 2, inc + 1)
                            st["lb"] += inc
                            for ln, k in zip(lens, nps):
                                bio.put(ln, st["lb"] + k.bit_length() - 1)
                            data += b"".join(d for d, _ in todo)
                out += bio.done() + data
    return out
