"""A numpy JPEG writer for the JPEG kinds that no tool here writes: the
oracle for gd3d_torch/data/jpeg.py is PIL decoding these files (PIL here
decodes them; cjpeg, jpegtran and PIL's encoder are absent or write none).

From quantised coefficient blocks (jpeg_encode.fdct_quantize over
rgb_to_ycc and the subsampled planes, quant_tables(q)) or raw samples it
writes:

  * arithmetic-coded sequential files (SOF9): T.81 Annex D's QM coder with
    the Qe table D.2, as jcarith.c codes: statistics areas per table, the
    DC context from the previous difference's class against DAC's L and U,
    the AC magnitude context by Kx, a DAC marker where the conditioning is
    not the default (L = 0, U = 1, Kx = 5), statistics and predictions
    reset at each restart marker, the flush and 0xFF00 stuffing;
  * arithmetic-coded progressive files (SOF10) and Huffman progressive
    files (SOF2) for any scan script: DC first, DC refinement, AC first
    (EOB runs for Huffman) and AC refinement (correction bits) scans,
    jcarith.c's and jcphuff.c's procedures, optimal Huffman tables per scan
    (T.81 K.2, as jpeg_gen_optimal_table);
  * Huffman sequential files with optimal tables (SOF1), and with the DC
    prediction off for the hierarchical probe;
  * lossless files (SOF3): predictors 1-7 (T.81 H.1.2.1: the first row by
    predictor 1 from 2^(P - Pt - 1), the first column by predictor 2, both
    again after each restart), point transform Pt, restart intervals of
    whole MCU rows, optimal Huffman tables for the differences (SSSS 16
    for 32768 carries no extra bits), 1 or 3 components, any integral
    sampling, with or without a JFIF or an Adobe marker;
  * probes for what libjpeg-turbo refuses: SOF11 (a lossless frame whose
    scan codes the differences with the arithmetic DC procedure of
    F.1.4.1: libjpeg-turbo refuses the frame type before it reads a scan),
    a hierarchical file (DHP, then one SOF5 frame) and fractional sampling
    factors (Y 3x1 against Cb and Cr 2x1).

`fixture_files()` gives the named files that chip_smoke.py's formats phase
decodes against the digests in gd3d_torch/data/testdata/formats/digests.json
(written by tests/torch_formats_gen.py). Everything comes from integer
arithmetic and numpy's RandomState integers, so the bytes are the same on
any machine."""
import struct

import numpy as np

from gd3d_torch.data import jpeg_encode as E

ZIGZAG = E.ZIGZAG
# the writer keeps its own copy of the table, so that a fault in the port's
# cannot hide behind the same fault here: PIL reads what both write.
# T.81 Table D.2 as jaricom.c packs it: Qe, next index after an LPS (with
# the MPS switch in bit 7), next index after an MPS; entry 113 is the
# fixed probability 0.5 of sign and refinement bits
_D2 = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
QE = [q for q, _, _, _ in _D2]
NEXT_LPS = [nl | (sw << 7) for _, nl, _, sw in _D2]
NEXT_MPS = [nm for _, _, nm, _ in _D2]
# one statistics list a scan: DC areas of 64 bins, AC areas of 256, the fixed bin
DC_BINS, AC_BINS, N_TABLES = 64, 256, 4
AC0 = DC_BINS * N_TABLES
FIXED = AC0 + AC_BINS * N_TABLES


# ------------------------------------------------------------------ sources
def texture(h, w, seed, c=3, noise=6):
    """A smooth colour texture from integers only (RandomState.randint and
    integer bilinear weights): the same bytes with any numpy."""
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w, c), np.int64)
    for cell, amp in ((48, 9), (12, 5), (4, 2)):
        low = rng.randint(-16, 17, (h // cell + 2, w // cell + 2, c))
        ys, xs = np.arange(h), np.arange(w)
        y0, x0 = ys // cell, xs // cell
        ty, tx = (ys % cell)[:, None, None], (xs % cell)[None, :, None]
        a, b = low[y0][:, x0], low[y0][:, x0 + 1]
        cc, d = low[y0 + 1][:, x0], low[y0 + 1][:, x0 + 1]
        img += amp * ((a * (cell - tx) + b * tx) * (cell - ty)
                      + (cc * (cell - tx) + d * tx) * ty) // (cell * cell)
    img += rng.randint(-noise, noise + 1, (h, w, c))
    return np.clip(img + 128, 0, 255).astype(np.uint8)


def subsample(plane, ry, rx):
    """The plane averaged over ry x rx cells (the edge replicated to whole
    cells), rounded half up."""
    h, w = plane.shape
    p = np.pad(plane, ((0, -h % ry), (0, -w % rx)), mode="edge").astype(np.int64)
    s = p.reshape(p.shape[0] // ry, ry, p.shape[1] // rx, rx).sum(axis=(1, 3))
    return (s + ry * rx // 2) // (ry * rx)


def dct_frame(planes, factors=None, quality=75):
    """A frame of quantised coefficients: the full-size planes (Y, Cb, Cr;
    one grey plane; four CMYK planes) with sampling factors (h, v) each,
    subsampled by `subsample` (any ratio: the nearest samples for ratios
    that do not divide), padded with their edge to whole MCUs and through
    jpeg_encode's forward DCT, with the luminance quantiser for the first
    of three planes and the chrominance one for the rest (the luminance one
    for one or four planes). coef: (block rows, block columns, 64) zigzag,
    dummy blocks included."""
    n = len(planes)
    factors = factors or [(1, 1)] * n
    tq = [min(i, 1) for i in range(n)] if n == 3 else [0] * n
    H, W = planes[0].shape
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    qts = E.quant_tables(quality)
    comps = []
    for i, (plane, (hs, vs)) in enumerate(zip(planes, factors)):
        cw, ch = -(-W * hs // hmax), -(-H * vs // vmax)
        if hmax % hs == 0 and vmax % vs == 0:
            sub = subsample(plane, vmax // vs, hmax // hs)
        else:
            sub = plane[(np.arange(ch) * vmax // vs)[:, None], np.arange(cw) * hmax // hs]
        nby, nbx = mcuy * vs, mcux * hs
        sub = np.pad(sub, ((0, nby * 8 - sub.shape[0]), (0, nbx * 8 - sub.shape[1])), mode="edge")
        blocks = sub.reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
        coef = E.fdct_quantize(blocks, qts[min(tq[i], 1)]).reshape(nby, nbx, 64)
        comps.append({"id": i + 1, "h": hs, "v": vs, "tq": tq[i],
                      "coef": coef, "bw": -(-cw // 8), "bh": -(-ch // 8)})
    return {"w": W, "h": H, "comps": comps, "qtables": [qts[0], qts[1]],
            "mcu": (mcux, mcuy)}


def ycc(rgb):
    return list(E.rgb_to_ycc(rgb))


# ------------------------------------------------------------------ markers
def segment(marker, payload=b""):
    return E._segment(marker, payload)


def dqt(frame):
    used = sorted({c["tq"] for c in frame["comps"]})
    return b"".join(segment(0xDB, bytes([t]) + bytes(frame["qtables"][min(t, 1)][ZIGZAG]
                                                     .astype(np.uint8))) for t in used)


def sof(marker, frame, precision=8):
    comps = frame["comps"]
    return segment(marker, struct.pack(">BHHB", precision, frame["h"], frame["w"], len(comps))
                   + b"".join(bytes([c["id"], c["h"] << 4 | c["v"], c["tq"]]) for c in comps))


def sos(frame, cis, tables, ss, se, ah, al):
    """tables: (dc table, ac table) of each scan component."""
    comps = frame["comps"]
    return segment(0xDA, bytes([len(cis)]) + b"".join(
        bytes([comps[ci]["id"], td << 4 | ta]) for ci, (td, ta) in zip(cis, tables))
        + bytes([ss, se, ah << 4 | al]))


def app_markers(jfif=False, adobe=None):
    out = b""
    if jfif:
        out += segment(0xE0, b"JFIF\x00" + bytes([1, 1, 0]) + struct.pack(">HHH", 1, 1, 0))
    if adobe is not None:
        out += segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    return out


def dri(n):
    return segment(0xDD, struct.pack(">H", n)) if n else b""


# ------------------------------------------------------------------ scan order
def scan_mcus(frame, cis):
    """The scan's MCUs in order, each a list of (component, row, column) of
    its blocks: one block an MCU for a single component (its real blocks,
    raster order), the frame's MCU grid with each component's v x h blocks
    for several."""
    comps = frame["comps"]
    if len(cis) == 1:
        c = comps[cis[0]]
        return [[(cis[0], r, x)] for r in range(c["bh"]) for x in range(c["bw"])]
    mcux, mcuy = frame["mcu"]
    return [[(ci, my * comps[ci]["v"] + dy, mx * comps[ci]["h"] + dx)
             for ci in cis for dy in range(comps[ci]["v"]) for dx in range(comps[ci]["h"])]
            for my in range(mcuy) for mx in range(mcux)]


def segments_of(mcus, restart):
    """The MCUs split into restart intervals."""
    if not restart:
        return [mcus]
    return [mcus[i:i + restart] for i in range(0, len(mcus), restart)]


def join_segments(parts):
    """Entropy-coded segments joined by RST0..RST7."""
    out = b""
    for i, p in enumerate(parts):
        if i:
            out += bytes([0xFF, 0xD0 + (i - 1) % 8])
        out += p
    return out


# ------------------------------------------------------------------ Huffman
def optimal_table(freq):
    """jpeg_gen_optimal_table (T.81 K.2): (counts by length 1..16, symbols)
    of an optimal code for the 256 symbols' counts, no code all ones."""
    freq = list(freq) + [1]  # the pseudo-symbol 256 takes the all-ones code
    codesize, others = [0] * 257, [-1] * 257
    while True:
        c1 = c2 = -1
        v = 1 << 60
        for i in range(257):
            if freq[i] and freq[i] <= v:
                v, c1 = freq[i], i
        v = 1 << 60
        for i in range(257):
            if freq[i] and freq[i] <= v and i != c1:
                v, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for s in codesize:
        if s:
            bits[s] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    symbols = [s for length in range(1, 33) for s in range(256) if codesize[s] == length]
    return bytes(bits[1:17]), bytes(symbols)


def _codes(spec):
    code_of, len_of = E._huffman_codes(spec)
    return code_of.tolist(), len_of.tolist()


def huffman_bytes(segs, tables):
    """segs: per restart interval, tokens (key, value, nbits): a symbol of
    table `key` (nbits 0) or raw bits (key None). tables: key -> (counts,
    symbols). Each interval packed, padded with ones and stuffed."""
    codes = {k: _codes(spec) for k, spec in tables.items()}
    parts = []
    for toks in segs:
        vals, lens = [], []
        for key, value, nbits in toks:
            if key is None:
                vals.append(value & ((1 << nbits) - 1))
                lens.append(nbits)
            else:
                code_of, len_of = codes[key]
                if not len_of[value]:
                    raise ValueError(f"symbol {value:#x} not in table {key}")
                vals.append(code_of[value])
                lens.append(len_of[value])
        parts.append(E.pack_bits(np.array(vals, np.uint64), np.array(lens, np.int64)))
    return join_segments(parts)


def gather_tables(segs):
    freq = {}
    for toks in segs:
        for key, value, nbits in toks:
            if key is not None:
                freq.setdefault(key, [0] * 256)[value] += 1
    return {k: optimal_table(f) for k, f in freq.items()}


def dht(tables):
    """tables: (class, id) -> spec."""
    return b"".join(E._dht(tc, th, spec) for (tc, th), spec in sorted(tables.items()))


def _nbits(v):
    return abs(v).bit_length()


def _magnitude(v, n):
    return v if v >= 0 else v - 1 + (1 << n) if n else 0


def huff_sequential_tokens(frame, mcus, dc_tab, ac_tab, dc_prediction=True):
    """One sequential Huffman segment's tokens (jchuff.c encode_one_block)."""
    comps = frame["comps"]
    pred = {}
    toks = []
    for mcu in mcus:
        for ci, r, x in mcu:
            blk = comps[ci]["coef"][r, x]
            dc = int(blk[0])
            diff = dc - pred.get(ci, 0) if dc_prediction else dc
            pred[ci] = dc
            n = _nbits(diff)
            toks.append(((0, dc_tab[ci]), n, 0))
            if n:
                toks.append((None, _magnitude(diff, n), n))
            run = 0
            ac = blk[1:].tolist()
            last = max((k for k, v in enumerate(ac) if v), default=-1)
            for k in range(last + 1):
                v = ac[k]
                if not v:
                    run += 1
                    continue
                while run > 15:
                    toks.append(((1, ac_tab[ci]), 0xF0, 0))
                    run -= 16
                n = _nbits(v)
                toks.append(((1, ac_tab[ci]), run << 4 | n, 0))
                toks.append((None, _magnitude(v, n), n))
                run = 0
            if last < 62:
                toks.append(((1, ac_tab[ci]), 0, 0))
    return toks


class _Phuff:
    """jcphuff.c's progressive Huffman procedures over one restart
    interval: the tokens, the EOB run and the buffered correction bits."""

    def __init__(self, key):
        self.key, self.toks, self.eobrun, self.be = key, [], 0, []

    def emit_eobrun(self):
        if self.eobrun:
            n = self.eobrun.bit_length() - 1
            self.toks.append((self.key, n << 4, 0))
            if n:
                self.toks.append((None, self.eobrun, n))
            self.eobrun = 0
            self.toks += [(None, b, 1) for b in self.be]
            self.be = []

    def ac_first(self, blk, ss, se, al):
        r = 0
        for k in range(ss, se + 1):
            v = int(blk[k])
            t = abs(v) >> al
            if not t:
                r += 1
                continue
            self.emit_eobrun()
            while r > 15:
                self.toks.append((self.key, 0xF0, 0))
                r -= 16
            n = t.bit_length()
            self.toks.append((self.key, r << 4 | n, 0))
            self.toks.append((None, t if v > 0 else ~t, n))
            r = 0
        if r:
            self.eobrun += 1
            if self.eobrun == 0x7FFF:
                self.emit_eobrun()

    def ac_refine(self, blk, ss, se, al):
        absv = {k: abs(int(blk[k])) >> al for k in range(ss, se + 1)}
        eob = max((k for k, t in absv.items() if t == 1), default=0)
        r, br = 0, []
        for k in range(ss, se + 1):
            t = absv[k]
            if not t:
                r += 1
                continue
            while r > 15 and k <= eob:
                self.emit_eobrun()
                self.toks.append((self.key, 0xF0, 0))
                r -= 16
                self.toks += [(None, b, 1) for b in br]
                br = []
            if t > 1:
                br.append(t & 1)
                continue
            self.emit_eobrun()
            self.toks.append((self.key, r << 4 | 1, 0))
            self.toks.append((None, 0 if blk[k] < 0 else 1, 1))
            self.toks += [(None, b, 1) for b in br]
            br, r = [], 0
        if r or br:
            self.eobrun += 1
            self.be += br
            if self.eobrun == 0x7FFF or len(self.be) > 1000 - 64 + 1:
                self.emit_eobrun()


def huff_progressive_tokens(frame, mcus, scan, dc_tab):
    cis, ss, se, ah, al = scan
    comps = frame["comps"]
    ph = _Phuff((1, min(comps[cis[0]]["tq"], 1)))
    pred = {}
    for mcu in mcus:
        for ci, r, x in mcu:
            blk = comps[ci]["coef"][r, x]
            if ss == 0 and ah == 0:
                dc = int(blk[0]) >> al
                diff = dc - pred.get(ci, 0)
                pred[ci] = dc
                n = _nbits(diff)
                ph.toks.append(((0, dc_tab[ci]), n, 0))
                if n:
                    ph.toks.append((None, _magnitude(diff, n), n))
            elif ss == 0:
                ph.toks.append((None, (int(blk[0]) >> al) & 1, 1))
            elif ah == 0:
                ph.ac_first(blk, ss, se, al)
            else:
                ph.ac_refine(blk, ss, se, al)
    ph.emit_eobrun()
    return ph.toks


# ------------------------------------------------------------------ arithmetic
class ArithEncoder:
    """jcarith.c's arith_encode and finish_pass over one restart interval;
    `st` indexes one statistics list (DC areas, AC areas, the fixed bin)."""

    def __init__(self):
        self.st = bytearray(FIXED + 1)
        self.st[FIXED] = 113
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1
        self.out = bytearray()

    def _emit(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def encode(self, s, val):
        st = self.st
        sv = st[s]
        qe, nl, nm = QE[sv & 0x7F], NEXT_LPS[sv & 0x7F], NEXT_MPS[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[s] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[s] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        return bytes(self.out)


def _arith_value(enc, s, v, x1, x2=None):
    """F.1.4.1's magnitude category and bits of |v| - 1 (v != 0, its sign
    already coded), from bin `s` (SP or SN for DC, SE + 2 for AC); x1 the
    first X bin for DC, x2 the AC's X2 (189 or 217) past the doubled first
    decision."""
    v -= 1
    m = 0
    if v:
        enc.encode(s, 1)
        m = 1
        v2 = v
        if x2 is None:
            s = x1
            while v2 >> 1:
                v2 >>= 1
                enc.encode(s, 1)
                m <<= 1
                s += 1
        else:
            v2 >>= 1
            if v2:
                enc.encode(s, 1)
                m <<= 1
                s = x2
                while v2 >> 1:
                    v2 >>= 1
                    enc.encode(s, 1)
                    m <<= 1
                    s += 1
    enc.encode(s, 0)
    s += 14
    while m > 1:
        m >>= 1
        enc.encode(s, 1 if m & v else 0)


def _arith_dc(enc, state, ci, tbl, m, cond):
    """F.1.4.1's DC difference of component ci (state: last value and
    context per component)."""
    last, ctx = state.setdefault(ci, [0, 0])
    s = tbl * DC_BINS + ctx
    v = m - last
    if v == 0:
        enc.encode(s, 0)
        state[ci][1] = 0
        return
    state[ci][0] = m
    enc.encode(s, 1)
    if v > 0:
        enc.encode(s + 1, 0)
        s += 2
        ctx = 4
    else:
        v = -v
        enc.encode(s + 1, 1)
        s += 3
        ctx = 8
    lo, hi = cond["dc"].get(tbl, (0, 1))
    mcat = 0 if v == 1 else 1 << ((v - 1).bit_length() - 1)
    if mcat < (1 << lo) >> 1:
        ctx = 0
    elif mcat > (1 << hi) >> 1:
        ctx += 8
    state[ci][1] = ctx
    _arith_value(enc, s, v, tbl * DC_BINS + 20)


def arith_block_sequential(enc, state, ci, blk, dtbl, atbl, cond):
    """jcarith.c encode_mcu for one block (natural zigzag in blk)."""
    _arith_dc(enc, state, ci, dtbl, int(blk[0]), cond)
    kx = cond["ac"].get(atbl, 5)
    ac = blk.tolist()
    ke = 63
    while ke and not ac[ke]:
        ke -= 1
    base = AC0 + atbl * AC_BINS
    k = 0
    while k < ke:
        s = base + 3 * k
        enc.encode(s, 0)
        k += 1
        while not ac[k]:
            enc.encode(s + 1, 0)
            s += 3
            k += 1
        enc.encode(s + 1, 1)
        v = ac[k]
        enc.encode(FIXED, 0 if v > 0 else 1)
        _arith_value(enc, s + 2, abs(v), None, base + (189 if k <= kx else 217))
    if k < 63:
        enc.encode(base + 3 * k, 1)


def arith_block_progressive(enc, state, ci, blk, scan, dtbl, atbl, cond):
    """jcarith.c's four progressive procedures for one block."""
    _, ss, se, ah, al = scan
    if ss == 0:
        if ah == 0:
            _arith_dc(enc, state, ci, dtbl, int(blk[0]) >> al, cond)
        else:
            enc.encode(FIXED, (int(blk[0]) >> al) & 1)
        return
    base = AC0 + atbl * AC_BINS
    kx = cond["ac"].get(atbl, 5)
    absv = [0] * 64
    for k in range(ss, se + 1):
        absv[k] = abs(int(blk[k])) >> al
    ke = se
    while ke > 0 and not absv[ke]:
        ke -= 1
    if ah == 0:
        k = ss
        while k <= ke:
            s = base + 3 * (k - 1)
            enc.encode(s, 0)
            while not absv[k]:
                enc.encode(s + 1, 0)
                s += 3
                k += 1
            enc.encode(s + 1, 1)
            enc.encode(FIXED, 0 if blk[k] > 0 else 1)
            _arith_value(enc, s + 2, absv[k], None, base + (189 if k <= kx else 217))
            k += 1
    else:
        kex = ke
        while kex > 0 and not abs(int(blk[kex])) >> ah:
            kex -= 1
        k = ss
        while k <= ke:
            s = base + 3 * (k - 1)
            if k > kex:
                enc.encode(s, 0)
            while True:
                t = absv[k]
                if t:
                    if t >> 1:
                        enc.encode(s + 2, t & 1)
                    else:
                        enc.encode(s + 1, 1)
                        enc.encode(FIXED, 0 if blk[k] > 0 else 1)
                    break
                enc.encode(s + 1, 0)
                s += 3
                k += 1
            k += 1
    if k <= se:
        enc.encode(base + 3 * (k - 1), 1)


def dac(cond):
    """The DAC segment of non-default conditioning, else nothing. cond:
    {"dc": {table: (L, U)}, "ac": {table: Kx}}."""
    body = b"".join(bytes([t, u << 4 | lo]) for t, (lo, u) in sorted(cond["dc"].items())
                    if (lo, u) != (0, 1))
    body += b"".join(bytes([16 + t, kx]) for t, kx in sorted(cond["ac"].items()) if kx != 5)
    return segment(0xCC, body) if body else b""


# ------------------------------------------------------------------ files
def _tables(frame, cis):
    return [(min(frame["comps"][ci]["tq"], 1),) * 2 for ci in cis]


def simple_progression(ncomps):
    """jpeg_simple_progression's script (libjpeg-turbo's default):
    (components, Ss, Se, Ah, Al) each scan."""
    every = tuple(range(ncomps))
    if ncomps == 3:
        return [(every, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                (every, 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                ((0,), 1, 63, 1, 0)]
    each = [(c,) for c in every]
    return ([(every, 0, 0, 0, 1)] + [(c, 1, 5, 0, 2) for c in each]
            + [(c, 6, 63, 0, 2) for c in each] + [(c, 1, 63, 2, 1) for c in each]
            + [(every, 0, 0, 1, 0)] + [(c, 1, 63, 1, 0) for c in each])


def write_dct(frame, arith=False, script=None, restart=0, cond=None, adobe=None,
              separate=False, marker=None, dc_prediction=True):
    """A DCT-based file of the frame's coefficients: sequential (one
    interleaved scan, or one scan a component with `separate`) or
    progressive by `script`; Huffman (optimal tables) or arithmetic-coded
    with conditioning `cond`; a restart interval in MCUs; a JFIF marker for
    one or three components unless an Adobe marker is asked for."""
    comps = frame["comps"]
    n = len(comps)
    cond = cond or {"dc": {}, "ac": {}}
    jfif = n in (1, 3) and adobe is None
    if marker is None:
        marker = (0xCA if script else 0xC9) if arith else (0xC2 if script else 0xC1)
    head = b"\xff\xd8" + app_markers(jfif, adobe) + dqt(frame) + sof(marker, frame) + dri(restart)
    if arith:
        head += dac(cond)
    scans = script or ([((ci,), 0, 63, 0, 0) for ci in range(n)] if separate
                       else [(tuple(range(n)), 0, 63, 0, 0)])
    body = b""
    for scan in scans:
        cis = scan[0]
        tabs = _tables(frame, cis)
        dtab = {ci: t[0] for ci, t in zip(cis, tabs)}
        atab = {ci: t[1] for ci, t in zip(cis, tabs)}
        segs = segments_of(scan_mcus(frame, cis), restart)
        if arith:
            parts = []
            for mcus in segs:
                enc, state = ArithEncoder(), {}
                for mcu in mcus:
                    for ci, r, x in mcu:
                        blk = comps[ci]["coef"][r, x]
                        if script:
                            arith_block_progressive(enc, state, ci, blk, scan, dtab[ci],
                                                    atab[ci], cond)
                        else:
                            arith_block_sequential(enc, state, ci, blk, dtab[ci], atab[ci],
                                                   cond)
                parts.append(enc.finish())
            data = join_segments(parts)
        else:
            if script:
                toks = [huff_progressive_tokens(frame, m, scan, dtab) for m in segs]
            else:
                toks = [huff_sequential_tokens(frame, m, dtab, atab, dc_prediction)
                        for m in segs]
            tables = gather_tables(toks)
            data = huffman_bytes(toks, tables)
            body += dht(tables)
        body += sos(frame, cis, tabs, *scan[1:]) + data
    return head + body + b"\xff\xd9"


def baseline_twin(frame):
    """jpeg_encode's Huffman coding (the standard tables) of the same
    coefficients and quantisers: one interleaved baseline scan."""
    comps = frame["comps"]
    mcus = scan_mcus(frame, tuple(range(len(comps))))
    blocks = np.array([comps[ci]["coef"][r, x] for mcu in mcus for ci, r, x in mcu])
    comp = np.array([ci for mcu in mcus for ci, _, _ in mcu])
    tid = np.array([min(comps[ci]["tq"], 1) for ci in comp])
    scan = E.entropy_code(blocks, comp, tid)
    n = len(comps)
    dht_ = E._dht(0, 0, E.DC_LUMA) + E._dht(1, 0, E.AC_LUMA)
    if any(tid):
        dht_ += E._dht(0, 1, E.DC_CHROMA) + E._dht(1, 1, E.AC_CHROMA)
    adobe = 0 if n == 4 else None
    return (b"\xff\xd8" + app_markers(n in (1, 3), adobe) + dqt(frame) + sof(0xC0, frame) + dht_
            + sos(frame, tuple(range(n)), _tables(frame, range(n)), 0, 63, 0, 0) + scan
            + b"\xff\xd9")


# ------------------------------------------------------------------ lossless
def _predict(x, psv, pt, band_rows):
    """T.81 H.1.2.1's prediction of every sample of one component plane
    (already shifted right by Pt), restarting each band of rows."""
    pred = np.zeros(x.shape, np.int64)
    for r0 in range(0, x.shape[0], band_rows):
        b = x[r0:r0 + band_rows].astype(np.int64)
        p = np.zeros(b.shape, np.int64)
        p[0, 0] = 1 << (8 - pt - 1)
        p[0, 1:] = b[0, :-1]
        p[1:, 0] = b[:-1, 0]
        ra, rb, rc = b[1:, :-1], b[:-1, 1:], b[:-1, :-1]
        p[1:, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                     6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]
        pred[r0:r0 + band_rows] = p
    return pred


def write_lossless(planes, factors=None, psv=1, pt=0, restart_rows=0, jfif=False, adobe=None,
                   marker=0xC3, arith=False, separate=False):
    """A lossless file (SOF3) of uint8 planes (full size; subsampled by
    `subsample` to the factors): one interleaved scan, or one scan a
    component with `separate`; predictor psv, point transform pt, a
    restart every restart_rows MCU rows, optimal Huffman tables (table 0
    for the first component, 1 for the others). With arith (the SOF11
    probe) the differences take F.1.4.1's arithmetic DC procedure instead."""
    n = len(planes)
    factors = factors if n > 1 and factors else [(1, 1)] * n
    H, W = planes[0].shape
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-W // hmax), -(-H // vmax)
    comps, diffs = [], []
    for i, (plane, (hs, vs)) in enumerate(zip(planes, factors)):
        cw, ch = -(-W * hs // hmax), -(-H * vs // vmax)
        sub = subsample(plane, vmax // vs, hmax // hs)[:ch, :cw]
        if not separate:  # the MCU grid's padding
            sub = np.pad(sub, ((0, mcuy * vs - ch), (0, mcux * hs - cw)), mode="edge")
        full = sub >> pt
        band = restart_rows * (1 if separate else vs) if restart_rows else full.shape[0]
        diffs.append(full - _predict(full, psv, pt, band))
        comps.append({"id": i + 1, "h": hs, "v": vs, "tq": 0})
    frame = {"w": W, "h": H, "comps": comps, "mcu": (mcux, mcuy)}
    tab = [min(i, 1) for i in range(n)]
    out = b"\xff\xd8" + app_markers(jfif, adobe) + sof(marker, frame)
    for cis in ([(ci,) for ci in range(n)] if separate else [tuple(range(n))]):
        # the differences in scan order: the MCU grid, each component's v x h
        # samples (one sample an MCU, the component's raster, for one alone)
        step = {ci: (1, 1) if separate else (comps[ci]["v"], comps[ci]["h"]) for ci in cis}
        pattern = [(ci, dy, dx) for ci in cis for dy in range(step[ci][0])
                   for dx in range(step[ci][1])]
        gy, gx = diffs[cis[0]].shape if separate else (mcuy, mcux)
        my, mx = np.divmod(np.arange(gx * gy), gx)
        seq = np.stack([diffs[ci][my * step[ci][0] + dy, mx * step[ci][1] + dx]
                        for ci, dy, dx in pattern], axis=1).reshape(-1)
        tid = np.tile(np.array([tab[ci] for ci, _, _ in pattern]), gx * gy)
        restart = restart_rows * gx
        seg_len = restart * len(pattern) if restart else len(seq)
        scan_hdr = sos(frame, cis, [(tab[ci], 0) for ci in cis], psv, 0, 0, pt)
        if arith:
            parts = []
            for s0 in range(0, len(seq), seg_len):
                enc, state = ArithEncoder(), {}
                for j, v in enumerate(seq[s0:s0 + seg_len].tolist()):
                    ci = pattern[j % len(pattern)][0]
                    _arith_dc(enc, state, ci, tab[ci], state.get(ci, [0, 0])[0] + v,
                              {"dc": {}, "ac": {}})
                parts.append(enc.finish())
            out += dri(restart) + scan_hdr + join_segments(parts)
            continue
        nb = np.zeros(len(seq), np.int64)
        a = np.abs(seq)
        while (a > 0).any():
            nb += a > 0
            a >>= 1
        tables = {(0, t): optimal_table(np.bincount(nb[tid == t], minlength=256).tolist())
                  for t in sorted({tab[ci] for ci in cis})}
        code = np.zeros((2, 256), np.int64)
        clen = np.zeros((2, 256), np.int64)
        for (_, t), spec in tables.items():
            code[t], clen[t] = E._huffman_codes(spec)
        extra = np.where(nb == 16, 0, nb)  # SSSS 16 (32768) has no extra bits
        vals = (code[tid, nb] << extra) | (np.where(seq < 0, seq - 1, seq) & ((1 << extra) - 1))
        lens = clen[tid, nb] + extra
        parts = [E.pack_bits(vals[s0:s0 + seg_len].astype(np.uint64), lens[s0:s0 + seg_len])
                 for s0 in range(0, len(seq), seg_len)]
        out += dri(restart) + dht(tables) + scan_hdr + join_segments(parts)
    return out + b"\xff\xd9"


# ------------------------------------------------------------------ probes
def hierarchical_probe(rgb):
    """DHP (the whole image's size and components), then one differential
    sequential frame (SOF5) whose scan codes the blocks' values without DC
    prediction (T.81 J.1.1)."""
    frame = dct_frame(ycc(rgb))
    dhp = segment(0xDE, sof(0xC0, frame)[4:])
    body = write_dct(frame, marker=0xC5, dc_prediction=False)
    return body[:2] + dhp + body[2:]


def fractional_probe(rgb):
    """Sampling factors Y 3x1, Cb 2x1, Cr 2x1: T.81 allows them, libjpeg-turbo
    cannot upsample by 3/2."""
    return write_dct(dct_frame(ycc(rgb), [(3, 1), (2, 1), (2, 1)]))


def sof11_probe(rgb):
    return write_lossless(ycc(rgb)[:1], marker=0xCB, arith=True)


# ------------------------------------------------------------------ fixtures
NONDEFAULT = {"dc": {0: (2, 5), 1: (1, 3)}, "ac": {0: 12, 1: 2}}


def successive_script(ncomps):
    """Successive approximation in DC and AC: DC from Al 2 by 1 to 0, AC
    from Al 3 in two bands, refined to 2, 1, 0."""
    every = tuple(range(ncomps))
    each = [(c,) for c in every]
    return ([(every, 0, 0, 0, 2), (every, 0, 0, 2, 1)] + [(c, 1, 9, 0, 3) for c in each]
            + [(c, 10, 63, 0, 3) for c in each] + [(c, 1, 63, 3, 2) for c in each]
            + [(c, 1, 63, 2, 1) for c in each] + [(every, 0, 0, 1, 0)]
            + [(c, 1, 63, 1, 0) for c in each])


# every coefficient of 1..9 complete, 10..63 left at Al 1: nothing to smooth
NO_SMOOTH_SCRIPT = [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 9, 0, 0), ((1,), 1, 9, 0, 0),
                    ((2,), 1, 9, 0, 0), ((0,), 10, 63, 0, 1), ((1,), 10, 63, 0, 1),
                    ((2,), 10, 63, 0, 1)]
F420 = [(2, 2), (1, 1), (1, 1)]


def fixture_files():
    """The files of chip_smoke.py's formats phase: name -> bytes. Three at
    512x384 for the host times a decode, the rest small."""
    big = texture(384, 512, 40)
    rgb = texture(96, 128, 41)
    return {
        "arith_seq_420_512x384.jpg": write_dct(dct_frame(ycc(big), F420), arith=True),
        "arith_prog_420_512x384.jpg": write_dct(dct_frame(ycc(big), F420), arith=True,
                                                script=simple_progression(3)),
        "lossless_512x384.jpg": write_lossless(list(np.moveaxis(big, -1, 0)), psv=1),
        "arith_seq_restart_dac.jpg": write_dct(dct_frame(ycc(rgb[:48, :64]), F420, quality=90),
                                               arith=True, restart=3, cond=NONDEFAULT),
        "arith_prog_sa.jpg": write_dct(dct_frame(ycc(rgb[:48, :72]), [(2, 1), (1, 1), (1, 1)]),
                                       arith=True, script=successive_script(3), restart=5),
        "arith_cmyk.jpg": write_dct(dct_frame([p for p in np.moveaxis(
            texture(40, 56, 42, c=4), -1, 0)]), arith=True, adobe=0),
        "lossless_p6_pt2_restart.jpg": write_lossless(list(np.moveaxis(rgb[:48, :64], -1, 0)),
                                                      psv=6, pt=2, restart_rows=5, adobe=0),
        "lossless_gray_p7.jpg": write_lossless([rgb[:48, :64, 1]], psv=7, restart_rows=7),
        "smooth_prog_420.jpg": write_dct(dct_frame(ycc(rgb[:80, :96]), F420),
                                         script=simple_progression(3)[:5]),
        "smooth_arith_gray_dc.jpg": write_dct(dct_frame([rgb[:64, :80, 0]]), arith=True,
                                              script=simple_progression(1)[:1]),
    }
