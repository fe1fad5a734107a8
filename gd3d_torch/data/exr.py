"""OpenEXR depth decoding without cv2, to cv2's float32 array.

dust3r's preprocessing writes float depth with `cv2.imwrite(path.exr, d)`,
and gd3d reads it back with `cv2.imread(path, IMREAD_ANYDEPTH)` wherever its
cv2 has the EXR codec (gd3d/data/stereo_views.py::read_depth_float); the
card's machine has no cv2. `read_exr(path)` gives, bit for bit, the (H, W)
float32 array OpenCV 4.6 (with OpenEXR 3.1) gives for every file it reads:

  * the file: scanline, tiled (level 0, whatever the level mode, rounding
    and tile order) or multi-part (part 0, whose parts must share their
    display window, pixel aspect, time code and chromaticities); channels of
    HALF (widened exactly), FLOAT or UINT (rounded to float32) samples, any
    x / y sampling; the data window's size;
  * the compressions NONE, RLE, ZIPS, ZIP, PIZ, PXR24, B44, B44A (pLinear
    included), DWAA and DWAB (data/exr_dwa.py);
  * the grey OpenCV makes of the channels: with any of R, G, B, the sum
    B xb + G xg + R xr in float32, in that order, the weights the red,
    green and blue x chromaticities (0.64, 0.30, 0.15 unless the header
    has a chromaticities attribute), a missing channel 0, A ignored, each
    subsampled channel widened in x line by line (a line without samples
    keeps the last one's buffer, widened once more), and G's sampling
    repeating the grey lines in y; else Y widened in both axes; else Z,
    which OpenCV takes for grey but asks OpenEXR for "Y": zeros.

Where cv2.imread returns None (no R, G, B, Y or Z channel, deep data, a
header or chunk OpenEXR rejects) it raises OpenCVRefuses, a ValueError,
and read_depth_float falls back to the `.npy` sibling as gd3d does. Where
OpenCV's array is undefined it raises a plain ValueError: Y with RY or BY
(OpenCV's grey is uninitialised memory) and a subsampled channel with the
data window off 0 in that axis (OpenCV writes outside its buffer). Each
error names the file and the feature.
"""
from __future__ import annotations

import functools
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

from gd3d_torch.data.source import Source, read_source


MAGIC = b"\x76\x2f\x31\x01"
COMPRESSIONS = {0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ", 5: "PXR24", 6: "B44",
                7: "B44A", 8: "DWAA", 9: "DWAB"}
LINES = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32, 5: 16, 6: 32, 7: 32, 8: 32, 9: 256}
_DTYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
REC709_X = (0.64, 0.30, 0.15)  # the x chromaticities of red, green, blue: OpenCV's grey weights


class OpenCVRefuses(ValueError):
    """A file cv2.imread(path, IMREAD_ANYDEPTH) returns None for (OpenCV
    4.6, OpenEXR 3.1): gd3d then reads the `<path>.npy` sibling instead."""


def _attrs(data: bytes, pos: int):
    attrs: Dict[str, Tuple[str, bytes]] = {}
    while data[pos] != 0:
        an = data.index(b"\x00", pos)
        tn = data.index(b"\x00", an + 1)
        size = struct.unpack_from("<i", data, tn + 1)[0]
        if size < 0 or tn + 5 + size > len(data):
            raise IndexError("attribute past the end")
        attrs[data[pos:an].decode()] = (data[an + 1:tn].decode(), data[tn + 5:tn + 5 + size])
        pos = tn + 5 + size
    return attrs, pos + 1


def _header(data: bytes, name: str):
    """(the first part's attributes, the position of the offset tables).
    A multi-part file's parts must have names, types, distinct names and
    the same shared attributes, as OpenEXR's MultiPartInputFile demands."""
    if data[:4] != MAGIC:
        raise ValueError(f"{name}: not an OpenEXR file")
    multi = struct.unpack_from("<I", data, 4)[0] & 0x1000
    try:
        headers = [_attrs(data, 8)]
        while multi and data[headers[-1][1]] != 0:  # then an empty header
            headers.append(_attrs(data, headers[-1][1]))
        pos = headers[-1][1] + (1 if multi else 0)
    except (IndexError, ValueError, struct.error, UnicodeDecodeError) as e:
        raise OpenCVRefuses(f"{name}: truncated or corrupt{' multi-part' if multi else ''} "
                            f"OpenEXR header") from e
    attrs = headers[0][0]
    if multi:
        names = [h.get("name", (None, None))[1] for h, _ in headers]
        if None in names or len(set(names)) != len(names) \
                or any("type" not in h for h, _ in headers):
            raise OpenCVRefuses(f"{name}: multi-part OpenEXR parts without distinct names "
                                f"and types")
        for key in ("displayWindow", "pixelAspectRatio", "timeCode", "chromaticities"):
            if any(h.get(key) != attrs.get(key) for h, _ in headers):
                raise OpenCVRefuses(f"{name}: multi-part OpenEXR parts of different '{key}'")
    return attrs, pos


def _channels(b: bytes):
    """[(name, pixel type, pLinear, x sampling, y sampling)] in file order."""
    out = []
    pos = 0
    while b[pos] != 0:
        end = b.index(b"\x00", pos)
        ptype, plin, xs, ys = struct.unpack_from("<iB3xii", b, end + 1)
        out.append((b[pos:end].decode(), ptype, plin, xs, ys))
        pos = end + 17
    return out


def _unpredict(t: np.ndarray) -> bytes:
    """OpenEXR's RLE / ZIP post-pass: undo the byte predictor, then
    interleave the two halves back."""
    if not len(t):
        return b""
    d = np.concatenate([t[:1].astype(np.int64), t[1:].astype(np.int64) - 128])
    u = (np.cumsum(d) & 255).astype(np.uint8)
    half = (len(u) + 1) // 2
    out = np.empty_like(u)
    out[0::2] = u[:half]
    out[1::2] = u[half:]
    return out.tobytes()


def _rle_decode(b: bytes, n: int, name: str) -> np.ndarray:
    out = bytearray()
    pos = 0
    while pos < len(b) and len(out) < n:
        c = b[pos] - 256 if b[pos] > 127 else b[pos]
        if c < 0:
            out += b[pos + 1:pos + 1 - c]
            pos += 1 - c
        else:
            out += bytes([b[pos + 1]]) * (c + 1)
            pos += 2
    if len(out) != n:
        raise OpenCVRefuses(f"{name}: corrupt RLE block in OpenEXR file")
    return np.frombuffer(bytes(out), np.uint8)


# ------------------------------------------------- Huffman (PIZ, DWA AC)
_SHORT_ZEROCODE_RUN, _LONG_ZEROCODE_RUN = 59, 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN
HUF_ENCSIZE = (1 << 16) + 1


class _Bits:
    """MSB-first bit reader over bytes."""

    def __init__(self, b: bytes, pos: int = 0):
        self.b, self.pos, self.c, self.lc = b, pos, 0, 0

    def get(self, n: int) -> int:
        while self.lc < n:
            self.c = ((self.c << 8) | self.b[self.pos]) & ((1 << 64) - 1)
            self.pos += 1
            self.lc += 8
        self.lc -= n
        return (self.c >> self.lc) & ((1 << n) - 1)


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """hufCanonicalCodeTable: the code of each symbol from its length
    (longer codes take the numerically lower values)."""
    n = np.bincount(lengths, minlength=59)[:59].astype(np.int64)
    start = np.zeros(59, np.int64)
    c = 0
    for i in range(58, 0, -1):
        nc = (c + int(n[i])) >> 1
        start[i] = c
        c = nc
    codes = np.zeros(len(lengths), np.int64)
    for i in np.nonzero(lengths)[0]:
        codes[i] = start[lengths[i]]
        start[lengths[i]] += 1
    return codes


def huf_uncompress(b: bytes, n_raw: int, name: str) -> np.ndarray:
    """hufUncompress (PIZ's and DWA's AC code): n_raw uint16 symbols; the
    symbol iM stands for a run of the previous value, its count in the next
    8 bits. Every bit position is decoded at once; the chain of code starts
    from bit 0 then picks the symbols."""
    if not b:
        if n_raw:
            raise OpenCVRefuses(f"{name}: empty Huffman data")
        return np.zeros(0, np.uint16)
    im, iM, _, nbits = struct.unpack_from("<iiii", b, 0)
    if not (0 <= im < HUF_ENCSIZE and 0 <= iM < HUF_ENCSIZE):
        raise OpenCVRefuses(f"{name}: bad Huffman table range")
    br = _Bits(b, 20)
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        ln = br.get(6)
        if ln == _LONG_ZEROCODE_RUN:
            i += br.get(8) + _SHORTEST_LONG_RUN
        elif ln >= _SHORT_ZEROCODE_RUN:
            i += ln - _SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = ln
            i += 1
    if i > iM + 1:
        raise OpenCVRefuses(f"{name}: Huffman table too long")
    if lengths.max() > 57:
        # a 58-bit code needs more than 10^12 symbols in one chunk: corrupt
        raise OpenCVRefuses(f"{name}: Huffman code longer than 57 bits")
    codes = canonical_codes(lengths)
    start = br.pos
    if start + (nbits + 7) // 8 > len(b) or nbits < 0:
        raise OpenCVRefuses(f"{name}: Huffman data past its end")
    syms, ends = _huf_positions(np.frombuffer(b, np.uint8, (nbits + 7) // 8, start), nbits,
                                lengths, codes, iM)
    # walk the chain of code starts (each position's next is known)
    nxt = ends.tolist()
    chain = []
    k = 0
    while k < nbits:
        chain.append(k)
        k = nxt[k]
        if k < 0:
            raise OpenCVRefuses(f"{name}: invalid Huffman code")
    if k != nbits and chain:
        raise OpenCVRefuses(f"{name}: Huffman code past the end of its bits")
    chain = np.asarray(chain, np.int64)
    sym = syms[chain]
    reps = np.ones(len(chain), np.int64)
    run = sym == iM
    if run.any():
        # iM repeats the value before it as often as its 8-bit count says
        if run[0]:
            raise OpenCVRefuses(f"{name}: bad run")
        reps[run] = _bits_at(np.frombuffer(b, np.uint8, (nbits + 7) // 8, start),
                             ends[chain[run]] - 8, 8)
        last = np.maximum.accumulate(np.where(run, 0, np.arange(len(chain))))
        sym = sym[last]
    out = np.repeat(sym, reps)
    if len(out) != n_raw:
        raise OpenCVRefuses(f"{name}: Huffman data of {len(out)} values, {n_raw} expected")
    return out.astype(np.uint16)


def _bits_at(u8: np.ndarray, pos: np.ndarray, n: int) -> np.ndarray:
    """The n-bit (n <= 57) big-endian integers starting at bit positions
    `pos` of u8."""
    pad = np.concatenate([u8, np.zeros(8, np.uint8)])
    words = np.lib.stride_tricks.sliding_window_view(pad, 8)[pos >> 3]
    w = np.ascontiguousarray(words).view(">u8").astype(np.uint64).reshape(-1)
    return ((w << (pos & 7).astype(np.uint64)) >> np.uint64(64 - n)).astype(np.int64)


_HUF_FAST = 12  # codes up to this long are found by one table look-up


def _huf_positions(u8, nbits, lengths, codes, iM):
    """For every bit position: the symbol whose code starts there, and the
    position after it (after its 8-bit count, for the run symbol iM); -1
    where no code starts."""
    pos = np.arange(nbits, dtype=np.int64)
    window = _bits_at(u8, pos, 57)
    used = np.nonzero(lengths)[0]
    fast_sym = np.zeros(1 << _HUF_FAST, np.int64)
    fast_len = np.zeros(1 << _HUF_FAST, np.int64)
    for s in used[lengths[used] <= _HUF_FAST]:
        span = 1 << (_HUF_FAST - int(lengths[s]))
        first = int(codes[s]) * span
        fast_sym[first:first + span] = s
        fast_len[first:first + span] = lengths[s]
    top = window >> (57 - _HUF_FAST)
    syms, lens = fast_sym[top], fast_len[top]
    slow = np.nonzero(lens == 0)[0]
    for ln in np.unique(lengths[used][lengths[used] > _HUF_FAST]):
        if not len(slow):
            break
        mine = used[lengths[used] == ln]
        order = np.argsort(codes[mine])
        first, sorted_syms = codes[mine][order][0], mine[order]
        code = window[slow] >> (57 - int(ln))
        hit = (code >= first) & (code < first + len(mine))
        syms[slow[hit]] = sorted_syms[code[hit] - first]
        lens[slow[hit]] = ln
        slow = slow[~hit]
    ends = np.where(lens > 0, pos + lens + 8 * (syms == iM), -1)
    ends[ends > nbits] = -1
    return syms, ends


def _wdec(l: np.ndarray, h: np.ndarray, w14: bool):
    """wdec14 / wdec16 on uint16 arrays."""
    if w14:
        ls = l.astype(np.int16).astype(np.int32)
        hs = h.astype(np.int16).astype(np.int32)
        ai = ls + (hs & 1) + (hs >> 1)
        return (ai & 0xFFFF).astype(np.uint16), ((ai - hs) & 0xFFFF).astype(np.uint16)
    m, d = l.astype(np.int32), h.astype(np.int32)
    bb = (m - (d >> 1)) & 0xFFFF
    aa = (d + bb - 32768) & 0xFFFF
    return aa.astype(np.uint16), bb.astype(np.uint16)


def wav2_decode(p: np.ndarray, mx: int) -> None:
    """OpenEXR's wav2Decode on a (ny, nx) uint16 plane, in place."""
    ny, nx = p.shape
    w14 = mx < (1 << 14)
    n = min(nx, ny)
    s = 1
    while s <= n:
        s <<= 1
    s >>= 1
    s2, s = s, s >> 1
    while s >= 1:
        ye, xe = ny - s2 + 1, nx - s2 + 1  # exclusive bounds of the block corners
        nyb, nxb = len(range(0, max(ye, 0), s2)), len(range(0, max(xe, 0), s2))
        if nyb and nxb:
            ys, xs = slice(0, ye, s2), slice(0, xe, s2)
            ys1, xs1 = slice(s, ye + s, s2), slice(s, xe + s, s2)
            i00, i10 = _wdec(p[ys, xs], p[ys1, xs], w14)
            i01, i11 = _wdec(p[ys, xs1], p[ys1, xs1], w14)
            p[ys, xs], p[ys, xs1] = _wdec(i00, i01, w14)
            p[ys1, xs], p[ys1, xs1] = _wdec(i10, i11, w14)
        if nx & s and nyb:  # the odd column
            x = nxb * s2
            ys, ys1 = slice(0, ye, s2), slice(s, ye + s, s2)
            p[ys, x], p[ys1, x] = _wdec(p[ys, x], p[ys1, x], w14)
        if ny & s and nxb:  # the odd line
            y = nyb * s2
            xs, xs1 = slice(0, xe, s2), slice(s, xe + s, s2)
            p[y, xs], p[y, xs1] = _wdec(p[y, xs], p[y, xs1], w14)
        s2, s = s, s >> 1


def _num(s: int, a: int, b: int) -> int:
    """OpenEXR's numSamples: how many of a..b are multiples of s."""
    return b // s - (a - 1) // s


def _split(raw: bytes, chans, shapes, ya: int, yb: int, name: str) -> List[np.ndarray]:
    """OpenEXR's uncompressed chunk layout (line by line, each line's
    samples channel by channel) -> each channel's (ny, nx) samples."""
    dts = [_DTYPES[c[1]] for c in chans]
    need = sum(ny * nx * dt.itemsize for (ny, nx), dt in zip(shapes, dts))
    if len(raw) != need:
        raise OpenCVRefuses(f"{name}: OpenEXR chunk at line {ya} of {len(raw)} bytes, "
                            f"{need} expected")
    u8 = np.frombuffer(raw, np.uint8)
    if all(c[4] == 1 for c in chans):
        rows = u8.reshape(yb - ya + 1, -1) if need else np.zeros((yb - ya + 1, 0), np.uint8)
        out, off = [], 0
        for (ny, nx), dt in zip(shapes, dts):
            width = nx * dt.itemsize
            out.append(np.ascontiguousarray(rows[:, off:off + width]).view(dt).reshape(ny, nx))
            off += width
        return out
    parts: List[list] = [[] for _ in chans]
    pos = 0
    for y in range(ya, yb + 1):
        for k, c in enumerate(chans):
            if y % c[4] == 0:
                n = shapes[k][1] * dts[k].itemsize
                parts[k].append(u8[pos:pos + n])
                pos += n
    return [np.concatenate(p).view(dt).reshape(shape) if p else np.zeros(shape, dt)
            for p, dt, shape in zip(parts, dts, shapes)]


# ------------------------------------------------------------------- PIZ
def _piz(b: bytes, chans, shapes, name: str) -> List[np.ndarray]:
    """One PIZ chunk: the bitmap of the 16-bit words present, their Huffman
    code, then each channel's wavelet, one plane per 16-bit word."""
    lo, hi = struct.unpack_from("<HH", b, 0)
    pos = 4
    bitmap = np.zeros(8192, np.uint8)
    if lo <= hi:
        if hi >= 8192:
            raise OpenCVRefuses(f"{name}: bad PIZ bitmap range")
        bitmap[lo:hi + 1] = np.frombuffer(b, np.uint8, hi - lo + 1, pos)
        pos += hi - lo + 1
    present = np.unpackbits(bitmap, bitorder="little").astype(bool)
    present[0] = True
    lut = np.zeros(65536, np.uint16)
    vals = np.nonzero(present)[0]
    lut[:len(vals)] = vals
    max_value = len(vals) - 1
    length = struct.unpack_from("<i", b, pos)[0]
    pos += 4
    dts = [_DTYPES[c[1]] for c in chans]
    sizes = [ny * nx * dt.itemsize // 2 for (ny, nx), dt in zip(shapes, dts)]
    buf = huf_uncompress(b[pos:pos + length], sum(sizes), name)
    out, off = [], 0
    for (ny, nx), dt, n in zip(shapes, dts, sizes):
        planes = buf[off:off + n].reshape(ny, nx, dt.itemsize // 2)
        off += n
        for j in range(planes.shape[2] if n else 0):
            plane = np.ascontiguousarray(planes[..., j])
            wav2_decode(plane, max_value)
            planes[..., j] = plane
        out.append(lut[planes].astype("<u2").view(dt).reshape(ny, nx))
    return out


# ----------------------------------------------------------------- PXR24
def _pxr24(b: bytes, chans, shapes, ya: int, yb: int, name: str) -> List[np.ndarray]:
    """One PXR24 chunk: zlib, then line by line and channel by channel the
    samples' bytes in planes, most significant first, as differences;
    FLOAT keeps its upper 24 bits."""
    t = np.frombuffer(zlib.decompress(b), np.uint8)
    nplanes = [{0: 4, 1: 2, 2: 3}[c[1]] for c in chans]
    need = sum(k * ny * nx for k, (ny, nx) in zip(nplanes, shapes))
    if len(t) != need:
        raise OpenCVRefuses(f"{name}: PXR24 chunk at line {ya} of {len(t)} bytes, {need} "
                            f"expected")
    segs: List[list] = [[] for _ in chans]
    if all(c[4] == 1 for c in chans):
        rows = t.reshape(yb - ya + 1, -1) if need else np.zeros((yb - ya + 1, 0), np.uint8)
        off = 0
        for k, ((ny, nx), p) in enumerate(zip(shapes, nplanes)):
            segs[k].append(rows[:, off:off + p * nx].reshape(ny, p, nx))
            off += p * nx
    else:
        pos = 0
        for y in range(ya, yb + 1):
            for k, c in enumerate(chans):
                if y % c[4] == 0:
                    n = nplanes[k] * shapes[k][1]
                    segs[k].append(t[pos:pos + n].reshape(1, nplanes[k], -1))
                    pos += n
    out = []
    for c, seg, (ny, nx) in zip(chans, segs, shapes):
        p = (np.concatenate(seg) if seg else np.zeros((0, 1, nx), np.uint8)).astype(np.uint32)
        if c[1] == 1:
            diff = p[:, 0] << 8 | p[:, 1]
        else:
            diff = p[:, 0] << 24 | p[:, 1] << 16 | p[:, 2] << 8
            if c[1] == 0:
                diff |= p[:, 3]
        pix = np.cumsum(diff, axis=1, dtype=np.uint32).reshape(ny, nx)
        out.append(pix.astype("<u2").view("<f2") if c[1] == 1 else pix.view(_DTYPES[c[1]]))
    return out


# ------------------------------------------------------------------- B44
@functools.lru_cache(maxsize=None)
def _b44_log_table() -> np.ndarray:
    """B44's table (read-only) for channels with pLinear set: OpenEXR's
    logTable, which its convertToLinear applies on reading: 8 ln(h) of each
    half h >= 0 (ln as a correctly rounded float32, as glibc's logf gives
    it), 0 for negative halves, inf and NaN."""
    h = np.arange(65536, dtype=np.uint16).view(np.float16).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        y = np.log(h.astype(np.float64)).astype(np.float32) * np.float32(8)
    table = np.where(np.isfinite(h) & (h >= 0), y, 0).astype(np.float16).view(np.uint16)
    table.setflags(write=False)
    return table


def _unpack_b44(u8: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """unpack14 / unpack3 of the blocks at `starts`: (n, 16) uint16."""
    b = u8[starts[:, None] + np.arange(14)].astype(np.int64)
    s = np.zeros((len(starts), 16), np.int64)
    s[:, 0] = b[:, 0] << 8 | b[:, 1]
    shift = b[:, 2] >> 2
    bias = 0x20 << shift

    def step(dst, src, bits):
        s[:, dst] = (s[:, src] + ((bits & 0x3F) << shift) - bias) & 0xFFFF

    step(4, 0, b[:, 2] << 4 | b[:, 3] >> 4)
    step(8, 4, b[:, 3] << 2 | b[:, 4] >> 6)
    step(12, 8, b[:, 4])
    for col, i in ((1, 5), (2, 8), (3, 11)):
        step(col, col - 1, b[:, i] >> 2)
        step(col + 4, col + 3, b[:, i] << 4 | b[:, i + 1] >> 4)
        step(col + 8, col + 7, b[:, i + 1] << 2 | b[:, i + 2] >> 6)
        step(col + 12, col + 11, b[:, i + 2])
    flat = b[:, 2] >= (13 << 2)
    s[flat] = s[flat, :1]
    s = np.where(s & 0x8000, s & 0x7FFF, ~s & 0xFFFF)
    return s.astype(np.uint16)


def _b44(b: bytes, chans, shapes, name: str) -> List[np.ndarray]:
    """One B44 / B44A chunk, channel by channel: HALF samples in 4x4 blocks
    of 14 bytes (3 for a flat B44A block), the other types raw."""
    u8 = np.frombuffer(b + bytes(14), np.uint8)
    pos, out = 0, []
    for c, (ny, nx) in zip(chans, shapes):
        dt = _DTYPES[c[1]]
        if c[1] != 1:
            n = ny * nx * dt.itemsize
            if pos + n > len(b):
                raise OpenCVRefuses(f"{name}: B44 chunk too short")
            out.append(np.frombuffer(b, dt, ny * nx, pos).reshape(ny, nx))
            pos += n
            continue
        by, bx = -(-ny // 4), -(-nx // 4)
        starts = pos + 14 * np.arange(by * bx)  # no flat block (B44, mostly B44A)
        if not len(starts) or starts[-1] + 14 <= len(b) and (u8[starts + 2] < (13 << 2)).all():
            pos += 14 * len(starts)
        else:
            for i in range(by * bx):
                starts[i] = pos
                pos += 3 if pos + 2 < len(b) and b[pos + 2] >= (13 << 2) else 14
        if pos > len(b):
            raise OpenCVRefuses(f"{name}: B44 chunk too short")
        s = _unpack_b44(u8, starts)
        if c[2]:
            s = _b44_log_table()[s]
        s = s.reshape(by, bx, 4, 4).transpose(0, 2, 1, 3).reshape(by * 4, bx * 4)
        out.append(np.ascontiguousarray(s[:ny, :nx]).view("<f2"))
    return out


# ----------------------------------------------------------------- a part
def _chunk(comp: int, body: bytes, chans, xa: int, xb: int, ya: int, yb: int,
           name: str) -> List[np.ndarray]:
    """Each channel's (ny, nx) samples in one chunk (a block of lines or a
    tile) spanning xa..xb, ya..yb."""
    shapes = [(_num(c[4], ya, yb), _num(c[3], xa, xb)) for c in chans]
    raw_size = sum(ny * nx * _DTYPES[c[1]].itemsize for c, (ny, nx) in zip(chans, shapes))
    if comp == 0 or len(body) >= raw_size:
        return _split(body, chans, shapes, ya, yb, name)
    try:
        if comp == 1:
            return _split(_unpredict(_rle_decode(body, raw_size, name)), chans, shapes, ya, yb,
                          name)
        if comp in (2, 3):
            return _split(_unpredict(np.frombuffer(zlib.decompress(body), np.uint8)), chans,
                          shapes, ya, yb, name)
        if comp == 4:
            return _piz(body, chans, shapes, name)
        if comp == 5:
            return _pxr24(body, chans, shapes, ya, yb, name)
        if comp in (6, 7):
            return _b44(body, chans, shapes, name)
        from gd3d_torch.data.exr_dwa import dwa_uncompress  # it imports this module

        return dwa_uncompress(body, chans, shapes, name)
    except (zlib.error, struct.error, IndexError) as e:
        raise OpenCVRefuses(f"{name}: corrupt {COMPRESSIONS[comp]} chunk at line {ya} ({e})") \
            from e


def _decode(data: bytes, attrs, pos: int, multi: bool, name: str):
    """Every channel's samples over the data window (level 0 of a tiled
    part), in channel-list order."""
    chans = _channels(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    if comp not in COMPRESSIONS:
        raise OpenCVRefuses(f"{name}: unknown OpenEXR compression {comp}")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    h, w = y1 - y0 + 1, x1 - x0 + 1
    for c in chans:
        if c[1] not in _DTYPES or c[3] < 1 or c[4] < 1 or x0 % c[3] or y0 % c[4] \
                or w % c[3] or h % c[4]:
            raise OpenCVRefuses(f"{name}: OpenEXR channel '{c[0]}' of pixel type {c[1]} or "
                                f"sampling {c[3]}x{c[4]} that OpenEXR refuses here")
    out = [np.zeros((_num(c[4], y0, y1), _num(c[3], x0, x1)), _DTYPES[c[1]]) for c in chans]
    if "tiles" in attrs:
        tw, th = struct.unpack_from("<II", attrs["tiles"][1])
        if any(c[3] != 1 or c[4] != 1 for c in chans):
            raise OpenCVRefuses(f"{name}: subsampled channels in a tiled OpenEXR file")
        grid = [(tx, ty) for ty in range(-(-h // th)) for tx in range(-(-w // tw))]
    else:
        lines = LINES[comp]
        grid = [(0, r) for r in range(-(-h // lines))]
    offsets = np.frombuffer(data, "<u8", len(grid), pos) if pos + 8 * len(grid) <= len(data) \
        else None
    if offsets is None or ((offsets < pos) | (offsets >= len(data))).any():
        raise OpenCVRefuses(f"{name}: OpenEXR offset table out of the file")
    for (tx, ty), off in zip(grid, offsets.tolist()):
        if multi:  # each chunk names its part
            if struct.unpack_from("<i", data, off)[0] != 0:
                raise OpenCVRefuses(f"{name}: multi-part OpenEXR chunk of another part in "
                                    f"part 0's offset table")
            off += 4
        if "tiles" in attrs:
            got = struct.unpack_from("<iiiii", data, off)
            xa, ya = x0 + tx * tw, y0 + ty * th
            xb, yb = min(xa + tw - 1, x1), min(ya + th - 1, y1)
            if got[:4] != (tx, ty, 0, 0):
                raise OpenCVRefuses(f"{name}: OpenEXR tile {got[:4]} where ({tx}, {ty}, 0, 0) "
                                    f"belongs")
            size, off = got[4], off + 20
        else:
            ya, size = struct.unpack_from("<ii", data, off)
            xa, xb, yb = x0, x1, min(ya + lines - 1, y1)
            if ya != y0 + ty * lines:
                raise OpenCVRefuses(f"{name}: OpenEXR block at line {ya} where line "
                                    f"{y0 + ty * lines} belongs")
            off += 8
        if size < 0 or off + size > len(data):
            raise OpenCVRefuses(f"{name}: OpenEXR chunk at line {ya} past the end of the file")
        parts = _chunk(comp, data[off:off + size], chans, xa, xb, ya, yb, name)
        for c, full, part in zip(chans, out, parts):
            r, q = -(-ya // c[4]) - y0 // c[4], -(-xa // c[3]) - x0 // c[3]
            full[r:r + part.shape[0], q:q + part.shape[1]] = part
    return chans, out


# ------------------------------------------------------------ OpenCV's grey
def _grey(chans, samples, attrs, name: str) -> np.ndarray:
    """What OpenCV 4.6's ExrDecoder makes of the channels for a one-channel
    float image (cv2.IMREAD_ANYDEPTH)."""
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    h, w = y1 - y0 + 1, x1 - x0 + 1
    by = {c[0]: (c, s.astype(np.float32)) for c, s in zip(chans, samples)}
    if by.keys() & {"R", "G", "B"}:
        # RGBToGray on a line buffer that each line's readPixels refills,
        # each subsampled channel then widened in place (UpSampleX): a line
        # without samples keeps the last one's, widened once more
        xr, xg, xb = REC709_X
        if attrs.get("chromaticities", ("",))[0] == "chromaticities":
            xr, xg, xb = struct.unpack_from("<8f", attrs["chromaticities"][1])[0:6:2]
        full = {}
        for ch in "BGR":
            if ch not in by:
                full[ch] = np.zeros((h, w), np.float32)
            else:
                (_, _, _, xs, ys), s = by[ch]
                if xs > 1 and x0:
                    raise ValueError(f"{name}: OpenEXR channel {ch} subsampled in x with the "
                                     f"data window at x={x0}: OpenCV 4.6 writes outside its "
                                     f"buffer here")
                yy = np.arange(y0, y1 + 1)
                d = yy % ys
                rows = (yy - d) // ys - y0 // ys
                if xs == 1:
                    full[ch] = s[rows]
                else:
                    cols = np.arange(w)[None, :] // (np.int64(xs) ** (d + 1))[:, None]
                    full[ch] = s[rows[:, None], cols]
        grey = full["B"] * np.float32(xb) + full["G"] * np.float32(xg) + full["R"] * np.float32(xr)
        if "G" in by and by["G"][0][3:] != (1, 1):
            # UpSampleY on the grey image, by G's y sampling alone
            ys = by["G"][0][4]
            grey = grey[np.arange(h) // ys * ys]
        return grey
    if "Y" in by or "Z" in by:
        if by.keys() & {"RY", "BY"}:
            raise ValueError(f"{name}: OpenEXR luminance-chroma channels (Y with RY or BY): "
                             f"OpenCV 4.6's grey of these is uninitialised memory")
        (_, _, _, xs, ys), s = by["Y"] if "Y" in by else by["Z"]
        if (xs > 1 and x0) or (ys > 1 and y0):
            raise ValueError(f"{name}: OpenEXR channel subsampled with the data window at "
                             f"({x0}, {y0}): OpenCV 4.6 writes outside its buffer here")
        if "Y" not in by:
            # OpenCV takes Z for grey but asks OpenEXR for "Y", which fills 0
            return np.zeros((h, w), np.float32)
        return s[np.arange(h) // ys][:, np.arange(w) // xs]
    raise OpenCVRefuses(f"{name}: OpenEXR without an R, G, B, Y or Z channel "
                        f"({', '.join(c[0] for c in chans)})")


def read_exr(src: Source) -> np.ndarray:
    """(H, W) float32: cv2.imread(src, IMREAD_ANYDEPTH) (see the module
    docstring). Raises OpenCVRefuses where OpenCV returns None."""
    data, name = read_source(src)
    attrs, pos = _header(data, name)
    flags = struct.unpack_from("<I", data, 4)[0]
    kind = attrs.get("type", ("", b""))[1].rstrip(b"\x00").decode(errors="replace")
    if flags & 0x800 or kind.startswith("deep"):
        raise OpenCVRefuses(f"{name}: deep OpenEXR data (OpenCV reads it through "
                            f"Imf::InputFile, which refuses it)")
    if flags & 0xFF != 2:
        raise OpenCVRefuses(f"{name}: OpenEXR version {flags & 0xFF}")
    tiled = "tiles" in attrs
    if bool(flags & 0x200) != tiled and not flags & 0x1000:
        raise OpenCVRefuses(f"{name}: OpenEXR tiled flag and tile description disagree")
    if flags & 0x1000 and (tiled != (kind == "tiledimage") or kind not in ("scanlineimage",
                                                                            "tiledimage")):
        raise OpenCVRefuses(f"{name}: multi-part OpenEXR part 0 of type '{kind}'")
    for key in ("channels", "compression", "dataWindow"):
        if key not in attrs:
            raise OpenCVRefuses(f"{name}: OpenEXR header without '{key}'")
    chans, samples = _decode(data, attrs, pos, bool(flags & 0x1000), name)
    return _grey(chans, samples, attrs, name)
