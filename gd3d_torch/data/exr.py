"""OpenEXR depth decoding without cv2, to cv2's float32 array.

dust3r's preprocessing writes float depth with `cv2.imwrite(path.exr, d)`
(one channel, which OpenCV names "Y"), and gd3d reads it back with
`cv2.imread(path, IMREAD_ANYDEPTH)` wherever its cv2 has the EXR codec
(gd3d/data/stereo_views.py::read_depth_float); the card's machine has no
cv2. `read_exr(path)` gives that (H, W) float32 array for single-part
scanline files:

  * one channel named Y (or Z, which OpenCV takes for grey as well) of
    HALF (widened exactly), FLOAT or UINT (converted to float32) samples;
  * the NONE, RLE, ZIPS, ZIP and PIZ compressions (OpenEXR's byte
    predictor and half-split reorder for RLE and ZIP; PIZ's bitmap range
    table, Huffman code and 14- or 16-bit Haar wavelet), blocks placed by
    their own y, any line order, the data window's size.

Refused with a ValueError naming the file and the feature: several
channels (OpenCV's conversion to grey is not held here), subsampled
channels, tiled, multi-part and deep files, and the lossy PXR24, B44(A)
and DWAA/DWAB compressions.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from gd3d_torch.data.source import Source, read_source


MAGIC = b"\x76\x2f\x31\x01"
COMPRESSIONS = {0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ", 5: "PXR24", 6: "B44",
                7: "B44A", 8: "DWAA", 9: "DWAB"}
LINES = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32}
_DTYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}


def _header(data: bytes, name: str):
    if data[:4] != MAGIC:
        raise ValueError(f"{name}: not an OpenEXR file")
    flags = struct.unpack_from("<I", data, 4)[0]
    for bit, what in ((0x200, "tiled"), (0x800, "deep"), (0x1000, "multi-part")):
        if flags & bit:
            raise ValueError(f"{name}: {what} OpenEXR is not supported (single-part scanline "
                             f"only)")
    attrs: Dict[str, Tuple[str, bytes]] = {}
    pos = 8
    while data[pos] != 0:
        an = data.index(b"\x00", pos)
        tn = data.index(b"\x00", an + 1)
        size = struct.unpack_from("<i", data, tn + 1)[0]
        attrs[data[pos:an].decode()] = (data[an + 1:tn].decode(), data[tn + 5:tn + 5 + size])
        pos = tn + 5 + size
    return attrs, pos + 1


def _channels(b: bytes):
    out = []
    pos = 0
    while b[pos] != 0:
        end = b.index(b"\x00", pos)
        ptype, _, xs, ys = struct.unpack_from("<iB3xii", b, end + 1)
        out.append((b[pos:end].decode(), ptype, xs, ys))
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
        raise ValueError(f"{name}: corrupt RLE block in OpenEXR file")
    return np.frombuffer(bytes(out), np.uint8)


# ------------------------------------------------------------------- PIZ
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
    """hufUncompress: n_raw uint16 symbols; the symbol iM stands for a run
    of the previous value, its count in the next 8 bits."""
    if not b:
        if n_raw:
            raise ValueError(f"{name}: empty PIZ Huffman data")
        return np.zeros(0, np.uint16)
    im, iM, _, nbits = struct.unpack_from("<iiii", b, 0)
    if not (0 <= im < HUF_ENCSIZE and 0 <= iM < HUF_ENCSIZE):
        raise ValueError(f"{name}: bad PIZ Huffman table range")
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
        raise ValueError(f"{name}: PIZ Huffman table too long")
    codes = canonical_codes(lengths)
    table = {(int(lengths[s]), int(codes[s])): int(s) for s in np.nonzero(lengths)[0]}
    data_start = br.pos
    bits = np.unpackbits(np.frombuffer(b, np.uint8, (nbits + 7) // 8, data_start))[:nbits]
    bits = bits.tolist()
    out = []
    code = ln = 0
    k = 0
    while k < nbits:
        code = (code << 1) | bits[k]
        ln += 1
        k += 1
        sym = table.get((ln, code))
        if sym is None:
            if ln > 58:
                raise ValueError(f"{name}: invalid PIZ Huffman code")
            continue
        code = ln = 0
        if sym == iM:
            if k + 8 > nbits or not out:
                raise ValueError(f"{name}: bad PIZ run")
            cnt = 0
            for _ in range(8):
                cnt = (cnt << 1) | bits[k]
                k += 1
            out.extend([out[-1]] * cnt)
        else:
            out.append(sym)
    if len(out) != n_raw:
        raise ValueError(f"{name}: PIZ Huffman data of {len(out)} values, {n_raw} expected")
    return np.asarray(out, np.uint16)


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


def _piz(b: bytes, nx: int, ny: int, words: int, name: str) -> bytes:
    """One PIZ block of one channel: ny lines of nx samples of `words`
    16-bit words -> the block's little-endian bytes."""
    lo, hi = struct.unpack_from("<HH", b, 0)
    pos = 4
    bitmap = np.zeros(8192, np.uint8)
    if lo <= hi:
        if hi >= 8192:
            raise ValueError(f"{name}: bad PIZ bitmap range")
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
    buf = huf_uncompress(b[pos:pos + length], nx * ny * words, name)
    planes = buf.reshape(ny, nx, words)
    for j in range(words):
        plane = np.ascontiguousarray(planes[..., j])
        wav2_decode(plane, max_value)
        planes[..., j] = plane
    return lut[planes].astype("<u2").tobytes()


def read_exr(src: Source) -> np.ndarray:
    """(H, W) float32: cv2.imread(src, IMREAD_ANYDEPTH) of a one-channel
    EXR (see the module docstring)."""
    data, name = read_source(src)
    attrs, pos = _header(data, name)
    chans = _channels(attrs["channels"][1])
    if len(chans) != 1:
        raise ValueError(f"{name}: OpenEXR with {len(chans)} channels "
                         f"({', '.join(c[0] for c in chans)}) is not supported (one Y channel)")
    cname, ptype, xs, ys = chans[0]
    if cname not in ("Y", "Z"):
        raise ValueError(f"{name}: OpenEXR channel '{cname}' is not supported (Y or Z)")
    if (xs, ys) != (1, 1):
        raise ValueError(f"{name}: subsampled OpenEXR channels are not supported")
    if ptype not in _DTYPES:
        raise ValueError(f"{name}: OpenEXR pixel type {ptype} is not supported")
    comp = attrs["compression"][1][0]
    if comp not in LINES:
        raise ValueError(f"{name}: OpenEXR compression "
                         f"{COMPRESSIONS.get(comp, comp)} is not supported (NONE, RLE, ZIPS, "
                         f"ZIP and PIZ)")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    dt = _DTYPES[ptype]
    lines = LINES[comp]
    nblocks = -(-h // lines)
    offsets = np.frombuffer(data, "<u8", nblocks, pos)
    out = np.zeros((h, w), dt)
    for off in offsets.tolist():
        y, size = struct.unpack_from("<ii", data, off)
        r = y - y0
        if not 0 <= r < h:
            raise ValueError(f"{name}: OpenEXR block at line {y} outside the data window")
        n = min(lines, h - r)
        raw_size = n * w * dt.itemsize
        body = data[off + 8:off + 8 + size]
        if size < raw_size and comp:
            if comp == 1:
                body = _unpredict(_rle_decode(body, raw_size, name))
            elif comp in (2, 3):
                body = _unpredict(np.frombuffer(zlib.decompress(body), np.uint8))
            else:
                body = _piz(body, w, n, dt.itemsize // 2, name)
        if len(body) != raw_size:
            raise ValueError(f"{name}: OpenEXR block at line {y} of {len(body)} bytes, "
                             f"{raw_size} expected")
        out[r:r + n] = np.frombuffer(body, dt).reshape(n, w)
    return out.astype(np.float32)
