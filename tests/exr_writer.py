"""A numpy OpenEXR writer for the tests of gd3d_torch/data/exr.py (the port
writes no EXR; OpenCV's writer, tests/exr_oracle.py, writes only R, G, B or
Y scanline files): scanline files of any channels (names, float32, float16
or uint32 samples, x / y sampling), an optional chromaticities attribute,
tiled files (ONE_LEVEL, MIPMAP or RIPMAP, rounding DOWN or UP, any line
order), multi-part files and minimal deep files; in the NONE, RLE, ZIPS,
ZIP and PIZ compressions (and B44 for channels it stores raw: all but
HALF), following OpenEXR's compressors (the byte predictor and half-split
reorder of RLE and ZIP, OpenEXR's run-length code; PIZ's bitmap range table,
14- or 16-bit Haar wavelet and run-length Huffman code with its packed
table). A chunk that does not shrink is stored raw, as OpenEXR does.

    write_exr(path, array, compression="ZIP", channel="Y", line_order=0,
              origin=(0, 0))
    write_image(path, {"R": r, "G": g, "B": b}, compression="PIZ",
                sampling={"B": (2, 2)}, chromaticities=(...8 floats...),
                tiles=(16, 16, "MIPMAP", "DOWN"))
    write_parts(path, [dict(channels=...), dict(channels=..., tiles=...)])
    write_deep(path, array, tiled=False)
"""
import heapq
import struct
import zlib

import numpy as np

from gd3d_torch.data.exr import LINES, MAGIC, canonical_codes

CODES = {"NONE": 0, "RLE": 1, "ZIPS": 2, "ZIP": 3, "PIZ": 4, "PXR24": 5, "B44": 6, "B44A": 7,
         "DWAA": 8, "DWAB": 9}
PTYPES = {np.dtype("<u4"): 0, np.dtype("<f2"): 1, np.dtype("<f4"): 2}


def _attr(name, kind, value):
    return name.encode() + b"\x00" + kind.encode() + b"\x00" + struct.pack("<i", len(value)) + value


def _predict(raw: bytes) -> bytes:
    """OpenEXR's RLE / ZIP pre-pass: the two halves split, then each byte
    replaced by its difference to the one before, plus 128."""
    u = np.frombuffer(raw, np.uint8)
    t = np.concatenate([u[0::2], u[1::2]]).astype(np.int64)
    d = t.copy()
    d[1:] = (t[1:] - t[:-1] + 128 + 256) & 255
    return d.astype(np.uint8).tobytes()


def _rle(b: bytes) -> bytes:
    """Runs of 3-128 equal bytes as (count - 1, byte), the rest as literal
    runs of up to 127 bytes (negative count)."""
    out = bytearray()
    i, n = 0, len(b)
    lit = bytearray()

    def flush():
        while lit:
            part = lit[:127]
            del lit[:127]
            out.append(256 - len(part))
            out.extend(part)

    while i < n:
        j = i + 1
        while j < n and b[j] == b[i] and j - i < 128:
            j += 1
        if j - i >= 3:
            flush()
            out += bytes([j - i - 1, b[i]])
            i = j
        else:
            lit.append(b[i])
            i += 1
    flush()
    return bytes(out)


# -------------------------------------------------------------------- PIZ
def _wenc(a, b, w14):
    if w14:
        a_s, b_s = a.astype(np.int16).astype(np.int32), b.astype(np.int16).astype(np.int32)
        m, d = (a_s + b_s) >> 1, a_s - b_s
        return (m & 0xFFFF).astype(np.uint16), (d & 0xFFFF).astype(np.uint16)
    ao = (a.astype(np.int32) + 32768) & 0xFFFF
    b = b.astype(np.int32)
    m, d = (ao + b) >> 1, ao - b
    m = np.where(d < 0, (m + 32768) & 0xFFFF, m)
    return m.astype(np.uint16), (d & 0xFFFF).astype(np.uint16)


def wav2_encode(p: np.ndarray, mx: int) -> None:
    """OpenEXR's wav2Encode on a (ny, nx) uint16 plane, in place."""
    ny, nx = p.shape
    w14 = mx < (1 << 14)
    n = min(nx, ny)
    s, s2 = 1, 2
    while s2 <= n:
        ye, xe = ny - s2 + 1, nx - s2 + 1
        nyb, nxb = len(range(0, max(ye, 0), s2)), len(range(0, max(xe, 0), s2))
        ys, xs = slice(0, ye, s2), slice(0, xe, s2)
        ys1, xs1 = slice(s, ye + s, s2), slice(s, xe + s, s2)
        if nyb and nxb:
            i00, i01 = _wenc(p[ys, xs], p[ys, xs1], w14)
            i10, i11 = _wenc(p[ys1, xs], p[ys1, xs1], w14)
            p[ys, xs], p[ys1, xs] = _wenc(i00, i10, w14)
            p[ys, xs1], p[ys1, xs1] = _wenc(i01, i11, w14)
        if nx & s and nyb:
            x = nxb * s2
            p[ys, x], p[ys1, x] = _wenc(p[ys, x], p[ys1, x], w14)
        if ny & s and nxb:
            y = nyb * s2
            p[y, xs], p[y, xs1] = _wenc(p[y, xs], p[y, xs1], w14)
        s, s2 = s2, s2 << 1


def _lengths(freq: dict) -> dict:
    heap = [(f, i, [s]) for i, (s, f) in enumerate(sorted(freq.items()))]
    heapq.heapify(heap)
    depth = {s: 0 for s in freq}
    k = len(heap)
    while len(heap) > 1:
        f1, _, a = heapq.heappop(heap)
        f2, _, b = heapq.heappop(heap)
        for s in a + b:
            depth[s] += 1
        heapq.heappush(heap, (f1 + f2, k, a + b))
        k += 1
    return depth


def _pack_bits(lens, vals) -> bytes:
    """The MSB-first codes vals[i] of lens[i] bits, packed into bytes."""
    if not len(lens):
        return b""
    n = np.asarray(lens, np.int64)
    v = np.asarray(vals, np.uint64)
    k = np.arange(64)
    bits = (v[:, None] >> np.clip(n[:, None] - 1 - k, 0, 63).astype(np.uint64)) & np.uint64(1)
    return np.packbits(bits[k < n[:, None]].astype(np.uint8)).tobytes()


def huf_compress(raw: np.ndarray) -> bytes:
    vals = np.asarray(raw, np.int64)
    # runs of equal values, each as (symbol, extra repeats up to 255)
    starts = np.concatenate([[0], np.nonzero(np.diff(vals))[0] + 1])
    lens = np.diff(np.concatenate([starts, [len(vals)]]))
    pieces = -(-lens // 256)
    first = np.repeat(starts, pieces) + 256 * (np.arange(pieces.sum())
                                                - np.repeat(np.cumsum(pieces) - pieces, pieces))
    extra = np.minimum(np.repeat(starts + lens, pieces) - first, 256) - 1
    uniq, inv = np.unique(vals[first], return_inverse=True)
    freq = dict(zip(uniq.tolist(), np.bincount(inv, weights=extra + 1).astype(np.int64).tolist()))
    im, iM = min(freq), max(freq) + 1  # the pseudo-symbol iM marks a run
    freq[iM] = 1
    depth = _lengths(freq)
    lengths = np.zeros(iM + 1, np.int64)
    for s, d in depth.items():
        lengths[s] = max(d, 1)
    assert lengths.max() <= 58
    codes = canonical_codes(lengths)
    table = []  # (bits, value) of each 6-bit length, zero runs as 59-62 or 63 + 8 bits
    prev = im - 1
    for s in sorted(depth):  # each code length, after the run of zeros before it
        gap = s - prev - 1
        while gap >= 2:
            run = min(gap, 255 + 6)
            table += [(6, 63), (8, run - 6)] if run >= 6 else [(6, 59 + run - 2)]
            gap -= run
        if gap:
            table.append((6, 0))
        table.append((6, int(lengths[s])))
        prev = s
    # each run as its code r + 1 times, or as code, iM's code, 8-bit r where shorter
    sym, rep = vals[first], extra
    ls, lr = lengths[sym], int(lengths[iM])
    rle = (rep > 0) & (ls + lr + 8 < ls * (rep + 1))
    count = np.where(rle, 3, rep + 1)
    item = np.repeat(np.arange(len(sym)), count)
    k = np.arange(len(item)) - np.repeat(np.cumsum(count) - count, count)
    on = rle[item]
    lens = np.where(on & (k == 1), lr, np.where(on & (k == 2), 8, ls[item]))
    vals = np.where(on & (k == 1), codes[iM], np.where(on & (k == 2), rep[item],
                                                        codes[sym][item]))
    tb = _pack_bits(*zip(*table))
    return struct.pack("<iiiii", im, iM, len(tb), int(lens.sum()), 0) + tb + _pack_bits(lens,
                                                                                        vals)


def piz_block(planes) -> bytes:
    """One PIZ block of several channels: `planes` holds each channel's
    (ny, nx) samples within the block, in channel order."""
    words = [np.ascontiguousarray(p).view("<u2").reshape(p.shape[0], p.shape[1], -1)
             for p in planes]
    v = np.concatenate([w.reshape(-1) for w in words])
    present = np.zeros(65536, bool)
    present[v] = True
    present[0] = False
    bitmap = np.packbits(present, bitorder="little")
    nz = np.nonzero(bitmap)[0]
    lo, hi = (int(nz[0]), int(nz[-1])) if len(nz) else (8191, 0)
    present[0] = True
    lut = np.zeros(65536, np.uint16)
    lut[present] = np.arange(present.sum())
    max_value = int(present.sum()) - 1
    out = []
    for w in words:
        w = lut[w]
        for j in range(w.shape[2]):
            plane = np.ascontiguousarray(w[..., j])
            wav2_encode(plane, max_value)
            w[..., j] = plane
        out.append(w.reshape(-1))
    huf = huf_compress(np.concatenate(out))
    head = struct.pack("<HH", lo, hi) + (bitmap[lo:hi + 1].tobytes() if lo <= hi else b"")
    return head + struct.pack("<i", len(huf)) + huf


# ------------------------------------------------------------ the file
LEVEL_MODES = {"ONE_LEVEL": 0, "MIPMAP": 1, "RIPMAP": 2}
ROUNDING = {"DOWN": 0, "UP": 1}


def _chlist(chans, p_linear=()) -> bytes:
    return b"".join(name.encode() + b"\x00" + struct.pack("<iB3xii", PTYPES[a.dtype],
                                                           name in p_linear, xs, ys)
                    for name, a, xs, ys in chans) + b"\x00"


def _float24(a: np.ndarray) -> np.ndarray:
    """OpenEXR's floatToFloat24: the upper 24 bits of each float32, the
    significand rounded (half up), NaNs kept NaN."""
    u = a.view("<u4").astype(np.int64)
    s, e, m = u & 0x80000000, u & 0x7F800000, u & 0x007FFFFF
    rounded = ((e | m) + (m & 0x80)) >> 8
    finite = np.where(rounded >= 0x7F8000, (e | m) >> 8, rounded)
    special = (e >> 8) | (m >> 8) | ((m != 0) & ((m >> 8) == 0))
    return ((s >> 8) | np.where(e == 0x7F800000, special, finite)).astype(np.uint32)


def _pxr24(planes, lines) -> bytes:
    """PXR24: line by line and channel by channel, each sample's bytes (the
    24 upper bits of a FLOAT) as differences, most significant plane first,
    then zlib."""
    out = []
    for _, row in lines:
        for c, r in row:
            v = planes[c][r]
            if v.dtype == np.float32:
                pix, nbytes = _float24(v), 3
            else:
                pix, nbytes = v.view("<u2" if v.dtype == np.float16 else "<u4").astype(
                    np.uint32), v.dtype.itemsize
            d = np.diff(pix.astype(np.int64), prepend=0) & 0xFFFFFFFF
            out += [((d >> (8 * (nbytes - 1 - k))) & 255).astype(np.uint8).tobytes()
                    for k in range(nbytes)]
    return zlib.compress(b"".join(out))


# ------------------------------------------------------------------- B44
def _shift_round(x, shift):
    x = x << 1
    return (x + (1 << shift) - 1 + ((x >> (shift + 1)) & 1)) >> (shift + 1)


def _b44_pack(s, flat_fields):
    """OpenEXR's B44 pack of 16 half bits: 14 bytes, or 3 for a flat block
    (B44A)."""
    t = [0x8000 if (v & 0x7C00) == 0x7C00 else (~v & 0xFFFF if v & 0x8000 else v | 0x8000)
         for v in s]
    t_max = max(t)
    shift = -1
    while True:
        shift += 1
        d = [_shift_round(t_max - v, shift) for v in t]
        r = [d[0] - d[4], d[4] - d[8], d[8] - d[12], d[0] - d[1], d[4] - d[5], d[8] - d[9],
             d[12] - d[13], d[1] - d[2], d[5] - d[6], d[9] - d[10], d[13] - d[14], d[2] - d[3],
             d[6] - d[7], d[10] - d[11], d[14] - d[15]]
        r = [v + 0x20 for v in r]
        if min(r) >= 0 and max(r) <= 0x3F:
            break
    if flat_fields and min(r) == max(r) == 0x20:
        return bytes([t[0] >> 8, t[0] & 255, 0xFC])
    t0 = (t_max - (d[0] << shift)) & 0xFFFF
    b = [t0 >> 8, t0 & 255, (shift << 2) | (r[0] >> 4), (r[0] << 4) | (r[1] >> 2),
         (r[1] << 6) | r[2], (r[3] << 2) | (r[4] >> 4), (r[4] << 4) | (r[5] >> 2),
         (r[5] << 6) | r[6], (r[7] << 2) | (r[8] >> 4), (r[8] << 4) | (r[9] >> 2),
         (r[9] << 6) | r[10], (r[11] << 2) | (r[12] >> 4), (r[12] << 4) | (r[13] >> 2),
         (r[13] << 6) | r[14]]
    return bytes(v & 255 for v in b)


def _b44(planes, flat_fields) -> bytes:
    """B44 / B44A: each HALF channel in 4x4 blocks (the last row and column
    repeated to fill them), the other channels raw, channel by channel."""
    out = []
    for p in planes:
        if p.dtype != np.float16:
            out.append(p.tobytes())
            continue
        ny, nx = p.shape
        if not ny or not nx:
            continue
        q = np.pad(p.view("<u2"), ((0, -ny % 4), (0, -nx % 4)), mode="edge")
        for by in range(0, q.shape[0], 4):
            for bx in range(0, q.shape[1], 4):
                out.append(_b44_pack(q[by:by + 4, bx:bx + 4].reshape(-1).tolist(), flat_fields))
    return b"".join(out)


# ------------------------------------------------------------------- DWA
# OpenEXR's default rules: (suffix, scheme, pixel type, R/G/B role, case-insensitive);
# schemes 0 UNKNOWN (zlib), 1 LOSSY_DCT, 2 RLE
DWA_RULES = ([(c, 1, t, k, False) for k, c in enumerate("RGB") for t in (1, 2)]
             + [(c, 1, t, -1, False) for c in ("Y", "BY", "RY") for t in (1, 2)]
             + [("A", 2, t, -1, False) for t in (0, 1, 2)])
DWA_LEGACY_RULES = ([(s, 1, t, k, True) for k, names in enumerate(
    (("r", "red"), ("g", "grn", "green"), ("b", "blu", "blue"))) for s in names for t in (1, 2)]
                    + [(s, 1, t, -1, True) for s in ("y", "by", "ry") for t in (1, 2)]
                    + [("a", 2, t, -1, True) for t in (0, 1, 2)])
_DCT = np.array([[np.sqrt((1 if k else 0.5) / 4) * np.cos((2 * n + 1) * k * np.pi / 16)
                  for n in range(8)] for k in range(8)])  # orthonormal DCT-II rows
_ZZ = np.array([0, 1, 5, 6, 14, 15, 27, 28, 2, 4, 7, 13, 16, 26, 29, 42, 3, 8, 12, 17, 25, 30,
                41, 43, 9, 11, 18, 24, 31, 40, 44, 53, 10, 19, 23, 32, 39, 45, 52, 54, 20, 22,
                33, 38, 46, 51, 55, 60, 21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58,
                62, 63])


def _dwa_blocks(comps, quant):
    """(DC halves per component, AC run-length code) of 1 or 3 (R, G, B)
    planes: the samples taken to OpenEXR's nonlinear domain (and Y'CbCr for
    three), forward DCT, coefficients as halves with those below `quant`
    dropped."""
    x = [np.asarray(c, np.float64) for c in comps]
    x = [np.where(np.abs(v) <= 1, np.sign(v) * np.abs(v) ** (1 / 2.2),
                  np.sign(v) * (np.log(np.maximum(np.abs(v), 1e-30)) / 2.2 + 1)) for v in x]
    if len(x) == 3:
        yl = 0.2126 * x[0] + 0.7152 * x[1] + 0.0722 * x[2]
        x = [yl, (x[2] - yl) / 1.8556, (x[0] - yl) / 1.5747]
    h, w = x[0].shape
    x = [np.pad(v, ((0, -h % 8), (0, -w % 8)), mode="edge") for v in x]
    nby, nbx = x[0].shape[0] // 8, x[0].shape[1] // 8
    coef = [_DCT @ v.reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3) @ _DCT.T for v in x]
    coef = [c.reshape(-1, 64) for c in coef]
    for c in coef:
        c[:, 1:][np.abs(c[:, 1:]) < quant] = 0
    zz = [np.zeros_like(c) for c in coef]
    for z, c in zip(zz, coef):
        z[:, _ZZ] = c
    bits = [z.astype(np.float16).view(np.uint16) for z in zz]
    dc = [b[:, 0] for b in bits]
    ac = []
    for blk in range(nby * nbx):
        for b in bits:
            v, k = b[blk], 1
            while k < 64:
                if v[k]:
                    ac.append(int(v[k]))
                    k += 1
                    continue
                n = 1
                while k + n < 64 and not v[k + n]:
                    n += 1
                ac.append(0 if n == 1 else 0xFF00 if k + n == 64 else 0xFF00 | n)
                k += n
    return dc, ac


def _dwa(planes, chans, opts) -> bytes:
    """One DWAA / DWAB chunk. `opts`: version (2 writes the rules; 1 leaves
    them to OpenEXR's legacy list), rules, ac ("huffman" or "deflate") and
    quant (the AC magnitude kept)."""
    version = opts.get("version", 2)
    rules = opts.get("rules", DWA_RULES if version == 2 else DWA_LEGACY_RULES)
    schemes, sets = [0] * len(chans), {}
    for k, (name, a, xs, ys) in enumerate(chans):
        prefix, _, suffix = name.rpartition(".")
        roles = sets.setdefault(prefix, [-1, -1, -1])
        for rs, scheme, ptype, csc, nocase in rules:
            if ptype == PTYPES[a.dtype] and (suffix.lower() if nocase else suffix) == rs:
                schemes[k] = scheme
                if csc >= 0:
                    roles[csc] = k
    triples = [tuple(sets[p]) for p in sorted(sets) if min(sets[p]) >= 0
               and len({chans[i][2:] for i in sets[p]}) == 1]
    in_triple = {i for t in triples for i in t}
    groups = triples + [(k,) for k in range(len(chans)) if schemes[k] == 1 and k not in in_triple]
    dc, ac = [], []
    for g in groups:
        d, a = _dwa_blocks([planes[k].astype(np.float32) for k in g], opts.get("quant", 0.01))
        dc += [v for comp in d for v in comp.tolist()]
        ac += a
    unknown = b"".join(planes[k].tobytes() for k in range(len(chans)) if schemes[k] == 0)
    rle_raw = b"".join(np.ascontiguousarray(planes[k].reshape(-1).view(np.uint8).reshape(
        -1, planes[k].dtype.itemsize).T).tobytes() for k in range(len(chans)) if schemes[k] == 2)
    rle = _rle(rle_raw) if rle_raw else b""
    unk_z = zlib.compress(unknown) if unknown else b""
    rle_z = zlib.compress(rle) if rle else b""
    dc_z = zlib.compress(_predict(np.asarray(dc, "<u2").tobytes())) if dc else b""
    deflate = opts.get("ac", "huffman") == "deflate"
    ac_z = b"" if not ac else (zlib.compress(np.asarray(ac, "<u2").tobytes()) if deflate
                               else huf_compress(np.asarray(ac, np.int64)))
    head = struct.pack("<11Q", version, len(unknown), len(unk_z), len(ac_z), len(dc_z),
                       len(rle_z), len(rle), len(rle_raw), len(ac), len(dc), int(deflate))
    if version == 2:
        body = b"".join(r[0].encode() + b"\x00" + bytes([(r[3] + 1) << 4 | r[1] << 2 | r[4], r[2]])
                        for r in rules)
        head += struct.pack("<H", len(body) + 2) + body
    return head + unk_z + ac_z + dc_z + rle_z


def _compress(comp, planes, lines, chans=(), opts=None) -> bytes:
    """One chunk's data: `planes` are each channel's samples in the chunk,
    `lines` the (line, [(channel index, row)]) list of OpenEXR's raw
    layout."""
    raw = b"".join(planes[c][r].tobytes() for _, row in lines for c, r in row)
    if not raw:
        return raw
    if comp == 1:
        body = _rle(_predict(raw))
    elif comp in (2, 3):
        body = zlib.compress(_predict(raw))
    elif comp == 4:
        body = piz_block(planes)
    elif comp == 5:
        body = _pxr24(planes, lines)
    elif comp in (6, 7):
        body = _b44(planes, comp == 7)
    elif comp in (8, 9):
        body = _dwa(planes, chans, opts or {})
    elif comp == 0:
        body = raw
    else:
        raise ValueError(f"the writer does not write compression {comp}")
    return body if len(body) < len(raw) else raw


def _level_size(n, level, rounding):
    s = n >> level
    if rounding and (s << level) < n:
        s += 1
    return max(s, 1)


def _num_levels(n, rounding):
    k = 0
    while (1 << k) < n if rounding else (2 << k) <= n:
        k += 1
    return k + 1


def _levels(w, h, mode, rounding):
    """(lx, ly, width, height) of every level, in the offset table's order."""
    if mode == "ONE_LEVEL":
        return [(0, 0, w, h)]
    if mode == "MIPMAP":
        return [(k, k, _level_size(w, k, rounding), _level_size(h, k, rounding))
                for k in range(_num_levels(max(w, h), rounding))]
    return [(lx, ly, _level_size(w, lx, rounding), _level_size(h, ly, rounding))
            for ly in range(_num_levels(h, rounding)) for lx in range(_num_levels(w, rounding))]


def _part(channels, compression="ZIP", line_order=0, origin=(0, 0), sampling=None,
          chromaticities=None, tiles=None, p_linear=(), attrs=(), dwa=None):
    """(header attributes, chunks) of one part. `channels` maps names to
    arrays of each channel's samples; `sampling` maps names to (xs, ys);
    `tiles` is (width, height, level mode, rounding mode); `attrs` adds
    (name, type, bytes) attributes; `dwa` holds _dwa's options."""
    sampling = sampling or {}
    chans = [(n, np.asarray(a).astype(np.dtype(np.asarray(a).dtype).newbyteorder("<")),
              *sampling.get(n, (1, 1))) for n, a in sorted(channels.items())]
    h, w = [(a.shape[0] * ys, a.shape[1] * xs) for _, a, xs, ys in chans][0]
    x0, y0 = origin
    comp = CODES[compression]
    box = struct.pack("<iiii", x0, y0, x0 + w - 1, y0 + h - 1)
    header = [("channels", "chlist", _chlist(chans, p_linear)),
              ("compression", "compression", bytes([comp])),
              ("dataWindow", "box2i", box), ("displayWindow", "box2i", box),
              ("lineOrder", "lineOrder", bytes([line_order])),
              ("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
              ("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0)),
              ("screenWindowWidth", "float", struct.pack("<f", 1.0))]
    if chromaticities is not None:
        header.append(("chromaticities", "chromaticities", struct.pack("<8f", *chromaticities)))
    chunks = []  # (sort key, chunk bytes)
    if tiles is None:
        lines = LINES.get(comp, 32)
        for r in range(0, h, lines):
            rows = range(y0 + r, y0 + min(r + lines, h))
            planes = [a[[y // ys - y0 // ys for y in rows if y % ys == 0]]
                      for _, a, xs, ys in chans]
            seen = [0] * len(chans)
            order = []
            for y in rows:
                row = [(c, seen[c]) for c, ch in enumerate(chans) if y % ch[3] == 0]
                for c, _ in row:
                    seen[c] += 1
                order.append((y, row))
            body = _compress(comp, planes, order, chans, dwa)
            chunks.append((r, struct.pack("<ii", y0 + r, len(body)) + body))
    else:
        tw, th, mode, rounding = tiles
        header.append(("tiles", "tiledesc", struct.pack("<IIB", tw, th, LEVEL_MODES[mode]
                                                        | ROUNDING[rounding] << 4)))
        for lx, ly, lw, lh in _levels(w, h, mode, rounding):
            for ty in range(-(-lh // th)):
                for tx in range(-(-lw // tw)):
                    planes = []
                    for _, a, _, _ in chans:
                        level = a[::1 << ly, ::1 << lx]
                        level = np.pad(level, ((0, max(lh - level.shape[0], 0)),
                                               (0, max(lw - level.shape[1], 0))), mode="edge")
                        planes.append(level[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw])
                    order = [(y, [(c, y) for c in range(len(chans))])
                             for y in range(planes[0].shape[0])]
                    body = _compress(comp, planes, order, chans, dwa)
                    key = (ly, lx, ty, tx) if line_order != 1 else (ly, lx, -ty, tx)
                    chunks.append((key, struct.pack("<iiiii", tx, ty, lx, ly, len(body)) + body))
    header += list(attrs)
    return header, chunks, line_order


def _write(path, parts, flags, shared=True):
    multi = len(parts) > 1 or flags & 0x1000
    head = MAGIC + struct.pack("<I", 2 | flags)
    for i, (header, chunks, _) in enumerate(parts):
        if multi:
            header = header + [("name", "string", f"part{i}".encode()),
                               ("chunkCount", "int", struct.pack("<i", len(chunks)))]
            if shared:  # OpenEXR wants one display window (and aspect) in every part
                header = [a if a[0] != "displayWindow" else next(
                    b for b in parts[0][0] if b[0] == "displayWindow") for a in header]
        head += b"".join(_attr(*a) for a in header) + b"\x00"
    if multi:
        head += b"\x00"
    pos = len(head) + 8 * sum(len(c) for _, c, _ in parts)
    tables, body = [], []
    for i, (_, chunks, line_order) in enumerate(parts):
        stored = sorted(range(len(chunks)), key=lambda k: chunks[k][0],
                        reverse=line_order == 1)
        if line_order == 2:
            stored = list(np.random.RandomState(len(chunks)).permutation(len(chunks)))
        offsets = [0] * len(chunks)
        for k in stored:
            data = (struct.pack("<i", i) if multi else b"") + chunks[k][1]
            offsets[k] = pos
            pos += len(data)
            body.append(data)
        tables.append(struct.pack(f"<{len(chunks)}Q", *offsets))
    with open(path, "wb") as f:
        f.write(head + b"".join(tables) + b"".join(body))


def write_image(path, channels, **part):
    """A single-part file (scanline, or tiled with tiles=...); see _part."""
    header, chunks, line_order = _part(channels, **part)
    kind = "tiledimage" if part.get("tiles") else "scanlineimage"
    _write(path, [(header, chunks, line_order)], 0x200 if kind == "tiledimage" else 0)


def write_parts(path, parts, shared=True):
    """A multi-part file: `parts` is a list of write_image's keyword dicts;
    every part takes the first one's display window unless `shared` is
    False (a file OpenEXR refuses)."""
    built = []
    for p in parts:
        header, chunks, line_order = _part(**p)
        kind = "tiledimage" if p.get("tiles") else "scanlineimage"
        built.append((header + [("type", "string", kind.encode())], chunks, line_order))
    _write(path, built, 0x1000, shared)


def write_deep(path, array, tiled=False):
    """A minimal deep file of one FLOAT channel Y, one sample per pixel,
    uncompressed: deep scanline, or deep tiled with one tile per 8x8."""
    a = np.asarray(array, "<f4")
    h, w = a.shape
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = [("channels", "chlist", _chlist([("Y", a, 1, 1)])),
              ("compression", "compression", b"\x00"), ("dataWindow", "box2i", box),
              ("displayWindow", "box2i", box), ("lineOrder", "lineOrder", b"\x00"),
              ("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
              ("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0)),
              ("screenWindowWidth", "float", struct.pack("<f", 1.0)),
              ("type", "string", b"deeptile" if tiled else b"deepscanline"),
              ("version", "int", struct.pack("<i", 1)),
              ("maxSamplesPerPixel", "int", struct.pack("<i", 1))]
    cells = ([(0, y, y + 1, 0, w) for y in range(h)] if not tiled else
             [((tx, ty), ty * 8, min(ty * 8 + 8, h), tx * 8, min(tx * 8 + 8, w))
              for ty in range(-(-h // 8)) for tx in range(-(-w // 8))])
    if tiled:
        header.append(("tiles", "tiledesc", struct.pack("<IIB", 8, 8, 0)))
    chunks = []
    for key, ya, yb, xa, xb in cells:
        n = (yb - ya) * (xb - xa)
        table = np.arange(1, n + 1, dtype="<i4").tobytes()
        samples = a[ya:yb, xa:xb].tobytes()
        lead = struct.pack("<iiii", *key, 0, 0) if tiled else struct.pack("<i", ya)
        chunks.append((ya, lead + struct.pack("<QQQ", len(table), len(samples), len(samples))
                       + table + samples))
    header.append(("chunkCount", "int", struct.pack("<i", len(chunks))))
    _write(path, [(header, chunks, 0)], 0x800 | (0x200 if tiled else 0))


def write_exr(path, array, compression="ZIP", channel="Y", line_order=0, origin=(0, 0),
              extra_channels=()):
    """One array as a one-channel file (or the same samples under each of
    `extra_channels` too)."""
    arr = np.asarray(array)
    write_image(path, {c: arr for c in (channel,) + tuple(extra_channels)},
                compression=compression, line_order=line_order, origin=origin)


def set_plinear(path, names=None):
    """Sets the pLinear flag of the named channels (all if None) in a
    file's channel list, in place: how a file with perceptually coded B44
    or DWA channels looks, from any writer's file."""
    data = bytearray(open(path, "rb").read())
    i = data.index(b"channels\x00chlist\x00") + len(b"channels\x00chlist\x00") + 4
    while data[i] != 0:
        end = data.index(b"\x00", i)
        if names is None or data[i:end].decode() in names:
            data[end + 5] = 1
        i = end + 17
    open(path, "wb").write(bytes(data))
