"""A numpy OpenEXR writer for the tests of gd3d_torch/data/exr.py (the port
writes no EXR, and cv2 here has no EXR codec): one-channel scanline files
of float32, float16 or uint32 samples in the NONE, RLE, ZIPS, ZIP and PIZ
compressions, following OpenEXR's compressors (the byte predictor and
half-split reorder of RLE and ZIP, OpenEXR's run-length code; PIZ's
bitmap range table, 14- or 16-bit Haar wavelet and run-length Huffman
code with its packed table). A block that does not shrink is stored raw,
as OpenEXR does.

    write_exr(path, array, compression="ZIP", channel="Y", line_order=0,
              origin=(0, 0))
"""
import heapq
import struct
import zlib

import numpy as np

from gd3d_torch.data.exr import LINES, MAGIC, canonical_codes

CODES = {"NONE": 0, "RLE": 1, "ZIPS": 2, "ZIP": 3, "PIZ": 4, "PXR24": 5, "B44": 6, "DWAA": 8}
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


class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, n, v):
        self.bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    def bytes(self):
        b = self.bits + [0] * (-len(self.bits) % 8)
        return np.packbits(np.asarray(b, np.uint8)).tobytes() if b else b""


def huf_compress(raw: np.ndarray) -> bytes:
    vals = raw.tolist()
    runs = []  # (symbol, extra repeats up to 255)
    i = 0
    while i < len(vals):
        j = i + 1
        while j < len(vals) and vals[j] == vals[i] and j - i - 1 < 255:
            j += 1
        runs.append((vals[i], j - i - 1))
        i = j
    freq = {}
    for s, r in runs:
        freq[s] = freq.get(s, 0) + 1 + r
    im, iM = min(freq), max(freq) + 1  # the pseudo-symbol iM marks a run
    freq[iM] = 1
    depth = _lengths(freq)
    lengths = np.zeros(iM + 1, np.int64)
    for s, d in depth.items():
        lengths[s] = max(d, 1)
    assert lengths.max() <= 58
    codes = canonical_codes(lengths)
    table = _BitWriter()
    s = im
    while s <= iM:
        if lengths[s] == 0:
            run = 1
            while s + run <= iM and lengths[s + run] == 0 and run < 255 + 6:
                run += 1
            if run >= 2:
                if run >= 6:
                    table.put(6, 63)
                    table.put(8, run - 6)
                else:
                    table.put(6, 59 + run - 2)
                s += run
                continue
        table.put(6, int(lengths[s]))
        s += 1
    data = _BitWriter()
    for sym, r in runs:
        ls, lr = int(lengths[sym]), int(lengths[iM])
        if r and ls + lr + 8 < ls * (r + 1):
            data.put(ls, int(codes[sym]))
            data.put(lr, int(codes[iM]))
            data.put(8, r)
        else:
            for _ in range(r + 1):
                data.put(ls, int(codes[sym]))
    tb = table.bytes()
    return struct.pack("<iiiii", im, iM, len(tb), len(data.bits), 0) + tb + data.bytes()


def piz_block(raw: bytes, nx: int, ny: int, words: int) -> bytes:
    v = np.frombuffer(raw, "<u2").copy()
    bitmap = np.zeros(8192, np.uint8)
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
    planes = lut[v].reshape(ny, nx, words)
    for j in range(words):
        plane = np.ascontiguousarray(planes[..., j])
        wav2_encode(plane, max_value)
        planes[..., j] = plane
    huf = huf_compress(planes.reshape(-1))
    head = struct.pack("<HH", lo, hi) + (bitmap[lo:hi + 1].tobytes() if lo <= hi else b"")
    return head + struct.pack("<i", len(huf)) + huf


def write_exr(path, array, compression="ZIP", channel="Y", line_order=0, origin=(0, 0),
              extra_channels=()):
    arr = np.asarray(array)
    dt = np.dtype(arr.dtype).newbyteorder("<")
    arr = arr.astype(dt)
    h, w = arr.shape
    comp = CODES[compression]
    x0, y0 = origin
    chans = b"".join(c.encode() + b"\x00" + struct.pack("<iB3xii", PTYPES[dt], 0, 1, 1)
                     for c in sorted((channel,) + tuple(extra_channels))) + b"\x00"
    box = struct.pack("<iiii", x0, y0, x0 + w - 1, y0 + h - 1)
    header = (_attr("channels", "chlist", chans) + _attr("compression", "compression",
                                                           bytes([comp]))
              + _attr("dataWindow", "box2i", box) + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder", bytes([line_order]))
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)) + b"\x00")
    lines = LINES.get(comp, 16)
    nchan = 1 + len(extra_channels)
    blocks = []
    for r in range(0, h, lines):
        n = min(lines, h - r)
        rows = arr[r:r + n]
        raw = b"".join(rows[i].tobytes() * nchan for i in range(n))
        if comp == 1:
            body = _rle(_predict(raw))
        elif comp in (2, 3):
            body = zlib.compress(_predict(raw))
        elif comp == 4:
            body = piz_block(raw, w, n, dt.itemsize // 2)
        else:
            body = raw
        if len(body) >= len(raw):
            body = raw
        blocks.append(struct.pack("<ii", y0 + r, len(body)) + body)
    order = list(range(len(blocks)))
    if line_order == 1:
        order = order[::-1]
    start = 8 + len(header) + 8 * len(blocks)
    offsets = [0] * len(blocks)
    pos = start
    for i in order:
        offsets[i] = pos
        pos += len(blocks[i])
    with open(path, "wb") as f:
        f.write(MAGIC + struct.pack("<I", 2) + header + struct.pack(f"<{len(blocks)}Q", *offsets))
        for i in order:
            f.write(blocks[i])
