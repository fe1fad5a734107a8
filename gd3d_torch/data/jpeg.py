"""Baseline JPEG decoding without PIL, to PIL's bytes.

gd3d's eval decodes with `Image.open(f).convert("RGB")` and reads sizes with
`Image.open(f).size`; the card's machine has no PIL. `decode_jpeg` gives the
same RGB array as Pillow on libjpeg-turbo with its default decode path, which
is integer arithmetic throughout:

  * the ISLOW inverse DCT (libjpeg-turbo jidctint.c: 13-bit constants, two
    passes, descaled by 11 and 18 bits, the output range-limited);
  * fancy chroma upsampling (jdsample.c: h2v1 and h2v2 triangle filters
    with the alternating +8/+7 and +1/+2 biases, h1v2 likewise; replication
    where libjpeg-turbo takes it, for h2 components 2 samples wide or less);
  * the fixed-point YCbCr -> RGB tables (jdcolor.c, 16 fractional bits).

Scope: baseline and extended sequential Huffman JPEG, 8-bit samples, 1 or 3
components, sampling factors 1-2, restart markers, any Huffman tables.
Grayscale becomes RGB by replication, as PIL's convert("RGB"). Progressive,
arithmetic-coded, lossless, 12-bit and CMYK files raise ValueError.

The entropy code is decoded in Python (a 16-bit lookup per Huffman symbol
over a precomputed window of the bit stream); the IDCT, upsampling and
colour conversion run over all blocks at once in numpy.
"""
from __future__ import annotations

import functools
import os
import re
from typing import Dict, List, Tuple, Union

import numpy as np

Source = Union[str, os.PathLike, bytes]

# zigzag index k -> natural (row-major) index within the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# past 63, as libjpeg's jpeg_natural_order: a corrupt run lands on the last
# coefficient instead of outside the block
_ZZ = ZIGZAG.tolist() + [63] * 16

_REFUSED = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)", 0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)", 0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic-coded sequential (SOF9)", 0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)", 0xCD: "arithmetic-coded differential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}
_SOF = (0xC0, 0xC1, *_REFUSED)
_RST = re.compile(rb"\xff[\xd0-\xd7]")
_NEXT_MARKER = re.compile(rb"\xff+([^\x00\xff])")  # fill bytes, then the code
_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")  # not stuffing, RSTn or fill


def _read(src: Source) -> Tuple[bytes, str]:
    if isinstance(src, (bytes, bytearray)):
        return bytes(src), "<bytes>"
    with open(src, "rb") as f:
        return f.read(), os.fspath(src)


def _segments(data: bytes, name: str):
    """(marker, payload, scan data) of each marker segment after SOI, up to
    EOI; scan data (the entropy-coded bytes, restart markers in them) for
    SOS, else b"". Bytes between segments are skipped, as libjpeg skips
    them."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    pos = 2
    while True:
        m = _NEXT_MARKER.search(data, pos)
        if m is None:
            raise ValueError(f"{name}: truncated JPEG (no EOI)")
        marker = m.group(1)[0]
        if marker == 0xD9:
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # stray RSTn, TEM: no payload
            pos = m.end()
            continue
        if m.end() + 2 > len(data):
            raise ValueError(f"{name}: truncated JPEG (a marker without its length)")
        off = m.end() + 2
        pos = off + ((data[m.end()] << 8) | data[m.end() + 1]) - 2
        scan = b""
        if marker == 0xDA:
            end = _SCAN_END.search(data, pos)
            scan = data[pos: end.start() if end else len(data)]
            pos += len(scan)
        yield marker, data[off: pos - len(scan)], scan


def _frame(marker: int, p: bytes, name: str):
    if marker in _REFUSED:
        raise ValueError(f"{name}: {_REFUSED[marker]} JPEG is not supported "
                         f"(baseline and extended sequential Huffman only)")
    precision, h, w, nc = p[0], (p[1] << 8) | p[2], (p[3] << 8) | p[4], p[5]
    if precision != 8:
        raise ValueError(f"{name}: {precision}-bit JPEG is not supported (8-bit only)")
    if nc not in (1, 3):
        raise ValueError(f"{name}: {nc}-component JPEG (CMYK or YCCK when 4) is not "
                         f"supported (1 or 3 components only)")
    comps = []
    for i in range(nc):
        cid, hv, tq = p[6 + 3 * i], p[7 + 3 * i], p[8 + 3 * i]
        hs, vs = hv >> 4, hv & 15
        if hs not in (1, 2) or vs not in (1, 2):
            raise ValueError(f"{name}: sampling factors {hs}x{vs} are not supported "
                             f"(1 or 2 only)")
        comps.append({"id": cid, "h": hs, "v": vs, "tq": tq})
    if h == 0 or w == 0:
        raise ValueError(f"{name}: JPEG with a zero dimension (a DNL marker) is not supported")
    return w, h, comps


def jpeg_size(src: Source) -> Tuple[int, int]:
    """(width, height) from the frame header, as PIL's Image.open(f).size."""
    data, name = _read(src)
    for marker, p, _ in _segments(data, name):
        if marker in _SOF:
            w, h, _ = _frame(marker, p, name)
            return w, h
        if marker == 0xDA:
            break
    raise ValueError(f"{name}: no frame header before the first scan")


@functools.lru_cache(maxsize=16)
def _huffman_lut(counts: bytes, symbols: bytes) -> Tuple[tuple, ...]:
    """65536-entry lookahead table: the next 16 bits of the stream ->
    (bits consumed, run, value, kind). kind 0: a coefficient whose code and
    extra bits both fit in the 16 bits, with its run of zeros before it and
    its value (sign-extended); 1: a code whose extra bits run past them (the
    value field holds their count, read by the caller); 2: ZRL, 16 zeros; 3:
    end of block; 4: no code starts here (corrupt data). A DC table's
    symbols are the bit counts of their difference, so its run is 0."""
    adv = np.zeros(1 << 16, np.int64)
    run = np.zeros(1 << 16, np.int64)
    val = np.zeros(1 << 16, np.int64)
    kind = np.full(1 << 16, 4, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            sym = symbols[k]
            lo, hi = code << (16 - length), (code + 1) << (16 - length)
            r, s = sym >> 4, sym & 15
            run[lo:hi] = r
            if s == 0:
                adv[lo:hi] = length
                kind[lo:hi] = 2 if r == 15 else 3
            elif length + s <= 16:
                bits = (np.arange(lo, hi) >> (16 - length - s)) & ((1 << s) - 1)
                val[lo:hi] = np.where(bits < (1 << (s - 1)), bits - (1 << s) + 1, bits)
                adv[lo:hi] = length + s
                kind[lo:hi] = 0
            else:
                adv[lo:hi] = length
                val[lo:hi] = s
                kind[lo:hi] = 1
            code += 1
            k += 1
        code <<= 1
    return tuple(zip(adv.tolist(), run.tolist(), val.tolist(), kind.tolist()))


@functools.lru_cache(maxsize=16)
def _dc_lut(counts: bytes, symbols: bytes) -> Tuple[tuple, ...]:
    """A DC table's symbols are bit counts (0-11) with no run: read as AC
    symbols with run 0, a count of 0 is a zero difference, not an EOB."""
    lut = _huffman_lut(counts, bytes(min(sym, 15) for sym in symbols))
    return tuple((a, 0, 0, 0) if kd == 3 else (a, 0, v, kd) for a, r, v, kd in lut)


def _windows(seg: bytes) -> List[int]:
    """For every bit position of the (unstuffed) segment, the 16 bits that
    start there; zeros past its end."""
    b = np.concatenate([np.frombuffer(seg, np.uint8), np.zeros(4, np.uint8)]).astype(np.int64)
    n = len(seg) + 2
    v24 = (b[:n] << 16) | (b[1:n + 1] << 8) | b[2:n + 2]
    return ((v24[:, None] >> np.arange(8, 0, -1)) & 0xFFFF).ravel().tolist()


def _decode_scan(scan_data: bytes, scomps, comps, mcu_layout, restart: int,
                 name: str) -> None:
    """Entropy-decode one scan into the components' coefficient lists.
    mcu_layout: (number of MCUs, mcus a row); for each scan component its
    blocks in an MCU as (component, dc lut, ac lut, [(dy, dx), ...])."""
    n_mcus, mcus_per_row = mcu_layout
    interval = restart or n_mcus
    segments = _RST.split(scan_data)
    zz = _ZZ
    preds = [0] * len(scomps)
    mcu = 0
    for seg in segments:
        if mcu >= n_mcus:
            break
        w = _windows(seg.replace(b"\xff\x00", b"\xff"))
        pos = 0
        for j in range(len(preds)):
            preds[j] = 0
        stop = min(mcu + interval, n_mcus)
        while mcu < stop:
            my, mx = divmod(mcu, mcus_per_row)
            for j, (comp, dclut, aclut, offsets) in enumerate(scomps):
                nbx, coef = comp["nbx"], comp["coef"]
                bh, bw = comp["mcu_blocks"]
                for dy, dx in offsets:
                    base = ((my * bh + dy) * nbx + mx * bw + dx) * 64
                    adv, _, v, kind = dclut[w[pos]]
                    pos += adv
                    if kind == 1:
                        s = v
                        v = w[pos] >> (16 - s)
                        pos += s
                        if v < (1 << (s - 1)):
                            v -= (1 << s) - 1
                    elif kind == 4:
                        raise ValueError(f"{name}: corrupt JPEG data (bad Huffman code)")
                    preds[j] += v
                    coef[base] = preds[j]
                    k = 1
                    while k < 64:
                        adv, r, v, kind = aclut[w[pos]]
                        pos += adv
                        if kind == 0:
                            k += r
                            coef[base + zz[k]] = v
                            k += 1
                        elif kind == 3:
                            break
                        elif kind == 2:
                            k += 16
                        elif kind == 1:
                            k += r
                            s = v
                            v = w[pos] >> (16 - s)
                            pos += s
                            if v < (1 << (s - 1)):
                                v -= (1 << s) - 1
                            coef[base + zz[k]] = v
                            k += 1
                        else:
                            raise ValueError(f"{name}: corrupt JPEG data (bad Huffman code)")
            mcu += 1
        if pos > len(w) - 16:
            raise ValueError(f"{name}: corrupt JPEG data (a scan segment ran out)")


# jidctint.c constants (CONST_BITS 13)
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(x, shift: int):
    """One pass of jpeg_idct_islow over the 8 inputs x[0..7] (arrays),
    descaled by `shift` bits with rounding."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0 = t0 * _F0298
    t1 = t1 * _F2053
    t2 = t2 * _F3072
    t3 = t3 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    r = 1 << (shift - 1)
    return [(tmp10 + t3 + r) >> shift, (tmp11 + t2 + r) >> shift,
            (tmp12 + t1 + r) >> shift, (tmp13 + t0 + r) >> shift,
            (tmp13 - t0 + r) >> shift, (tmp12 - t1 + r) >> shift,
            (tmp11 - t2 + r) >> shift, (tmp10 - t3 + r) >> shift]


def idct_islow(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(n, 64) natural-order coefficients, (64,) natural-order quantizer ->
    (n, 8, 8) uint8 samples. Pass 1 runs down the columns (11-bit descale,
    2 fraction bits kept), pass 2 along the rows (18 bits); the result is
    centred at 128 and saturated, which is libjpeg-turbo's range limit for
    every value within +-512 of the centre."""
    x = (coefs.astype(np.int64) * qtable.astype(np.int64)).reshape(-1, 8, 8)
    ws = np.stack(_idct_1d([x[:, r, :] for r in range(8)], 11), axis=1)
    out = np.stack(_idct_1d([ws[:, :, c] for c in range(8)], 18), axis=2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _edge(p: np.ndarray, axis: int):
    """The plane's neighbours before and after along `axis`, with the edge
    sample replicated."""
    n = p.shape[axis]
    prev = np.take(p, np.r_[0, 0:n - 1], axis=axis)
    nxt = np.take(p, np.r_[1:n, n - 1], axis=axis)
    return prev, nxt


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(plane: np.ndarray, ry: int, rx: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of a (downsampled-size) component plane by
    (ry, rx) in {1, 2}: the fancy triangle filters (h2v2, h2v1, h1v2), and
    replication for h2 components 2 samples wide or less, where
    libjpeg-turbo takes the plain upsampler."""
    p = plane.astype(np.int32)
    if (ry, rx) == (1, 1):
        return plane
    if rx == 2 and p.shape[1] <= 2:
        return np.repeat(np.repeat(plane, ry, axis=0), rx, axis=1)
    if ry == 2 and rx == 2:
        up, down = _edge(p, 0)
        rows = _interleave(3 * p + up, 3 * p + down, 0)  # column sums
        left, right = _edge(rows, 1)
        out = _interleave((3 * rows + left + 8) >> 4, (3 * rows + right + 7) >> 4, 1)
    elif rx == 2:
        left, right = _edge(p, 1)
        out = _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2, 1)
    else:
        up, down = _edge(p, 0)
        out = _interleave((3 * p + up + 1) >> 2, (3 * p + down + 2) >> 2, 0)
    return out.astype(np.uint8)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert on uint8 planes -> (H, W, 3) uint8."""
    yi = y.astype(np.int64)
    r = yi + _CR_R[cr]
    g = yi + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = yi + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(src: Source) -> np.ndarray:
    """The file's pixels as (H, W, 3) uint8 RGB: PIL's
    np.asarray(Image.open(src).convert("RGB"))."""
    data, name = _read(src)
    qtables: Dict[int, np.ndarray] = {}
    dc_luts: Dict[int, list] = {}
    ac_luts: Dict[int, list] = {}
    restart = 0
    adobe_transform = None
    frame = None
    for marker, p, scan in _segments(data, name):
        if marker in _SOF:
            if frame is not None:
                raise ValueError(f"{name}: more than one frame header")
            frame = _frame(marker, p, name)
            w, h, comps = frame
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                c["nbx"], c["nby"] = mcux * c["h"], mcuy * c["v"]
                c["cw"] = -(-w * c["h"] // hmax)
                c["ch"] = -(-h * c["v"] // vmax)
                c["coef"] = [0] * (c["nbx"] * c["nby"] * 64)
        elif marker == 0xDB:
            i = 0
            while i < len(p):
                pq, tq = p[i] >> 4, p[i] & 15
                if pq:
                    q = np.frombuffer(p[i + 1: i + 129], ">u2").astype(np.int64)
                    i += 129
                else:
                    q = np.frombuffer(p[i + 1: i + 65], np.uint8).astype(np.int64)
                    i += 65
                nat = np.zeros(64, np.int64)
                nat[ZIGZAG] = q
                qtables[tq] = nat
        elif marker == 0xC4:
            i = 0
            while i < len(p):
                tc, th = p[i] >> 4, p[i] & 15
                counts = p[i + 1: i + 17]
                total = sum(counts)
                symbols = p[i + 17: i + 17 + total]
                (ac_luts if tc else dc_luts)[th] = (_huffman_lut if tc else _dc_lut)(
                    bytes(counts), bytes(symbols))
                i += 17 + total
        elif marker == 0xDD:
            restart = (p[0] << 8) | p[1]
        elif marker == 0xEE and p[:5] == b"Adobe" and len(p) >= 12:
            adobe_transform = p[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: scan before the frame header")
            w, h, comps = frame
            by_id = {c["id"]: c for c in comps}
            ns = p[0]
            scomps = []
            for i in range(ns):
                c = by_id[p[1 + 2 * i]]
                td, ta = p[2 + 2 * i] >> 4, p[2 + 2 * i] & 15
                if ns == 1:  # non-interleaved: one block an MCU, raster order
                    c["mcu_blocks"] = (1, 1)
                    offsets = [(0, 0)]
                else:
                    c["mcu_blocks"] = (c["v"], c["h"])
                    offsets = [(dy, dx) for dy in range(c["v"]) for dx in range(c["h"])]
                scomps.append((c, dc_luts[td], ac_luts[ta], offsets))
            if ns == 1:
                c = scomps[0][0]
                layout = (-(-c["ch"] // 8) * -(-c["cw"] // 8), -(-c["cw"] // 8))
            else:
                hmax = max(c["h"] for c in comps)
                vmax = max(c["v"] for c in comps)
                mcux = -(-w // (8 * hmax))
                layout = (mcux * -(-h // (8 * vmax)), mcux)
            try:
                _decode_scan(scan, scomps, comps, layout, restart, name)
            except IndexError:  # read past the padded end of a segment
                raise ValueError(f"{name}: corrupt JPEG data (a scan ran out)") from None
    if frame is None:
        raise ValueError(f"{name}: no frame header")
    return _reconstruct(frame, qtables, adobe_transform)


def _reconstruct(frame, qtables, adobe_transform) -> np.ndarray:
    w, h, comps = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    planes = []
    for c in comps:
        nblocks = c["nbx"] * c["nby"]
        coefs = np.array(c["coef"], np.int64)
        px = idct_islow(coefs.reshape(nblocks, 64), qtables[c["tq"]])
        px = px.reshape(c["nby"], c["nbx"], 8, 8).transpose(0, 2, 1, 3)
        plane = px.reshape(c["nby"] * 8, c["nbx"] * 8)[: c["ch"], : c["cw"]]
        planes.append(upsample(plane, vmax // c["v"], hmax // c["h"])[:h, :w])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=-1)
    ids = bytes(c["id"] for c in comps)
    if adobe_transform == 0 or (adobe_transform is None and ids == b"RGB"):
        return np.ascontiguousarray(np.stack(planes, axis=-1))
    return ycc_to_rgb(*planes)
