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

  * int_upsample's replication for every other integral ratio (4:1:1,
    4:1:0 and the like), as libjpeg-turbo chooses;
  * four components: CMYK, or YCCK where an Adobe APP14 marker says
    transform 2 (jdcolor.c's ycck_cmyk_convert), inverted as PIL's
    "CMYK;I" raw mode takes them, then Pillow's cmyk2rgb.

Scope: baseline, extended sequential and progressive JPEG, Huffman or
arithmetic-coded (DC first and refinement scans, AC first scans with EOB
runs and AC refinement scans with correction bits, interleaved or not,
restart intervals in any scan), and lossless JPEG (SOF3); 8-bit samples, 1,
3 or 4 components, sampling factors 1-4 whose ratios are integral, any
Huffman tables and arithmetic conditioning (DAC). Grayscale becomes RGB by
replication, as PIL's convert("RGB").

  * arithmetic decoding (jdarith.c): the QM decoder of T.81 Annex D with
    the Qe table D.2, zeros fed in once a marker is reached, statistics,
    predictions and contexts reset at each restart;
  * the lossless process (jdlhuff.c, jdlossls.c): Huffman-coded
    differences (SSSS 16 is 32768), undone by predictors 1-7 row by row
    (the first row by predictor 1 from 2^(7 - Pt), the first column by
    predictor 2, again after each restart: from the first row of the iMCU
    row that holds it, as jddiffct.c undoes whole iMCU rows), shifted left
    by Pt; the planes upsampled by replication (libjpeg-turbo's fancy
    upsampling needs DCT blocks) and taken as RGB unless a JFIF or an
    Adobe marker asks for YCbCr, which libjpeg-turbo refuses to convert
    losslessly;
  * block smoothing (jdcoefct.c, decompress_smooth_data of libjpeg-turbo
    3.1): a progressive file that leaves a coefficient among the first ten
    of a block unrefined has its first nine AC coefficients estimated from
    the 5x5 neighbourhood of DC values, and, where no AC coefficient was
    coded at all, its DC interpolated too.

What libjpeg-turbo refuses raises ValueError naming the file: hierarchical
files (DHP, SOF5-SOF7, SOF13-SOF15), arithmetic-coded lossless (SOF11),
12-bit files and fractional sampling ratios.

The entropy code is decoded in Python (a 16-bit lookup per Huffman symbol
over a precomputed window of the bit stream); the IDCT, upsampling and
colour conversion run over all blocks at once in numpy.
"""
from __future__ import annotations

import functools
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from gd3d_torch.data.source import Source, read_source


# zigzag index k -> natural (row-major) index within the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# past 63, as libjpeg's jpeg_natural_order: a corrupt run lands on the last
# coefficient instead of outside the block
_ZZ = ZIGZAG.tolist() + [63] * 16

# what libjpeg-turbo 3.1 refuses (jdmarker.c: SOF5-7, SOF13-15 and DHP are
# unsupported markers; jdmaster.c: no arithmetic-coded lossless)
_REFUSED = {
    0xC5: "hierarchical (differential sequential, SOF5)",
    0xC6: "hierarchical (differential progressive, SOF6)",
    0xC7: "hierarchical (differential lossless, SOF7)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "hierarchical (arithmetic-coded differential sequential, SOF13)",
    0xCE: "hierarchical (arithmetic-coded differential progressive, SOF14)",
    0xCF: "hierarchical (arithmetic-coded differential lossless, SOF15)",
    0xDE: "hierarchical (DHP)",
}
_SOF = (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA, *_REFUSED)
_PROGRESSIVE, _ARITHMETIC, _LOSSLESS = (0xC2, 0xCA), (0xC9, 0xCA), (0xC3,)
_RST = re.compile(rb"\xff[\xd0-\xd7]")
_STUFFED = re.compile(rb"\xff+\x00")  # 0xFF, fill bytes, the stuffed zero
_NEXT_MARKER = re.compile(rb"\xff+([^\x00\xff])")  # fill bytes, then the code
_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")  # not stuffing, RSTn or fill


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
        raise ValueError(f"{name}: {_REFUSED[marker]} JPEG is not supported (libjpeg-turbo, "
                         f"which PIL decodes with, refuses it too)")
    precision, h, w, nc = p[0], (p[1] << 8) | p[2], (p[3] << 8) | p[4], p[5]
    if precision != 8:
        raise ValueError(f"{name}: {precision}-bit JPEG is not supported (8-bit only)")
    if nc not in (1, 3, 4):
        raise ValueError(f"{name}: {nc}-component JPEG is not supported (1, 3 or 4 "
                         f"components only)")
    comps = []
    for i in range(nc):
        cid, hv, tq = p[6 + 3 * i], p[7 + 3 * i], p[8 + 3 * i]
        hs, vs = hv >> 4, hv & 15
        if not (1 <= hs <= 4 and 1 <= vs <= 4):
            raise ValueError(f"{name}: sampling factors {hs}x{vs} are not valid (1-4)")
        comps.append({"id": cid, "h": hs, "v": vs, "tq": tq})
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    for c in comps:
        if hmax % c["h"] or vmax % c["v"]:
            raise ValueError(f"{name}: fractional sampling ratios ({c['h']}x{c['v']} "
                             f"against {hmax}x{vmax}) are not supported")
    if h == 0 or w == 0:
        raise ValueError(f"{name}: JPEG with a zero dimension (a DNL marker) is not supported")
    return w, h, comps


def jpeg_size(src: Source, name: Optional[str] = None) -> Tuple[int, int]:
    """(width, height) from the frame header, as PIL's Image.open(f).size."""
    data, name = read_source(src, name)
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


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _decode_progressive_scan(scan_data: bytes, scomps, mcu_layout, restart: int,
                             spectral, name: str) -> None:
    """Entropy-decode one progressive scan (jdphuff.c) into the components'
    coefficient lists. spectral: (Ss, Se, Ah, Al). DC scans may interleave
    components; AC scans hold one. Coefficients are stored scaled by 2^Al,
    as libjpeg stores them."""
    ss, se, ah, al = spectral
    n_mcus, mcus_per_row = mcu_layout
    interval = restart or n_mcus
    zz = _ZZ
    p1, m1 = 1 << al, -1 << al
    mcu = 0
    for seg in _RST.split(scan_data):
        if mcu >= n_mcus:
            break
        w = _windows(seg.replace(b"\xff\x00", b"\xff"))
        pos = 0
        preds = [0] * len(scomps)
        eobrun = 0
        stop = min(mcu + interval, n_mcus)
        if ss == 0:  # DC: first or refinement, interleaved or not
            while mcu < stop:
                my, mx = divmod(mcu, mcus_per_row)
                for j, (comp, dclut, _, offsets) in enumerate(scomps):
                    nbx, coef = comp["nbx"], comp["coef"]
                    bh, bw = comp["mcu_blocks"]
                    for dy, dx in offsets:
                        base = ((my * bh + dy) * nbx + mx * bw + dx) * 64
                        if ah:
                            if w[pos] >> 15:
                                coef[base] |= p1
                            pos += 1
                            continue
                        adv, _, v, kind = dclut[w[pos]]
                        pos += adv
                        if kind == 1:
                            nbits = v
                            v = _extend(w[pos] >> (16 - nbits), nbits)
                            pos += nbits
                        elif kind == 4:
                            raise ValueError(f"{name}: corrupt JPEG data (bad Huffman code)")
                        preds[j] += v
                        coef[base] = preds[j] << al
                mcu += 1
        else:
            comp, _, aclut, _ = scomps[0]
            nbx, coef = comp["nbx"], comp["coef"]
            while mcu < stop:
                my, mx = divmod(mcu, mcus_per_row)
                base = (my * nbx + mx) * 64
                mcu += 1
                k = ss
                if not ah:  # AC first
                    if eobrun:
                        eobrun -= 1
                        continue
                    while k <= se:
                        adv, r, v, kind = aclut[w[pos]]
                        pos += adv
                        if kind == 0:
                            k += r
                            coef[base + zz[k]] = v << al
                            k += 1
                        elif kind == 2:
                            k += 16
                        elif kind == 3:
                            eobrun = 1 << r
                            if r:
                                eobrun += w[pos] >> (16 - r)
                                pos += r
                            eobrun -= 1
                            break
                        elif kind == 1:
                            k += r
                            coef[base + zz[k]] = _extend(w[pos] >> (16 - v), v) << al
                            pos += v
                            k += 1
                        else:
                            raise ValueError(f"{name}: corrupt JPEG data (bad Huffman code)")
                    continue
                if not eobrun:  # AC refinement
                    while k <= se:
                        adv, r, v, kind = aclut[w[pos]]
                        pos += adv
                        if kind == 0:
                            s = p1 if v > 0 else m1
                        elif kind == 2:
                            s = 0
                        elif kind == 3:
                            eobrun = 1 << r
                            if r:
                                eobrun += w[pos] >> (16 - r)
                                pos += r
                            break
                        elif kind == 1:
                            s = p1 if _extend(w[pos] >> (16 - v), v) > 0 else m1
                            pos += v
                        else:
                            raise ValueError(f"{name}: corrupt JPEG data (bad Huffman code)")
                        while k <= se:  # correction bits of the nonzeros, r zeros skipped
                            i = base + zz[k]
                            c = coef[i]
                            if c:
                                if w[pos] >> 15 and not c & p1:
                                    coef[i] = c + (p1 if c >= 0 else m1)
                                pos += 1
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if s:
                            coef[base + zz[k]] = s
                        k += 1
                if eobrun:
                    while k <= se:
                        i = base + zz[k]
                        c = coef[i]
                        if c:
                            if w[pos] >> 15 and not c & p1:
                                coef[i] = c + (p1 if c >= 0 else m1)
                            pos += 1
                        k += 1
                    eobrun -= 1
        if pos > len(w) - 16:
            raise ValueError(f"{name}: corrupt JPEG data (a scan segment ran out)")


# T.81 Table D.2 as jaricom.c packs it: (Qe, next index after an LPS, next
# index after an MPS, switch the MPS on an LPS); entry 113 is the fixed
# probability 0.5 of sign and refinement decisions
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
_QE = [q for q, _, _, _ in _D2]
_NEXT_LPS = [nl | (sw << 7) for _, nl, _, sw in _D2]
_NEXT_MPS = [nm for _, _, nm, _ in _D2]
# one statistics list a scan: 16 DC areas of 64 bins, 16 AC areas of 256, the fixed bin
_AC0 = 16 * 64
_FIXED = _AC0 + 16 * 256


def _decode_arith_scan(scan_data: bytes, scomps, mcu_layout, restart: int, spectral,
                       progressive: bool, cond, name: str) -> None:
    """Entropy-decode one arithmetic-coded scan (jdarith.c) into the
    components' coefficient lists: sequential, or one of the four
    progressive procedures by spectral (Ss, Se, Ah, Al). scomps: (component,
    DC table, AC table, block offsets in an MCU) each. cond: the DAC
    conditioning, {"dc": {table: (L, U)}, "ac": {table: Kx}}."""
    ss, se, ah, al = spectral
    n_mcus, mcus_per_row = mcu_layout
    interval = restart or n_mcus
    zz, qes, nls, nms = _ZZ, _QE, _NEXT_LPS, _NEXT_MPS
    p1, m1 = 1 << al, -1 << al
    dc_first = not progressive or (ss == 0 and ah == 0)
    lims = []
    for _, td, ta, _ in scomps:
        lo, hi = cond["dc"].get(td, (0, 1))
        lims.append(((1 << lo) >> 1, (1 << hi) >> 1, cond["ac"].get(ta, 5)))
    buf, n, st = b"", 0, []
    c = a = pos = ct = 0

    def dec(s: int) -> int:
        """arith_decode: one binary decision from statistics bin s."""
        nonlocal c, a, ct, pos
        while a < 0x8000:
            ct -= 1
            if ct < 0:  # the next byte; zeros once the segment's marker is reached
                if pos < n:
                    c = (c << 8) | buf[pos]
                    pos += 1
                else:
                    c <<= 8
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:  # the two initial bytes are in
                        a = 0x8000
            a <<= 1
        sv = st[s]
        i = sv & 0x7F
        qe = qes[i]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:  # conditional exchange: the MPS after all
                a = qe
                st[s] = (sv & 0x80) ^ nms[i]
                return sv >> 7
            a = qe
            st[s] = (sv & 0x80) ^ nls[i]
            return (sv >> 7) ^ 1
        if a < 0x8000:
            if a < qe:
                st[s] = (sv & 0x80) ^ nls[i]
                return (sv >> 7) ^ 1
            st[s] = (sv & 0x80) ^ nms[i]
        return sv >> 7

    def magnitude(m: int, s: int) -> int:
        """F.2.4.3's magnitude category from bin s on (m its value so
        far), then its bits from the bin 14 past the last: |v| - 1."""
        while dec(s):
            m <<= 1
            if m == 0x8000:
                raise ValueError(f"{name}: corrupt JPEG data (arithmetic magnitude overflow)")
            s += 1
        v = m
        s += 14
        while m > 1:
            m >>= 1
            if dec(s):
                v |= m
        return v

    def ac_value(s: int, k: int, ab: int, kx: int) -> int:
        """A nonzero AC coefficient's sign and magnitude, s its SE bin."""
        sign = dec(_FIXED)
        s += 2
        m = dec(s)
        if m:
            if dec(s):
                v = magnitude(2, ab + (189 if k <= kx else 217))
            else:
                v = 1
        else:
            v = 0
        return -(v + 1) if sign else v + 1

    mcu = 0
    for seg in _RST.split(scan_data):
        if mcu >= n_mcus:
            break
        buf = _STUFFED.sub(b"\xff", seg.rstrip(b"\xff"))
        n = len(buf)
        st = [0] * (_FIXED + 1)
        st[_FIXED] = 113
        c = a = pos = 0
        ct = -16  # forces two bytes into C first
        preds = [0] * len(scomps)
        ctxs = [0] * len(scomps)
        stop = min(mcu + interval, n_mcus)
        while mcu < stop:
            my, mx = divmod(mcu, mcus_per_row)
            mcu += 1
            for j, (comp, td, ta, offsets) in enumerate(scomps):
                nbx, coef = comp["nbx"], comp["coef"]
                bh, bw = comp["mcu_blocks"]
                lo2, hi2, kx = lims[j]
                ab = _AC0 + 256 * ta
                for dy, dx in offsets:
                    base = ((my * bh + dy) * nbx + mx * bw + dx) * 64
                    if dc_first:
                        s0 = 64 * td + ctxs[j]
                        if not dec(s0):
                            ctxs[j] = 0
                        else:
                            sign = dec(s0 + 1)
                            s = s0 + 2 + sign
                            m = dec(s)
                            v = magnitude(m, 64 * td + 20) if m else 0
                            m = 1 << (v.bit_length() - 1) if v else 0  # the category
                            if m < lo2:
                                ctxs[j] = 0
                            elif m > hi2:
                                ctxs[j] = 12 + 4 * sign
                            else:
                                ctxs[j] = 4 + 4 * sign
                            preds[j] += -(v + 1) if sign else v + 1
                        coef[base] = preds[j] << al
                    elif ss == 0:  # DC refinement: the next bit, fixed probability
                        if dec(_FIXED):
                            coef[base] |= p1
                        continue
                    if not progressive:  # the block's AC coefficients
                        k = 0
                        while k < 63:
                            s = ab + 3 * k
                            if dec(s):  # end of block
                                break
                            k += 1
                            while not dec(s + 1):
                                s += 3
                                k += 1
                                if k > 63:
                                    raise ValueError(f"{name}: corrupt JPEG data (arithmetic "
                                                     f"spectral overflow)")
                            coef[base + zz[k]] = ac_value(s, k, ab, kx)
                    elif ss and not ah:  # AC first
                        k = ss
                        while k <= se:
                            s = ab + 3 * (k - 1)
                            if dec(s):
                                break
                            while not dec(s + 1):
                                s += 3
                                k += 1
                                if k > se:
                                    raise ValueError(f"{name}: corrupt JPEG data (arithmetic "
                                                     f"spectral overflow)")
                            coef[base + zz[k]] = ac_value(s, k, ab, kx) << al
                            k += 1
                    elif ss:  # AC refinement: past the last nonzero, EOB decisions
                        kex = se
                        while kex > 0 and not coef[base + zz[kex]]:
                            kex -= 1
                        k = ss
                        while k <= se:
                            s = ab + 3 * (k - 1)
                            if k > kex and dec(s):
                                break
                            while True:
                                i = base + zz[k]
                                cv = coef[i]
                                if cv:  # a correction bit
                                    if dec(s + 2):
                                        coef[i] = cv + (m1 if cv < 0 else p1)
                                    break
                                if dec(s + 1):  # newly nonzero
                                    coef[i] = m1 if dec(_FIXED) else p1
                                    break
                                s += 3
                                k += 1
                                if k > se:
                                    raise ValueError(f"{name}: corrupt JPEG data (arithmetic "
                                                     f"spectral overflow)")
                            k += 1


@functools.lru_cache(maxsize=16)
def _lossless_lut(counts: bytes, symbols: bytes) -> Tuple[tuple, ...]:
    """A lossless table's symbols are difference sizes 0-16; 16 is the
    difference 32768 with no extra bits (T.81 H.1.2.2). Entries as
    _huffman_lut's, of kinds 0, 1 and 4."""
    if any(sym > 16 for sym in symbols):
        raise ValueError("lossless Huffman table with a difference size above 16")
    lut = _huffman_lut(counts, bytes(0xF0 if sym == 16 else sym for sym in symbols))
    return tuple((adv, 0, 0, 0) if kind == 3 else (adv, 0, 32768, 0) if kind == 2
                 else (adv, 0, v, kind) for adv, _, v, kind in lut)


def _decode_lossless_scan(scan_data: bytes, scomps, frame, restart: int, psv: int, pt: int,
                          name: str) -> None:
    """Decode one lossless scan (jdlhuff.c, jddiffct.c, jdlossls.c) into
    each scan component's "plane": its samples, uint8. The differences are
    read first, all of them, then undone plane by plane."""
    w, h, comps = frame
    if len(scomps) == 1:  # one sample an MCU, the component's own raster
        c = scomps[0][0]
        geometry = [(c, 1, 1)]
        mcux, mcuy = c["cw"], c["ch"]
    else:
        geometry = [(c, c["v"], c["h"]) for c, _, _, _ in scomps]
        mcux = -(-w // max(c["h"] for c in comps))
        mcuy = -(-h // max(c["v"] for c in comps))
    if restart % mcux:
        raise ValueError(f"{name}: lossless JPEG whose restart interval ({restart} MCUs) is "
                         f"not a whole number of MCU rows ({mcux}) is not supported "
                         f"(libjpeg-turbo refuses it too)")
    luts = [scomps[j][1] for j, (_, v, hh) in enumerate(geometry) for _ in range(v * hh)]
    n_mcus = mcux * mcuy
    interval = restart or n_mcus
    out: List[int] = []
    mcu = 0
    for seg in _RST.split(scan_data):
        if mcu >= n_mcus:
            break
        win = _windows(seg.replace(b"\xff\x00", b"\xff"))
        pos = 0
        stop = min(mcu + interval, n_mcus)
        for _ in range(stop - mcu):
            for lut in luts:
                adv, _, v, kind = lut[win[pos]]
                pos += adv
                if kind == 1:  # extra bits past the 16 looked at
                    nbits = v
                    v = _extend(win[pos] >> (16 - nbits), nbits)
                    pos += nbits
                elif kind == 4:
                    raise ValueError(f"{name}: corrupt JPEG data (bad Huffman code)")
                out.append(v)
        mcu = stop
        if pos > len(win) - 16:
            raise ValueError(f"{name}: corrupt JPEG data (a scan segment ran out)")
    if mcu < n_mcus:
        raise ValueError(f"{name}: corrupt JPEG data (a lossless scan ran out)")
    diffs = np.array(out, np.int64).reshape(mcuy, mcux, -1)
    k = 0
    for c, v, hh in geometry:
        d = diffs[:, :, k:k + v * hh].reshape(mcuy, mcux, v, hh).transpose(0, 2, 1, 3)
        k += v * hh
        rows = mcuy * v
        # the first-row rule after each restart, at the start of the iMCU row
        # that holds it: jddiffct.c undoes the prediction once an iMCU row's
        # MCU rows are read (c["v"] of them in a scan of one component)
        imcu = c["v"] if len(scomps) == 1 else v
        starts = sorted({r // imcu * imcu for r in range(0, rows, restart // mcux * v)}
                        if restart else {0})
        x = _undifference(d.reshape(rows, mcux * hh), psv, pt, starts)
        c["plane"] = ((x << pt) & 0xFF).astype(np.uint8)[: c["ch"], : c["cw"]]


def _undifference(d: np.ndarray, psv: int, pt: int, starts: List[int]) -> np.ndarray:
    """jdlossls.c's undifferencing of a plane of differences in bands of
    rows from each of `starts` on: a band's first row by predictor 1 from
    2^(7 - Pt), each later row's first sample by predictor 2 (the one
    above), the rest by predictor psv; 16-bit wrap-around throughout."""
    x = np.empty_like(d)
    for r0, r1 in zip(starts, starts[1:] + [d.shape[0]]):
        x[r0:r1] = _undifference_band(d[r0:r1], psv, 1 << (7 - pt))
    return x


def _undifference_band(d: np.ndarray, psv: int, init: int) -> np.ndarray:
    rows, cols = d.shape
    x = np.empty_like(d)
    x[0] = (init + np.cumsum(d[0])) & 0xFFFF
    x[1:, 0] = (x[0, 0] + np.cumsum(d[1:, 0])) & 0xFFFF
    if rows == 1 or cols == 1:
        return x
    if psv == 1:  # Ra: sums along each row
        x[1:, 1:] = (x[1:, :1] + np.cumsum(d[1:, 1:], axis=1)) & 0xFFFF
    elif psv == 2:  # Rb: sums down each column
        x[1:, 1:] = (x[0, 1:] + np.cumsum(d[1:, 1:], axis=0)) & 0xFFFF
    elif psv in (3, 4, 5):  # Rc, Ra + Rb - Rc, Ra + (Rb - Rc) / 2: a row from the one above
        for r in range(1, rows):
            up = x[r - 1]
            if psv == 3:
                x[r, 1:] = (d[r, 1:] + up[:-1]) & 0xFFFF
            else:
                step = up[1:] - up[:-1] if psv == 4 else (up[1:] - up[:-1]) >> 1
                x[r, 1:] = (x[r, 0] + np.cumsum(d[r, 1:] + step)) & 0xFFFF
    else:  # Rb + (Ra - Rc) / 2, (Ra + Rb) / 2: by anti-diagonals, each from the two before
        flat, df = x.reshape(-1), d.reshape(-1)
        for k in range(2, rows + cols - 1):
            r = np.arange(max(1, k - cols + 1), min(rows - 1, k - 1) + 1)
            i = r * cols + k - r
            ra, rb, rc = flat[i - 1], flat[i - cols], flat[i - cols - 1]
            pred = rb + ((ra - rc) >> 1) if psv == 6 else (ra + rb) >> 1
            flat[i] = (df[i] + pred) & 0xFFFF
    return x


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
    integral (ry, rx): the fancy triangle filters (h2v2, h2v1, h1v2),
    replication for h2 components 2 samples wide or less, where
    libjpeg-turbo takes the plain upsampler, and int_upsample's replication
    for every other ratio (4:1:1, 4:1:0, ...)."""
    p = plane.astype(np.int32)
    if (ry, rx) == (1, 1):
        return plane
    if (ry, rx) not in ((1, 2), (2, 1), (2, 2)) or (rx == 2 and p.shape[1] <= 2):
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


def decode_jpeg(src: Source, name: Optional[str] = None) -> np.ndarray:
    """The file's pixels as (H, W, 3) uint8 RGB: PIL's
    np.asarray(Image.open(src).convert("RGB"))."""
    data, name = read_source(src, name)
    qtables: Dict[int, np.ndarray] = {}
    dc_luts: Dict[int, list] = {}
    ac_luts: Dict[int, list] = {}
    cond: Dict[str, dict] = {"dc": {}, "ac": {}}  # DAC conditioning
    restart = 0
    adobe_transform = None
    jfif = False
    frame = None
    sof = 0
    for marker, p, scan in _segments(data, name):
        if marker in _SOF:
            if frame is not None:
                raise ValueError(f"{name}: more than one frame header")
            frame = _frame(marker, p, name)
            sof = marker
            w, h, comps = frame
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                c["cw"] = -(-w * c["h"] // hmax)
                c["ch"] = -(-h * c["v"] // vmax)
                if sof in _LOSSLESS:
                    c["plane"] = None
                    continue
                c["nbx"], c["nby"] = mcux * c["h"], mcuy * c["v"]
                c["coef"] = [0] * (c["nbx"] * c["nby"] * 64)
                c["bits"] = [-1] * 64  # libjpeg's coef_bits: the Al still to refine
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
                (ac_luts if tc else dc_luts)[th] = (tc, bytes(counts), bytes(symbols))
                i += 17 + total
        elif marker == 0xCC:
            for i in range(0, len(p) - 1, 2):
                t, v = p[i], p[i + 1]
                if t >= 32 or (t < 16 and (v & 15) > (v >> 4)):
                    raise ValueError(f"{name}: invalid arithmetic conditioning (DAC)")
                if t >= 16:
                    cond["ac"][t - 16] = v
                else:
                    cond["dc"][t] = (v & 15, v >> 4)
        elif marker == 0xDD:
            restart = (p[0] << 8) | p[1]
        elif marker == 0xE0 and p[:5] == b"JFIF\x00" and len(p) >= 14:
            jfif = True
        elif marker == 0xEE and p[:5] == b"Adobe" and len(p) >= 12:
            adobe_transform = p[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: scan before the frame header")
            _scan(frame, sof, p, scan, dc_luts, ac_luts, cond, restart, name)
    if frame is None:
        raise ValueError(f"{name}: no frame header")
    if sof in _LOSSLESS:
        return _reconstruct_lossless(frame, adobe_transform, jfif, name)
    if sof in _PROGRESSIVE and _block_smoothing(frame[2], qtables):
        _smooth_blocks(frame, qtables)
    return _reconstruct(frame, qtables, adobe_transform, jfif)


def _scan(frame, sof: int, p: bytes, scan: bytes, dc_luts, ac_luts, cond, restart: int,
          name: str) -> None:
    """One scan (its header p, its entropy-coded bytes) into the frame's
    coefficients, or its samples for a lossless frame."""
    w, h, comps = frame
    progressive, arithmetic, lossless = sof in _PROGRESSIVE, sof in _ARITHMETIC, sof in _LOSSLESS
    by_id = {c["id"]: c for c in comps}
    ns = p[0]
    ss, se, ahl = p[1 + 2 * ns], p[2 + 2 * ns], p[3 + 2 * ns]
    ah, al = ahl >> 4, ahl & 15
    scomps = []
    for i in range(ns):
        if p[1 + 2 * i] not in by_id:
            raise ValueError(f"{name}: a scan names a component the frame lacks")
        c = by_id[p[1 + 2 * i]]
        td, ta = p[2 + 2 * i] >> 4, p[2 + 2 * i] & 15
        if ns == 1:  # non-interleaved: one block an MCU, raster order
            c["mcu_blocks"] = (1, 1)
            offsets = [(0, 0)]
        else:
            c["mcu_blocks"] = (c["v"], c["h"])
            offsets = [(dy, dx) for dy in range(c["v"]) for dx in range(c["h"])]
        if arithmetic:
            scomps.append((c, td, ta, offsets))
            continue
        needs_dc = lossless or not progressive or (ss == 0 and ah == 0)
        needs_ac = not lossless and (not progressive or ss > 0)
        if (needs_dc and td not in dc_luts) or (needs_ac and ta not in ac_luts):
            raise ValueError(f"{name}: a scan uses a Huffman table never defined")
        dclut = aclut = None
        if needs_dc:
            dclut = (_lossless_lut if lossless else _dc_lut)(*dc_luts[td][1:])
        if needs_ac:
            aclut = _huffman_lut(*ac_luts[ta][1:])
        scomps.append((c, dclut, aclut, offsets))
    if lossless:
        if not 1 <= ss <= 7 or al > 7:
            raise ValueError(f"{name}: invalid lossless scan parameters (predictor {ss}, Pt {al})")
        try:
            _decode_lossless_scan(scan, scomps, frame, restart, ss, al, name)
        except IndexError:
            raise ValueError(f"{name}: corrupt JPEG data (a scan ran out)") from None
        return
    if ns == 1:
        c = scomps[0][0]
        layout = (-(-c["ch"] // 8) * -(-c["cw"] // 8), -(-c["cw"] // 8))
    else:
        hmax = max(c["h"] for c in comps)
        vmax = max(c["v"] for c in comps)
        mcux = -(-w // (8 * hmax))
        layout = (mcux * -(-h // (8 * vmax)), mcux)
    if progressive:
        if (ss == 0) != (se == 0) or se > 63 or ss > se or (ss and ns != 1) or (
                ah and al != ah - 1) or al > 13:
            raise ValueError(f"{name}: invalid progressive scan parameters "
                             f"Ss={ss} Se={se} Ah={ah} Al={al}")
        for c, *_ in scomps:
            c["bits"][ss:se + 1] = [al] * (se + 1 - ss)
    try:
        if arithmetic:
            _decode_arith_scan(scan, scomps, layout, restart, (ss, se, ah, al), progressive,
                               cond, name)
        elif progressive:
            _decode_progressive_scan(scan, scomps, layout, restart, (ss, se, ah, al), name)
        else:
            _decode_scan(scan, scomps, comps, layout, restart, name)
    except IndexError:  # read past the padded end of a segment
        raise ValueError(f"{name}: corrupt JPEG data (a scan ran out)") from None


def _block_smoothing(comps, qtables) -> bool:
    """libjpeg-turbo's smoothing_ok (jdcoefct.c) after the last scan: every
    component's DC seen and its first ten quantizers nonzero, and some
    component's AC coefficient 1-9 not fully refined."""
    useful = False
    for c in comps:
        q = qtables.get(c["tq"])
        if q is None or not all(q[ZIGZAG[:10]]) or c["bits"][0] < 0:
            return False
        useful = useful or any(b != 0 for b in c["bits"][1:10])
    return useful


def _kernel(terms: str) -> np.ndarray:
    """A 5x5 weight array from jdcoefct.c's sum over DC01..DC25 (DC01 the
    block two rows up and two columns left, DC13 the block itself)."""
    k = np.zeros(25, np.int64)
    for sign, mult, idx in re.findall(r"([+-]?)\s*(?:(\d+)\s*\*\s*)?DC(\d\d)", terms):
        k[int(idx) - 1] += (-1 if sign == "-" else 1) * int(mult or 1)
    return k.reshape(5, 5)


# decompress_smooth_data's estimates: (coef_bits index, natural position,
# the kernel where DC interpolation is on (no AC coefficient coded at all),
# the kernel where it is off); the last four and the DC only with it on
_SMOOTH = [(k, ZIGZAG[k], _kernel(on), _kernel(off) if off else None) for k, on, off in (
    (1, "-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 - 3 * DC11"
        " + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20"
        " - DC21 - DC22 + DC24 + DC25",
     "-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15"),
    (2, "-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08"
        " + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21"
        " + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25",
     "-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23"),
    (3, "DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 + 2 * DC17"
        " + 7 * DC18 + 2 * DC19 + DC23",
     "-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23"),
    (4, "-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25",
     "DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 - DC06"
     " + 10 * DC07 - 10 * DC09"),
    (5, "2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 + DC15"
        " + 2 * DC17 - 5 * DC18 + 2 * DC19",
     "-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15"),
    (6, "DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19", None),
    (7, "DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19", None),
    (8, "DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19", None),
    (9, "DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19", None),
    (0, "-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07"
        " + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14"
        " - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21"
        " - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25", None))]


def _smooth_rows(height: int, v: int, imcu_rows: int) -> np.ndarray:
    """For each block row of a component, the rows its 5x5 window reads
    (two up, one up, itself, one down, two down), as decompress_smooth_data
    picks them iMCU row by iMCU row. The last iMCU row counts its rows
    from height % v, so near the bottom the window may take a row of dummy
    blocks below the image, or repeat one it need not."""
    out = []
    for r in range(imcu_rows):
        block_rows = v if r < imcu_rows - 1 else height % v or v
        image_rows = block_rows * imcu_rows
        for br in range(block_rows):
            row, at = r * block_rows + br, r * v + br
            up = at - 1 if row > 0 else at
            up2 = at - 2 if row > 1 else up
            down = at + 1 if row < image_rows - 1 else at
            down2 = at + 2 if row < image_rows - 2 else down
            out.append((up2, up, at, down, down2))
    return np.array(out)


def _smooth_cols(width: int) -> np.ndarray:
    """For each block column, the columns of its window: two left to two
    right, clamped to the component's image blocks (the DC registers that
    decompress_smooth_data slides along a row never load a dummy column)."""
    return np.clip(np.arange(width)[:, None] + np.arange(-2, 3)[None], 0, width - 1)


def _smooth_blocks(frame, qtables) -> None:
    """decompress_smooth_data (jdcoefct.c, libjpeg-turbo 3.1) on every
    image block, from the coefficients of the last scan: each of AC01,
    AC10, AC20, AC11, AC02 still zero and not known exactly gets an
    estimate from the 5x5 window of DC values (clamped below 2^Al where
    Al > 0); where no AC coefficient 1-9 was ever coded, AC03, AC12, AC21,
    AC30 too, and the DC itself is interpolated."""
    w, h, comps = frame
    imcu_rows = -(-h // (8 * max(c["v"] for c in comps)))
    for c in comps:
        q, bits = qtables[c["tq"]], c["bits"]
        grid = np.array(c["coef"], np.int64).reshape(c["nby"], c["nbx"], 64)
        rows = _smooth_rows(-(-c["ch"] // 8), c["v"], imcu_rows)
        cols = _smooth_cols(-(-c["cw"] // 8))
        dc = grid[:, :, 0]
        win = dc[rows[:, :, None, None], cols[None, None, :, :]].transpose(1, 3, 0, 2)
        change_dc = all(b == -1 for b in bits[1:10])
        blocks = grid[: len(rows), : len(cols)]
        out = blocks.copy()
        for k, pos, on, off in _SMOOTH:
            kern = on if change_dc else off
            if kern is None or (k and bits[k] == 0):
                continue
            num = q[0] * np.einsum("ij,ijhw->hw", kern, win)
            pred = ((int(q[pos]) << 7) + np.abs(num)) // (int(q[pos]) << 8)
            if k and bits[k] > 0:
                pred = np.minimum(pred, (1 << bits[k]) - 1)
            pred = np.where(num >= 0, pred, -pred)
            out[..., pos] = pred if k == 0 else np.where(blocks[..., pos] == 0, pred,
                                                         blocks[..., pos])
        grid[: len(rows), : len(cols)] = out
        c["coef"] = grid.reshape(-1)


def _reconstruct_lossless(frame, adobe_transform, jfif: bool, name: str) -> np.ndarray:
    """A lossless frame's planes upsampled by replication (libjpeg-turbo
    takes its plain upsamplers there) and taken as grey, RGB or CMYK: a
    JFIF marker or an Adobe transform other than 0 asks for a colour
    conversion, which libjpeg-turbo refuses for a lossless file."""
    w, h, comps = frame
    if any(c["plane"] is None for c in comps):
        raise ValueError(f"{name}: lossless JPEG with a component that no scan codes")
    if len(comps) > 1 and (jfif or adobe_transform not in (None, 0)):
        raise ValueError(f"{name}: lossless JPEG with a colour transform (JFIF or Adobe "
                         f"YCbCr / YCCK) is not supported (libjpeg-turbo refuses it too)")
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    planes = [np.repeat(np.repeat(c["plane"], vmax // c["v"], axis=0), hmax // c["h"],
                        axis=1)[:h, :w] for c in comps]
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=-1)
    if len(planes) == 4:
        return cmyk_to_rgb(255 - np.stack(planes, axis=-1))
    return np.ascontiguousarray(np.stack(planes, axis=-1))


def _muldiv255(a, b):
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's cmyk2rgb (Convert.c) on (H, W, 4) uint8 CMYK."""
    x = cmyk.astype(np.int64)
    nk = 255 - x[..., 3:]
    return np.clip(nk - _muldiv255(x[..., :3], nk), 0, 255).astype(np.uint8)


def _reconstruct(frame, qtables, adobe_transform, jfif=False) -> np.ndarray:
    w, h, comps = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    planes = []
    for c in comps:
        if c["tq"] not in qtables:
            raise ValueError("JPEG component without its quantization table")
        nblocks = c["nbx"] * c["nby"]
        coefs = np.array(c["coef"], np.int64)
        px = idct_islow(coefs.reshape(nblocks, 64), qtables[c["tq"]])
        px = px.reshape(c["nby"], c["nbx"], 8, 8).transpose(0, 2, 1, 3)
        plane = px.reshape(c["nby"] * 8, c["nbx"] * 8)[: c["ch"], : c["cw"]]
        planes.append(upsample(plane, vmax // c["v"], hmax // c["h"])[:h, :w])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=-1)
    if len(planes) == 4:  # JCS_CMYK out; PIL's "CMYK;I" inverts all four
        if adobe_transform is not None and adobe_transform != 0:  # YCCK
            inv = np.concatenate([ycc_to_rgb(*planes[:3]), 255 - planes[3][..., None]], -1)
        else:
            inv = 255 - np.stack(planes, axis=-1)
        return cmyk_to_rgb(inv)
    ids = bytes(c["id"] for c in comps)
    if not jfif and (adobe_transform == 0 or (adobe_transform is None and ids == b"RGB")):
        return np.ascontiguousarray(np.stack(planes, axis=-1))
    return ycc_to_rgb(*planes)
