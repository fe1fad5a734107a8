"""Baseline JPEG encoding without PIL, to PIL's bytes.

gd3d writes every preprocessed colour frame with PIL's `Image.save(path,
quality=q)` (75 by default; 80, 90 and 95 where its preprocessors ask),
which on this repository's Pillow runs libjpeg-turbo's default compression
path. `encode_jpeg(rgb, quality)` follows that path step by step:

  * `jpeg_set_quality`: the standard luminance and chrominance tables of
    the JPEG spec (Annex K) scaled by 5000 / q below 50 and 200 - 2 q
    above, (t s + 50) / 100 clamped to 1..255 (force_baseline);
  * RGB -> YCbCr in jccolor.c's fixed point (16 fractional bits, the
    Cb / Cr tables carrying +0.5 - 1 ulp);
  * 4:2:0: the image padded by repeating its last column and row, chroma
    by h2v2_downsample's ((a + b + c + d + bias) >> 2) with the bias
    alternating 1, 2 along a row, each plane then padded with its last
    row to the MCU height (jcprepct.c);
  * jfdctint.c's forward DCT (islow: 13-bit constants, 2 pass-1 bits),
    then quantisation by the rounding division |x| + q / 2 over q (8 q
    for the DCT's scale of 8);
  * dummy blocks where an MCU overhangs the image: zero AC, the DC of the
    block before (jccoefct.c compress_data);
  * the standard Huffman tables (no optimisation), byte stuffing, and the
    final byte padded with ones;
  * the markers SOI, APP0 (JFIF 1.01, no density unit, 1 x 1), DQT 0,
    DQT 1, SOF0, DHT (DC 0, AC 0, DC 1, AC 1), SOS, EOI.

Scope: (H, W, 3) uint8 RGB, quality 1..100. PIL also carries a source
JPEG's comment (COM) and EXIF into `save`; an array has neither.

Everything runs over all blocks at once in numpy, the entropy coder
included: each block's symbols become (code, length) tokens, which are
expanded to bits, packed and stuffed.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from gd3d_torch.data.jpeg import ZIGZAG

# Annex K.1, natural order
STD_LUMINANCE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMINANCE = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)

# Annex K.3: (code counts by length 1..16, symbols)
DC_LUMA = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12)))
DC_CHROMA = (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12)))
AC_LUMA = (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a92"
    "939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8"
    "c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
AC_CHROMA = (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a82838485868788898a92"
    "939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))

# jfdctint.c constants (CONST_BITS 13)
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """jpeg_set_quality(cinfo, quality, TRUE): the (64,) natural-order
    luminance and chrominance tables."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q

    def table(basic):
        return np.clip((basic * scale + 50) // 100, 1, 255).astype(np.int64)

    return table(STD_LUMINANCE), table(STD_CHROMINANCE)


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def rgb_to_ycc(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """jccolor.c rgb_ycc_convert: (H, W) int64 Y, Cb, Cr."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    half, cbcr = 1 << 15, 128 << 16
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + cbcr + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + cbcr + half - 1) >> 16
    return y, cb, cr


def _pad(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """Repeat the last row and column out to (h, w)."""
    return np.pad(plane, ((0, h - plane.shape[0]), (0, w - plane.shape[1])), mode="edge")


def downsample_h2v2(plane: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """jcsample.c h2v2_downsample of a full-size plane (after
    edge-replication to 2 out_w columns and an even row count), each output
    row's bias 1, 2, 1, ... along it; rows past ceil(H / 2) repeat the last
    one (jcprepct.c's bottom pad)."""
    rows = -(-plane.shape[0] // 2)
    p = _pad(plane, 2 * rows, 2 * out_w)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.where(np.arange(out_w) % 2 == 0, 1, 2)
    return _pad((s + bias) >> 2, out_h, out_w)


def _fdct_1d(d, pass1: bool):
    """One pass of jpeg_fdct_islow over d[0..7] (arrays)."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    n = 13 - 2 if pass1 else 13 + 2

    def descale(x, bits):
        return (x + (1 << (bits - 1))) >> bits

    out = [None] * 8
    if pass1:
        out[0], out[4] = (tmp10 + tmp11) << 2, (tmp10 - tmp11) << 2
    else:
        out[0], out[4] = descale(tmp10 + tmp11, 2), descale(tmp10 - tmp11, 2)
    z1 = (tmp12 + tmp13) * _F0541
    out[2] = descale(z1 + tmp13 * _F0765, n)
    out[6] = descale(z1 - tmp12 * _F1847, n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _F0298, tmp5 * _F2053, tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out[7] = descale(tmp4 + z1 + z3, n)
    out[5] = descale(tmp5 + z2 + z4, n)
    out[3] = descale(tmp6 + z2 + z3, n)
    out[1] = descale(tmp7 + z1 + z4, n)
    return out


def fdct_quantize(blocks: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(n, 8, 8) samples -> (n, 64) quantised coefficients in zigzag order:
    the samples centred at 128, rows then columns through the islow DCT,
    each divided by 8 q with rounding away from zero at the half."""
    x = blocks.astype(np.int64) - 128
    ws = np.stack(_fdct_1d([x[:, :, c] for c in range(8)], True), axis=2)
    out = np.stack(_fdct_1d([ws[:, r, :] for r in range(8)], False), axis=1).reshape(-1, 64)
    div = (qtable.astype(np.int64) << 3)[None]
    q = (np.abs(out) + (div >> 1)) // div
    return (np.sign(out) * q)[:, ZIGZAG]


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H / 8, W / 8, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _huffman_codes(spec) -> Tuple[np.ndarray, np.ndarray]:
    """(256,) code and (256,) length of each symbol of a table."""
    counts, symbols = spec
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def _nbits(v: np.ndarray) -> np.ndarray:
    """Bit length of |v| (0 for 0)."""
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    while (a > 0).any():
        n += a > 0
        a = a >> 1
    return n


def _extra(v: np.ndarray, n: np.ndarray) -> np.ndarray:
    """The n low bits that follow a magnitude category: v, or v - 1 in
    n-bit one's complement for negatives."""
    return np.where(v < 0, v - 1, v) & ((1 << n) - 1)


def entropy_code(coefs: np.ndarray, comp: np.ndarray, tid: np.ndarray) -> bytes:
    """Huffman-code (n, 64) zigzag blocks in scan order: block i belongs to
    component comp[i], whose DC predictor runs over its own blocks, and is
    coded with table tid[i] (0 luminance, 1 chrominance). Returns the
    stuffed bytes."""
    n = len(coefs)
    dc = coefs[:, 0]
    prev = np.zeros(n, np.int64)
    for c in np.unique(comp):
        idx = np.nonzero(comp == c)[0]
        prev[idx[1:]] = dc[idx[:-1]]
    diff = dc - prev
    codes = [(_huffman_codes(DC_LUMA), _huffman_codes(AC_LUMA)),
             (_huffman_codes(DC_CHROMA), _huffman_codes(AC_CHROMA))]
    dc_code = np.stack([codes[0][0][0], codes[1][0][0]])
    dc_len = np.stack([codes[0][0][1], codes[1][0][1]])
    ac_code = np.stack([codes[0][1][0], codes[1][1][0]])
    ac_len = np.stack([codes[0][1][1], codes[1][1][1]])

    keys, vals, lens = [], [], []
    s = _nbits(diff)
    keys.append(np.arange(n) * 128)
    vals.append((dc_code[tid, s] << s) | _extra(diff, s))
    lens.append(dc_len[tid, s] + s)

    ac = coefs[:, 1:]
    b, k = np.nonzero(ac)
    k = k + 1
    v = ac[b, k - 1]
    first = np.r_[True, b[1:] != b[:-1]] if len(b) else np.zeros(0, bool)
    prevk = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - prevk - 1
    s = _nbits(v)
    t = tid[b]
    sym = ((run % 16) << 4) | s
    zrl = run // 16
    zc, zl = ac_code[t, 0xF0], ac_len[t, 0xF0]
    val = np.zeros(len(b), np.int64)
    ln = np.zeros(len(b), np.int64)
    for _ in range(3):  # at most 3 ZRLs before a coefficient
        has = zrl > 0
        val = np.where(has, (val << zl) | zc, val)
        ln = ln + np.where(has, zl, 0)
        zrl = zrl - has
    val = (((val << ac_len[t, sym]) | ac_code[t, sym]) << s) | _extra(v, s)
    keys.append(b * 128 + 2 * k)
    vals.append(val)
    lens.append(ln + ac_len[t, sym] + s)

    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 128 + 127)
    vals.append(ac_code[tid[eob], 0])
    lens.append(ac_len[tid[eob], 0])

    order = np.argsort(np.concatenate(keys), kind="stable")
    vals = np.concatenate(vals)[order].astype(np.uint64)
    lens = np.concatenate(lens)[order]
    return pack_bits(vals, lens)


def pack_bits(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate each value's `lens` low bits, most significant first;
    pad the last byte with ones and stuff a zero after every 0xFF."""
    total = int(lens.sum())
    starts = np.cumsum(lens) - lens
    tok = np.repeat(np.arange(len(lens)), lens)
    j = np.arange(total) - starts[tok]
    shift = (lens[tok] - 1 - j).astype(np.uint64)
    bits = ((vals[tok] >> shift) & np.uint64(1)).astype(np.uint8)
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def _dht(tc: int, th: int, spec) -> bytes:
    return _segment(0xC4, bytes([tc << 4 | th]) + spec[0] + spec[1])


def encode_jpeg(rgb: np.ndarray, quality: int = 75) -> bytes:
    """The bytes of PIL's Image.fromarray(rgb).save(f, "JPEG",
    quality=quality) for a (H, W, 3) uint8 array (see the module
    docstring)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes uint8 (H, W, 3), got {rgb.dtype} {rgb.shape}")
    H, W = rgb.shape[:2]
    if not (0 < H < 65536 and 0 < W < 65536):
        raise ValueError(f"encode_jpeg: bad size {W}x{H}")
    qy, qc = quant_tables(quality)
    y, cb, cr = rgb_to_ycc(rgb)
    mx, my = -(-W // 16), -(-H // 16)  # MCUs across and down
    bw, bh = -(-W // 8), -(-H // 8)  # real luminance blocks
    yq = fdct_quantize(_blocks(_pad(y, 8 * bh, 8 * bw)).reshape(-1, 8, 8), qy).reshape(bh, bw, 64)
    # the MCU grid of luminance blocks: a block past the image is a dummy,
    # zero AC and the DC of the block before it in the MCU
    grid = np.zeros((2 * my, 2 * mx, 64), np.int64)
    grid[:bh, :bw] = yq
    if bw % 2:
        grid[:bh, bw, 0] = yq[:, bw - 1, 0]
    if bh % 2:
        grid[bh, :, 0] = grid[bh - 1, 2 * (np.arange(2 * mx) // 2) + 1, 0]
    ymcu = grid.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
    chroma = [fdct_quantize(_blocks(downsample_h2v2(p, 8 * my, 8 * mx)).reshape(-1, 8, 8),
                            qc).reshape(my, mx, 1, 64) for p in (cb, cr)]
    mcus = np.concatenate([ymcu] + chroma, axis=2).reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    scan = entropy_code(mcus, comp, np.minimum(comp, 1))

    app0 = _segment(0xE0, b"JFIF\x00" + bytes([1, 1, 0]) + struct.pack(">HH", 1, 1) + b"\x00\x00")
    dqt = b"".join(_segment(0xDB, bytes([i]) + bytes(t[ZIGZAG].astype(np.uint8)))
                   for i, t in enumerate((qy, qc)))
    sof = _segment(0xC0, struct.pack(">BHHB", 8, H, W, 3)
                   + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    dht = (_dht(0, 0, DC_LUMA) + _dht(1, 0, AC_LUMA) + _dht(0, 1, DC_CHROMA)
           + _dht(1, 1, AC_CHROMA))
    sos = _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return b"\xff\xd8" + app0 + dqt + sof + dht + sos + scan + b"\xff\xd9"


def save_jpeg(path, rgb: np.ndarray, quality: int = 75) -> None:
    """Write encode_jpeg(rgb, quality) to `path`."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(rgb, quality))
