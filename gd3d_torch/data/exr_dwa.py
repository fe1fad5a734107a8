"""OpenEXR's DWAA / DWAB decompression (OpenEXR 3.1's DwaCompressor), for
gd3d_torch/data/exr.py.

A chunk (32 lines for DWAA, 256 for DWAB) holds eleven 64-bit sizes, the
channel rules (version 2), then four sections: zlib of the channels no rule
claims, the AC coefficients (static Huffman or zlib), the DC coefficients
(zlib with ZIP's predictor) and zlib of the RLE channels (alpha). A rule
gives a channel by its name's last part and pixel type the scheme LOSSY_DCT,
RLE or UNKNOWN, and an R, G or B role; an R, G, B triple of one prefix and
sampling is coded as Y'CbCr. LOSSY_DCT channels are 8x8 blocks of half
coefficients in zig-zag order (the AC run-length coded), each inverted by the
float DCT, taken back to R'G'B' where coded as Y'CbCr, rounded to half and
taken from the nonlinear to the linear domain by a 65536-entry table.

The float arithmetic follows, operation for operation, OpenEXR's AVX inverse
DCT, which its x86-64 builds run wherever the processor has AVX: the row
pass multiplies each row by the even and the odd 4x4 halves of the DCT
matrix and sums the four products of each half in pairs; the column pass
runs the even-odd butterfly on all eight columns at once.
"""
from __future__ import annotations

import bisect
import functools
import struct
import zlib
from typing import List

import numpy as np

from gd3d_torch.data.exr import (_DTYPES, OpenCVRefuses, _rle_decode, _unpredict,
                                 huf_uncompress)

UNKNOWN, LOSSY_DCT, RLE = 0, 1, 2

# (suffix, scheme, pixel type, R/G/B role, case-insensitive) of files before
# version 2, which carry no rules of their own
LEGACY_RULES = ([(s, LOSSY_DCT, t, role, True) for role, names in
                 enumerate((("r", "red"), ("g", "grn", "green"), ("b", "blu", "blue")))
                 for s in names for t in (1, 2)]
                + [(s, LOSSY_DCT, t, -1, True) for s in ("y", "by", "ry") for t in (1, 2)]
                + [("a", RLE, t, -1, True) for t in (0, 1, 2)])

# natural (row-major) position -> zig-zag index
ZIGZAG = np.array([0, 1, 5, 6, 14, 15, 27, 28, 2, 4, 7, 13, 16, 26, 29, 42,
                   3, 8, 12, 17, 25, 30, 41, 43, 9, 11, 18, 24, 31, 40, 44, 53,
                   10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
                   21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63])

_A, _B, _C, _D, _E, _F, _G = (np.float32(v) for v in (
    3.535536e-01, 4.903927e-01, 4.619398e-01, 4.157349e-01, 2.777855e-01, 1.913422e-01,
    9.754573e-02))
# the even half (inputs 0, 2, 4, 6) and the odd half (1, 3, 5, 7) of the
# inverse DCT: row j gives input j's coefficient for outputs 0-3
_EVEN = np.array([[_A, _A, _A, _A], [_C, _F, -_F, -_C], [_A, -_A, -_A, _A],
                  [_F, -_C, _C, -_F]], np.float32)
_ODD = np.array([[_B, _D, _E, _G], [_D, -_G, -_B, -_E], [_E, -_B, _G, _D],
                 [_G, -_E, _D, -_B]], np.float32)


@functools.lru_cache(maxsize=None)
def to_linear_table() -> np.ndarray:
    """dwaCompressorToLinear (read-only): half (bits) -> half (bits), |h|^2.2 up to 1,
    (e^2.2)^(|h| - 1) above, sign kept; 0 for inf and NaN. Each power is
    the correctly rounded float32 (what glibc's powf gives here), taken
    from float64 so that it does not hang on numpy's float32 kernels."""
    bits = np.arange(65536, dtype=np.uint16)
    h = bits.view(np.float16).astype(np.float32)
    a = np.abs(h)
    sign = np.where(h < 0, np.float32(-1), np.float32(1))
    base = np.float64(np.float32(np.power(2.7182818, 2.2)))
    with np.errstate(over="ignore", invalid="ignore"):
        low = np.power(a.astype(np.float64), np.float64(np.float32(2.2)))
        high = np.power(base, (a - np.float32(1)).astype(np.float64))
        lin = np.where(a <= 1, low, high).astype(np.float32)
        out = (sign * lin).astype(np.float16).view(np.uint16)
    table = np.where((bits & 0x7C00) == 0x7C00, np.uint16(0), out).astype(np.uint16)
    table.setflags(write=False)
    return table


_IDENTITY = np.arange(65536, dtype=np.uint16)  # pLinear channels: no transfer curve


def _idct_rows(x: np.ndarray) -> np.ndarray:
    """The row pass on (..., 8, 8) float32: each row times the even and the
    odd 4x4 halves of the DCT matrix, the four products summed in pairs."""
    prod_e = x[..., 0::2, None] * _EVEN  # (..., row, input, output)
    prod_o = x[..., 1::2, None] * _ODD
    even = (prod_e[..., 0, :] + prod_e[..., 1, :]) + (prod_e[..., 2, :] + prod_e[..., 3, :])
    odd = (prod_o[..., 0, :] + prod_o[..., 1, :]) + (prod_o[..., 2, :] + prod_o[..., 3, :])
    return np.concatenate([even + odd, (even - odd)[..., ::-1]], axis=-1)


def _idct_columns(r: np.ndarray) -> np.ndarray:
    """The column pass on (..., 8, 8) float32, all columns at once, in the
    AVX code's order of operations."""
    x = [r[..., i, :] for i in range(8)]
    beta0 = (x[1] * _B + x[3] * _D) + (x[5] * _E + x[7] * _G)
    beta1 = (x[1] * _D - (x[3] * _G + x[5] * _B)) - x[7] * _E
    beta2 = ((x[1] * _E - x[3] * _B) + x[5] * _G) + x[7] * _D
    beta3 = (x[1] * _G + x[5] * _D) - (x[3] * _E + x[7] * _B)
    theta0 = x[0] * _A + x[4] * _A
    theta3 = x[0] * _A - x[4] * _A
    theta1 = x[2] * _C + x[6] * _F
    theta2 = x[2] * _F - x[6] * _C
    gamma = (theta0 + theta1, theta3 + theta2, theta3 - theta2, theta0 - theta1)
    beta = (beta0, beta1, beta2, beta3)
    return np.stack([g + b for g, b in zip(gamma, beta)]
                    + [g - b for g, b in zip(gamma[::-1], beta[::-1])], axis=-2)


def idct8x8(blocks: np.ndarray) -> np.ndarray:
    """(n, 8, 8) float32 coefficients -> samples: rows, then columns."""
    return _idct_columns(_idct_rows(blocks))


def _rules(b: bytes, pos: int, name: str):
    size = struct.unpack_from("<H", b, pos)[0]
    end, pos = pos + size, pos + 2
    rules = []
    while pos < end:
        z = b.index(b"\x00", pos)
        suffix = b[pos:z].decode()
        flags, ptype = b[z + 1], b[z + 2]
        csc, scheme = (flags >> 4) - 1, (flags >> 2) & 3
        if not -1 <= csc < 3 or scheme > 2 or ptype > 2:
            raise OpenCVRefuses(f"{name}: bad DWA channel rule")
        rules.append((suffix, scheme, ptype, csc, bool(flags & 1)))
        pos = z + 3
    return rules, end


def _classify(chans, rules):
    """Each channel's scheme, and the (R, G, B) index triples coded as
    Y'CbCr, in the order of their prefixes."""
    schemes = [UNKNOWN] * len(chans)
    sets = {}
    for k, c in enumerate(chans):
        prefix, _, suffix = c[0].rpartition(".")
        roles = sets.setdefault(prefix, [-1, -1, -1])
        for rs, scheme, ptype, csc, nocase in rules:
            if ptype == c[1] and (suffix.lower() if nocase else suffix) == rs:
                schemes[k] = scheme
                if csc >= 0:
                    roles[csc] = k
    triples = []
    for prefix in sorted(sets):
        r, g, b = sets[prefix]
        if min(r, g, b) >= 0 and chans[r][3] == chans[g][3] == chans[b][3] \
                and chans[r][4] == chans[g][4] == chans[b][4]:
            triples.append((r, g, b))
    return schemes, triples


def _unrle_ac(ac: np.ndarray, nblocks: int, name: str):
    """The AC run-length code of `nblocks` blocks: each 16-bit value is a
    coefficient, 0xffNN a run of NN zeros, 0xff00 the end of the block.
    Returns the (nblocks, 64) zig-zag coefficients (0 for the DC), whether
    each block has one, and the count of values read."""
    ac = ac.astype(np.int64)
    is_run = (ac >> 8) == 0xFF
    step = np.where(is_run, np.where(ac == 0xFF00, 64, ac & 0xFF), 1)
    cum = np.cumsum(step).tolist()
    ends = []
    pos, base = 0, 0
    for _ in range(nblocks):
        e = bisect.bisect_left(cum, base + 63, pos)
        if e >= len(cum):
            raise OpenCVRefuses(f"{name}: DWA AC data ends inside a block")
        ends.append(e)
        pos, base = e + 1, cum[e]
    n = ends[-1] + 1 if ends else 0
    ends = np.asarray(ends, np.int64)
    starts = np.concatenate([[0], ends[:-1] + 1]) if len(ends) else ends
    block = np.repeat(np.arange(nblocks), ends - starts + 1)
    cum = np.asarray(cum[:n], np.int64)
    before = np.concatenate([[0], cum[:-1]]) - np.concatenate([[0], cum])[starts][block]
    vals = ~is_run[:n]
    coeffs = np.zeros((nblocks, 64), np.uint16)
    coeffs[block[vals], 1 + before[vals]] = ac[:n][vals]
    has_ac = np.zeros(nblocks, bool)
    has_ac[block[vals]] = True
    return coeffs, has_ac, n


def _lossy_dct(comps, ac, dc, width, height, table, name):
    """Decodes one channel or a Y'CbCr triple; returns its (height, width)
    half bits per component and the AC and DC values it read."""
    nbx, nby = -(-width // 8), -(-height // 8)
    nb, k = nbx * nby, len(comps)
    if len(dc) < k * nb:
        raise OpenCVRefuses(f"{name}: DWA DC data too short")
    coeffs, has_ac, used = _unrle_ac(ac, nb * k, name)
    coeffs[:, 0] = dc[:k * nb].reshape(k, nb).T.reshape(-1)
    # blocks, then components within a block: (nb, k, 64) in natural order
    blocks = coeffs.reshape(nb, k, 64)[:, :, ZIGZAG].view(np.float16).astype(np.float32)
    out = blocks.reshape(nb * k, 8, 8).copy()
    full = has_ac
    out[full] = idct8x8(out[full])
    flat = ~full
    out[flat] = (out[flat, :1, :1] * _A) * _A
    out = out.reshape(nb, k, 8, 8)
    if k == 3:
        y, cb, cr = out[:, 0], out[:, 1], out[:, 2]
        out = np.stack([y + np.float32(1.5747) * cr,
                        (y - np.float32(0.1873) * cb) - np.float32(0.4682) * cr,
                        y + np.float32(1.8556) * cb], axis=1)
    halves = table[out.astype(np.float16).view(np.uint16)]
    planes = halves.reshape(nby, nbx, k, 8, 8).transpose(2, 0, 3, 1, 4)
    planes = planes.reshape(k, nby * 8, nbx * 8)[:, :height, :width]
    return planes, used, k * nb


def dwa_uncompress(b: bytes, chans, shapes, name: str) -> List[np.ndarray]:
    """One DWAA / DWAB chunk -> each channel's (ny, nx) samples."""
    if len(b) < 88:
        raise OpenCVRefuses(f"{name}: DWA chunk header truncated")
    (version, unk_raw, unk_size, ac_size, dc_size, rle_size, rle_raw, rle_plain, ac_count,
     dc_count, ac_comp) = struct.unpack_from("<11Q", b, 0)
    if version > 2:
        raise OpenCVRefuses(f"{name}: DWA version {version}")
    pos = 88
    rules = LEGACY_RULES
    if version == 2:
        rules, pos = _rules(b, pos, name)
    if pos + unk_size + ac_size + dc_size + rle_size > len(b):
        raise OpenCVRefuses(f"{name}: DWA chunk truncated")
    unk = b[pos:pos + unk_size]
    pos += unk_size
    acb = b[pos:pos + ac_size]
    pos += ac_size
    dcb = b[pos:pos + dc_size]
    pos += dc_size
    rleb = b[pos:pos + rle_size]
    schemes, triples = _classify(chans, rules)

    unknown = np.frombuffer(zlib.decompress(unk), np.uint8) if unk_size else np.zeros(0, np.uint8)
    if len(unknown) != (unk_raw if unk_size else 0):
        raise OpenCVRefuses(f"{name}: DWA unknown-channel data of the wrong size")
    if not ac_size:
        ac = np.zeros(0, np.uint16)
    elif ac_comp == 0:
        ac = huf_uncompress(acb, ac_count, name)
    elif ac_comp == 1:
        ac = np.frombuffer(zlib.decompress(acb), "<u2")
        if len(ac) != ac_count:
            raise OpenCVRefuses(f"{name}: DWA AC data of the wrong size")
    else:
        raise OpenCVRefuses(f"{name}: DWA AC compression {ac_comp}")
    dc = (np.frombuffer(_unpredict(np.frombuffer(zlib.decompress(dcb), np.uint8)), "<u2")
          if dc_size else np.zeros(0, np.uint16))
    if len(dc) != (dc_count if dc_size else 0):
        raise OpenCVRefuses(f"{name}: DWA DC data of the wrong size")
    rle = np.zeros(0, np.uint8)
    if rle_plain:
        packed = zlib.decompress(rleb)
        if len(packed) != rle_raw:
            raise OpenCVRefuses(f"{name}: DWA RLE data of the wrong size")
        rle = _rle_decode(packed, rle_plain, name)

    out: List = [None] * len(chans)
    ac_at = dc_at = 0
    for r, g, bl in triples:
        ny, nx = shapes[r]
        planes, na, nd = _lossy_dct((r, g, bl), ac[ac_at:], dc[dc_at:], nx, ny,
                                    to_linear_table(), name)
        ac_at, dc_at = ac_at + na, dc_at + nd
        for k, c in enumerate((r, g, bl)):
            out[c] = planes[k]
    unk_at = rle_at = 0
    for c, (ch, scheme) in enumerate(zip(chans, schemes)):
        if out[c] is not None:
            continue
        ny, nx = shapes[c]
        dt = _DTYPES[ch[1]]
        if scheme == LOSSY_DCT:
            table = _IDENTITY if ch[2] else to_linear_table()
            planes, na, nd = _lossy_dct((c,), ac[ac_at:], dc[dc_at:], nx, ny, table, name)
            ac_at, dc_at = ac_at + na, dc_at + nd
            out[c] = planes[0]
        elif scheme == RLE:
            n = ny * nx
            part = rle[rle_at:rle_at + n * dt.itemsize]
            rle_at += n * dt.itemsize
            if len(part) != n * dt.itemsize:
                raise OpenCVRefuses(f"{name}: DWA RLE data too short")
            out[c] = np.ascontiguousarray(part.reshape(dt.itemsize, n).T).view(dt).reshape(ny, nx)
        else:
            n = ny * nx * dt.itemsize
            if unk_at + n > len(unknown):
                raise OpenCVRefuses(f"{name}: DWA unknown-channel data too short")
            out[c] = unknown[unk_at:unk_at + n].view(dt).reshape(ny, nx)
            unk_at += n
    for c, ch in enumerate(chans):
        if schemes[c] == LOSSY_DCT:  # half bits; FLOAT channels widened
            bits = np.ascontiguousarray(out[c]).view("<f2")
            out[c] = bits.astype("<f4") if ch[1] == 2 else bits
    return out
