"""Windows BMP decoding without PIL, to PIL's arrays.

gd3d's align, localize and demo CLIs collect `.bmp` views and open them
with PIL (gd3d/data/images.py::_to_pil); the card's machine has no PIL.
`decode_bmp` follows Pillow's BmpImagePlugin and gives the mode it opens the
file in and np.asarray of that image:

  * headers: core (12 bytes, 3-byte palette entries), INFO (40; BI_BITFIELDS
    masks after it), V2-V5 and OS/2 v2 (52-124; masks inside);
  * 1-, 4- and 8-bit palettes: mode P (indices and the palette), or L or 1
    where the palette is Pillow's grey ramp (0..n-1) or black and white;
  * 16 bits: 5-5-5 (BI_RGB or its bitfields) or 5-6-5 bitfields, each field
    scaled as field * 255 // (2^bits - 1); 24 bits BGR; 32 bits BI_RGB
    BGRX with the fourth byte ignored (RGB), bitfields in Pillow's eight
    layouts, RGBA where one has an alpha mask;
  * RLE8 and RLE4, with Pillow's own decoder's reading of end-of-line,
    delta and absolute runs (an odd absolute RLE4 run keeps its even part);
  * bottom-up rows, or top-down where the height is negative.

`pil_rgb` is Image.open(f).convert("RGB"), with gd3d's white composite of
RGBA when asked. Anything Pillow refuses (other depths, bitfield layouts
and compressions, JPEG or PNG inside a BMP) raises ValueError naming the
file and the feature; so do the palettes whose grey-ramp mode Pillow would
unpack at another depth than the file's.
"""
from __future__ import annotations

import struct
from typing import NamedTuple, Optional, Tuple

import numpy as np

from gd3d_torch.data.source import Source, read_source


# 32-bit bitfield masks (R, G, B, A) that Pillow takes; 24 and 16 bits RGB
_MASKS32 = {(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
            (0xFF000000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
            (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
            (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)}
_MASK565, _MASK555 = (0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)
_COMPRESSION = {0: "BI_RGB", 1: "RLE8", 2: "RLE4", 3: "BI_BITFIELDS", 4: "JPEG", 5: "PNG"}


class Bmp(NamedTuple):
    """A decoded file: Pillow's `mode` ("1", "L", "P", "RGB" or "RGBA") and
    np.asarray of the image in it (bool for "1", indices for "P"), with the
    (n, 3) RGB `palette` of a "P" image."""

    mode: str
    pixels: np.ndarray
    palette: Optional[np.ndarray]


def _header(data: bytes, name: str) -> dict:
    if data[:2] != b"BM" or len(data) < 18:
        raise ValueError(f"{name}: not a BMP file")
    offset = struct.unpack_from("<I", data, 10)[0]
    hsize = struct.unpack_from("<I", data, 14)[0]
    hd = data[18:14 + hsize]
    if len(hd) < hsize - 4:
        raise ValueError(f"{name}: truncated BMP header")
    info = {"offset": offset, "hsize": hsize, "top_down": False, "pad": 4}
    if hsize == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", hd)
        info.update(w=w, h=h, bits=bits, compression=0, colors=0, pad=3)
    elif hsize in (40, 52, 56, 64, 108, 124):
        w, h, _, bits, comp = struct.unpack_from("<IIHHI", hd)
        info["top_down"] = hd[7] == 0xFF
        if info["top_down"]:
            h = 2 ** 32 - h
        info.update(w=w, h=h, bits=bits, compression=comp,
                    colors=struct.unpack_from("<I", hd, 28)[0])
        if comp == 3:
            if len(hd) >= 48:
                masks = struct.unpack_from("<4I" if len(hd) >= 52 else "<3I", hd, 36)
                info["masks"] = tuple(masks) + (0,) * (4 - len(masks))
            else:
                info["masks"] = struct.unpack_from("<3I", data, 14 + hsize) + (0,)
    else:
        raise ValueError(f"{name}: BMP header of {hsize} bytes is not supported")
    info["colors"] = info["colors"] or (1 << info["bits"])
    if offset == 14 + hsize and info["bits"] <= 8:
        info["offset"] += 4 * info["colors"]
    if info["bits"] not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{name}: {info['bits']}-bit BMP is not supported")
    if info["compression"] not in (0, 1, 2, 3):
        raise ValueError(f"{name}: BMP compression "
                         f"{_COMPRESSION.get(info['compression'], info['compression'])} "
                         f"is not supported")
    return info


def bmp_size(src: Source, name: Optional[str] = None) -> Tuple[int, int]:
    """(width, height), as PIL's Image.open(f).size."""
    data, name = read_source(src, name)
    info = _header(data, name)
    return info["w"], info["h"]


def _rows(data: bytes, info: dict, name: str) -> np.ndarray:
    """The stored rows, top row first: (h, stride) uint8."""
    w, h, bits = info["w"], info["h"], info["bits"]
    stride = ((w * bits + 31) >> 3) & ~3
    raw = data[info["offset"]: info["offset"] + stride * h]
    if len(raw) < stride * h:
        raise ValueError(f"{name}: truncated BMP pixel data")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride)
    return rows if info["top_down"] else rows[::-1]


def _rle(data: bytes, info: dict, rle4: bool, name: str) -> np.ndarray:
    """Pillow's BmpRleDecoder: the indices, top row first."""
    w, h = info["w"], info["h"]
    out = bytearray()
    x, pos, n = 0, info["offset"], len(data)
    while len(out) < w * h:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, w - x)) if x + count > w else count
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:  # Pillow reads two bytes, then the offsets from the next two
            if pos + 2 > n:
                break
            pos += 2
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:
            take = byte // 2 if rle4 else byte
            chunk = data[pos:pos + take]
            pos += len(chunk)
            if rle4:
                out += bytes(v for b in chunk for v in (b >> 4, b & 15))
            else:
                out += chunk
            if len(chunk) < take:
                break
            x += byte
            pos += pos % 2  # runs end on a 16-bit word of the file
    if len(out) < w * h:
        raise ValueError(f"{name}: truncated RLE BMP data")
    rows = np.frombuffer(bytes(out[:w * h]), np.uint8).reshape(h, w)
    return rows if info["top_down"] else rows[::-1]


def _field(px: np.ndarray, mask: int) -> np.ndarray:
    shift = (mask & -mask).bit_length() - 1
    top = mask >> shift
    v = (px & mask) >> shift
    return (v * 255 // top).astype(np.uint8) if top != 255 else v.astype(np.uint8)


def decode_bmp(src: Source, name: Optional[str] = None) -> Bmp:
    """The file's pixels in Pillow's mode (see Bmp)."""
    data, name = read_source(src, name)
    info = _header(data, name)
    w, h, bits, comp = info["w"], info["h"], info["bits"], info["compression"]
    if bits <= 8:
        if comp == 3:
            raise ValueError(f"{name}: BI_BITFIELDS with {bits}-bit samples is not supported")
        pad, colors = info["pad"], info["colors"]
        if not 0 < colors <= 65536:
            raise ValueError(f"{name}: BMP palette of {colors} colours is not supported")
        start = 14 + info["hsize"]
        raw_pal = data[start:start + pad * colors]
        n = len(raw_pal) // pad
        pal = np.frombuffer(raw_pal[:n * pad], np.uint8).reshape(n, pad)[:, 2::-1]
        ramp = [0, 255] if colors == 2 else list(range(colors))
        grey = all(i < n and (pal[i] == v).all() for i, v in enumerate(ramp))
        mode = ("1" if colors == 2 else "L") if grey else "P"
        if grey and bits != (1 if mode == "1" else 8):
            raise ValueError(f"{name}: a {bits}-bit BMP with a {colors}-entry grey palette "
                             f"(Pillow unpacks it as {mode} at another depth) is not supported")
        if comp in (1, 2):
            if mode == "1":
                raise ValueError(f"{name}: RLE BMP with a black-and-white palette is not "
                                 f"supported")
            idx = _rle(data, info, comp == 2, name)
        elif comp == 0:
            packed = _rows(data, info, name)
            if bits == 8:
                idx = packed[:, :w]
            else:
                unpacked = np.unpackbits(packed, axis=1)[:, :w * bits].reshape(h, w, bits)
                weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
                idx = (unpacked * weights).sum(-1, dtype=np.uint8)
        else:
            raise ValueError(f"{name}: {_COMPRESSION[comp]} with {bits}-bit samples is not "
                             f"supported")
        idx = np.ascontiguousarray(idx)
        if mode == "1":
            return Bmp(mode, idx > 0, None)
        return Bmp(mode, idx, None if grey else np.ascontiguousarray(pal))
    if comp in (1, 2):
        raise ValueError(f"{name}: {_COMPRESSION[comp]} with {bits}-bit samples is not supported")
    rows = _rows(data, info, name)
    if bits == 24:
        if comp == 3 and info["masks"][:3] != (0xFF0000, 0xFF00, 0xFF):
            raise ValueError(f"{name}: BMP bitfields layout {info['masks'][:3]} is not supported")
        return Bmp("RGB", np.ascontiguousarray(rows[:, :3 * w].reshape(h, w, 3)[..., ::-1]), None)
    if bits == 16:
        masks = info["masks"][:3] if comp == 3 else _MASK555
        if masks not in (_MASK565, _MASK555):
            raise ValueError(f"{name}: BMP bitfields layout {masks} is not supported")
        px = rows[:, :2 * w].copy().view("<u2").astype(np.int64)
        return Bmp("RGB", np.stack([_field(px, m) for m in masks], -1), None)
    px = rows[:, :4 * w].copy().view("<u4").astype(np.int64)
    masks = info["masks"] if comp == 3 else (0xFF0000, 0xFF00, 0xFF, 0)
    if masks not in _MASKS32:
        raise ValueError(f"{name}: BMP bitfields layout {masks} is not supported")
    if masks == (0, 0, 0, 0):  # Pillow reads it as BGRA
        masks = (0xFF0000, 0xFF00, 0xFF, 0xFF000000)
    out = np.stack([_field(px, m) for m in masks if m], -1)
    return Bmp("RGBA" if masks[3] else "RGB", out, None)


def pil_rgb(bmp: Bmp, composite: bool = True) -> np.ndarray:
    """(H, W, 3) uint8: Image.open(f).convert("RGB"), RGBA first composited
    onto white when `composite` (gd3d's _to_pil) and its alpha dropped
    otherwise."""
    from gd3d_torch.data.png import _composite_on_white

    p = bmp.pixels
    if bmp.mode == "1":
        return np.repeat((p.astype(np.uint8) * np.uint8(255))[..., None], 3, -1)
    if bmp.mode == "L":
        return np.repeat(p[..., None], 3, -1)
    if bmp.mode == "P":
        lut = np.zeros((256, 3), np.uint8)
        lut[:min(256, len(bmp.palette))] = bmp.palette[:256]
        return lut[p]
    if bmp.mode == "RGBA" and composite:
        return _composite_on_white(p[..., :3], p[..., 3])
    return np.ascontiguousarray(p[..., :3])
