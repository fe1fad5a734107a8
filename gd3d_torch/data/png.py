"""PNG decoding without cv2 or PIL, to their arrays.

gd3d reads the Objaverse renders with `cv2.imread` in four modes and with
PIL's `Image.open(f).convert("RGB")` (gd3d/data/objaverse.py,
gd3d/data/images.py); the card's machine has neither. `decode_png` inflates
the IDAT stream with `zlib` and undoes the row filters in numpy; `imread`
and `open_rgb` give what those calls give for the same file:

  * `imread(f)` (cv2.IMREAD_COLOR): 3 channels BGR, 8 bits; grey is
    replicated, a palette expanded, alpha dropped (not composited), and 16
    bits reduced to their high byte;
  * `imread(f, IMREAD_GRAYSCALE)`: one 8-bit channel; colour becomes grey by
    libpng's fixed-point weights (rgb_to_gray_coefficients);
  * `imread(f, IMREAD_ANYDEPTH)`: one channel at the file's depth, grey
    computed as above at 16 bits where the file has 16;
  * `imread(f, IMREAD_ANYDEPTH | IMREAD_COLOR)`: as IMREAD_COLOR, but at
    the file's depth (the KITTI flow files' 16-bit BGR);
  * `imread(f, IMREAD_UNCHANGED)`: the file's channels (BGR, BGRA; grey with
    alpha as BGRA; a palette with transparency, or an RGB colour key, as
    BGRA) at its depth; the other three modes also apply the EXIF
    orientation of an eXIf chunk, as OpenCV does;
  * `open_rgb(f)`: PIL's RGB of the file after ImageOps.exif_transpose, with
    RGBA first composited onto white (gd3d/data/images.py::_to_pil);
    `pil_rgb(png, composite=False)` is Image.open(f).convert("RGB") alone.

`encode_png` writes 8- and 16-bit grey, RGB and RGBA files (filter 0, one
zlib IDAT), which both libraries read back to the array written.

`pil_array(f)` is np.asarray(Image.open(f)) and `pil_l(f)` its
convert("L"), in every PNG mode PIL opens.

Scope: every PNG of the standard: grey, grey+alpha, RGB, RGBA and palette
images at every bit depth they allow (1, 2, 4, 8, 16), with tRNS, plain or
Adam7-interlaced. Grey below 8 bits is scaled to 8 (x 255, 85 or 17), as
both libraries expand it; palette samples below 8 bits are indices.
Gamma and colour-profile chunks are ignored, as both libraries ignore them
in these calls.

Filters: None and Up are elementwise, Sub a cumulative sum along the row
(mod 256). Average and Paeth depend on the decoded left neighbour, so an
image with such rows is decoded as a wavefront over the anti-diagonals
(row + pixel column constant): about W + H vector steps, each row's own
filter applied elementwise.
"""
from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np

from gd3d_torch.data import exif
from gd3d_torch.data.source import Source, read_source


SIGNATURE = b"\x89PNG\r\n\x1a\n"
# cv2.IMREAD_* values
IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR, IMREAD_ANYDEPTH = -1, 0, 1, 2
IMREAD_COLOR_ANYDEPTH = IMREAD_COLOR | IMREAD_ANYDEPTH
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class Png(NamedTuple):
    """A decoded file: `samples` (H, W, C) uint8 or uint16 as stored (palette
    indices for colour type 3; grey below 8 bits scaled to 8), and what the
    header chunks said (`bit_depth` the file's own)."""

    samples: np.ndarray
    color_type: int
    bit_depth: int
    palette: Optional[np.ndarray]  # (n, 3) uint8
    trns: Optional[bytes]
    exif: Optional[bytes]


def chunks(data: bytes, name: str):
    """(type, payload) of each chunk up to IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file (no signature)")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + n]
        if len(payload) < n:
            break
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{name}: truncated PNG (no IEND)")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """raw (H, stride) uint8 filtered bytes, filters (H,) their types ->
    (H, stride) uint8 reconstructed bytes (PNG spec section 9)."""
    h, stride = raw.shape
    wp = stride // bpp
    out = np.zeros((h, stride), np.uint8)
    if not np.isin(filters, (3, 4)).any():
        prev = np.zeros(stride, np.uint8)
        for y in range(h):
            r, f = raw[y], filters[y]
            if f == 0:
                row = r
            elif f == 1:
                row = np.cumsum(r.reshape(wp, bpp), axis=0, dtype=np.uint8).reshape(-1)
            else:
                row = r + prev
            out[y] = prev = row
        return out
    # wavefront: pixel (y, p) needs (y, p-1), (y-1, p) and (y-1, p-1)
    src = raw.reshape(h, wp, bpp).astype(np.int32)
    rec = np.zeros((h + 1, wp + 1, bpp), np.int32)  # a zero row above and column left
    ft = filters.astype(np.int32)
    for d in range(h + wp - 1):
        y = np.arange(max(0, d - wp + 1), min(h, d + 1))
        p = d - y
        a, b, c = rec[y + 1, p], rec[y, p + 1], rec[y, p]
        f = ft[y][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
        rec[y + 1, p + 1] = (src[y, p] + pred) & 255
    return rec[1:, 1:].astype(np.uint8).reshape(h, stride)


# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _unpack(px: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """(h, stride) reconstructed bytes -> (h, w, ch) samples: uint16 from
    big-endian pairs at 16 bits, else one uint8 per sample (bits below 8
    unpacked from the high end of each byte)."""
    h = px.shape[0]
    if depth == 16:
        return px.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return px.reshape(h, -1)[:, : w * ch].reshape(h, w, ch)
    bits = np.unpackbits(px, axis=1)[:, : w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def _pass(buf: bytes, pos: int, w: int, h: int, ch: int, depth: int, name: str):
    """One image (or Adam7 pass) of w x h from buf[pos:]: its samples and
    the position after it."""
    bpp = max(1, ch * depth // 8)
    stride = (w * ch * depth + 7) // 8
    end = pos + h * (stride + 1)
    if len(buf) < end:
        raise ValueError(f"{name}: truncated PNG image data")
    rows = np.frombuffer(buf, np.uint8, h * (stride + 1), pos).reshape(h, stride + 1)
    filters = rows[:, 0]
    if (filters > 4).any():
        raise ValueError(f"{name}: bad PNG row filter {int(filters.max())}")
    return _unpack(unfilter(rows[:, 1:], filters, bpp), w, ch, depth), end


def decode_png(src: Source, name: Optional[str] = None) -> Png:
    """The file's samples and header information (see Png)."""
    data, name = read_source(src, name)
    ihdr, palette, trns, exif, idat = None, None, None, None, []
    for kind, p in chunks(data, name):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", p[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(p[: len(p) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = p
        elif kind == b"eXIf":
            exif = p
        elif kind == b"IDAT":
            idat.append(p)
    if ihdr is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS:
        raise ValueError(f"{name}: bad PNG colour type {ctype}")
    allowed = {0: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8)}.get(ctype, (8, 16))
    if depth not in allowed:
        raise ValueError(f"{name}: {depth}-bit samples are not valid for PNG colour type {ctype}")
    if interlace > 1:
        raise ValueError(f"{name}: unknown PNG interlace method {interlace}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[ctype]
    buf = zlib.decompress(b"".join(idat))
    if not interlace:
        samples, _ = _pass(buf, 0, w, h, ch, depth, name)
    else:
        samples = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:
                samples[y0::dy, x0::dx], pos = _pass(buf, pos, pw, ph, ch, depth, name)
    if ctype == 0 and depth < 8:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    return Png(np.ascontiguousarray(samples), ctype, depth, palette, trns, exif)


def _palette_rgba(png: Png) -> np.ndarray:
    """(256, 4) uint8 palette with alpha (tRNS; 255 past it), indices past
    the palette black."""
    lut = np.zeros((256, 4), np.uint8)
    lut[:, 3] = 255
    lut[: len(png.palette), :3] = png.palette
    if png.trns:
        a = np.frombuffer(png.trns[:256], np.uint8)
        lut[: len(a), 3] = a
    return lut


def _high_byte(a: np.ndarray) -> np.ndarray:
    return (a >> 8).astype(np.uint8) if a.dtype == np.uint16 else a


# libpng's png_set_rgb_to_gray(png, 1, 0.299, 0.587): weights in 15 bits
_GRAY_R, _GRAY_G = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_GRAY_B = 32768 - _GRAY_R - _GRAY_G


def _rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """libpng's png_do_rgb_to_gray without gamma: a pixel with equal
    channels stays as it is, else (rc R + gc G + bc B) >> 15, rounded at 16
    bits and truncated at 8."""
    x = rgb.astype(np.int64)
    half = 1 << 14 if rgb.dtype == np.uint16 else 0
    g = (_GRAY_R * x[..., 0] + _GRAY_G * x[..., 1] + _GRAY_B * x[..., 2] + half) >> 15
    same = (x[..., 0] == x[..., 1]) & (x[..., 0] == x[..., 2])
    return np.where(same, x[..., 0], g).astype(rgb.dtype)


def _rgb_alpha(png: Png) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(H, W, 3) RGB at the file's depth, (H, W) alpha or None."""
    s = png.samples
    if png.color_type == 3:
        rgba = _palette_rgba(png)[s[..., 0]]
        return rgba[..., :3], (rgba[..., 3] if png.trns else None)
    if png.color_type in (0, 4):
        rgb = np.repeat(s[..., :1], 3, axis=-1)
    else:
        rgb = s[..., :3]
    alpha = s[..., -1] if png.color_type in (4, 6) else None
    if png.color_type == 2 and png.trns and len(png.trns) >= 6:  # a colour key
        key = np.frombuffer(png.trns[:6], ">u2").astype(s.dtype)
        top = np.iinfo(s.dtype).max
        alpha = np.where((s == key).all(-1), 0, top).astype(s.dtype)
    return rgb, alpha


def imread(src: Source, flags: int = IMREAD_COLOR) -> np.ndarray:
    """cv2.imread(src, flags) of a PNG, for flags IMREAD_COLOR,
    IMREAD_GRAYSCALE, IMREAD_ANYDEPTH and IMREAD_UNCHANGED (see the module
    docstring)."""
    return cv2_view(decode_png(src), flags)


def cv2_view(png: Png, flags: int = IMREAD_COLOR) -> np.ndarray:
    """imread's array of a decoded file: in every mode but IMREAD_UNCHANGED
    turned upright by its EXIF orientation, as OpenCV does."""
    out = _cv2_pixels(png, flags)
    if flags == IMREAD_UNCHANGED:
        return out
    return exif.transpose(out, exif.orientation(png.exif))


def _cv2_pixels(png: Png, flags: int) -> np.ndarray:
    rgb, alpha = _rgb_alpha(png)
    if flags == IMREAD_UNCHANGED:
        if png.color_type == 0:
            return png.samples[..., 0]
        if alpha is None:
            return np.ascontiguousarray(rgb[..., ::-1])
        return np.ascontiguousarray(np.concatenate([rgb[..., ::-1], alpha[..., None]], -1))
    if flags == IMREAD_COLOR:
        return np.ascontiguousarray(_high_byte(rgb)[..., ::-1])
    if flags == IMREAD_COLOR_ANYDEPTH:
        return np.ascontiguousarray(rgb[..., ::-1])
    if flags in (IMREAD_GRAYSCALE, IMREAD_ANYDEPTH):
        if png.color_type in (0, 4):
            grey = png.samples[..., 0]
        else:
            grey = _rgb_to_gray(rgb)
        return grey if flags == IMREAD_ANYDEPTH else _high_byte(grey)
    raise ValueError(f"imread: flags {flags} are not supported")


def _composite_on_white(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """Pillow's Image.alpha_composite(white, im) for 8-bit RGBA (AlphaComposite.c,
    7 fractional bits): on white its coefficients are a * 128 and
    (255 - a) * 128, and a division by 255 is ((v >> 8) + v) >> 8."""
    a = alpha.astype(np.int64)[..., None]
    tmp = rgb.astype(np.int64) * (a << 7) + 255 * ((255 - a) << 7) + (0x80 << 7)
    out = (((tmp >> 8) + tmp) >> 8) >> 7
    return np.where(a == 0, 255, out).astype(np.uint8)


def pil_rgb(png: Png, composite: bool = True) -> np.ndarray:
    """(H, W, 3) uint8: Pillow's image of the file composited onto white
    when it is RGBA (gd3d/data/images.py::_to_pil; with composite False
    the alpha is dropped, as convert("RGB") alone does), then
    convert("RGB"). PIL keeps the high byte of 16-bit colour and grey+alpha
    samples (it opens 16-bit grey+alpha as RGBA) and clips 16-bit grey
    (mode I;16) to 255."""
    if png.color_type == 0 and png.bit_depth == 16:
        grey = np.minimum(png.samples[..., 0], 255).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=-1)
    rgb, alpha = _rgb_alpha(png)
    rgb = _high_byte(rgb)
    rgba = png.color_type == 6 or (png.color_type == 4 and png.bit_depth == 16)  # PIL's RGBA
    if composite and rgba:
        return _composite_on_white(rgb, _high_byte(alpha))
    return np.ascontiguousarray(rgb)


def pil_array(png: Png) -> np.ndarray:
    """np.asarray(Image.open(f)) in the mode PIL opens the file in: bool
    for 1-bit grey (mode 1), uint8 (H, W) grey (L) or palette indices (P),
    uint16 (H, W) for 16-bit grey (I;16), (H, W, 2) LA, and the high byte of
    16-bit colour as RGB or RGBA (16-bit grey+alpha opens as RGBA)."""
    s = png.samples
    if png.color_type == 0:
        grey = s[..., 0]
        return grey > 0 if png.bit_depth == 1 else grey
    if png.color_type == 3:
        return s[..., 0]
    if png.color_type == 4 and png.bit_depth == 16:
        hi = _high_byte(s)
        grey = np.repeat(hi[..., :1], 3, -1)
        return np.ascontiguousarray(np.concatenate([grey, hi[..., 1:]], -1))
    return np.ascontiguousarray(_high_byte(s))


def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's L24 luma of uint8 RGB: (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    x = rgb.astype(np.int64)
    return ((19595 * x[..., 0] + 38470 * x[..., 1] + 7471 * x[..., 2] + 0x8000)
            >> 16).astype(np.uint8)


def pil_l(png: Png) -> np.ndarray:
    """(H, W) uint8: Image.open(f).convert("L"): grey as it is (mode 1 as
    0/255), I;16 clipped to 255, LA's grey, the luma of RGB(A) and of a
    palette's colours (alpha ignored)."""
    a = pil_array(png)
    if png.color_type == 0:
        if png.bit_depth == 16:
            return np.minimum(a, 255).astype(np.uint8)
        return a.astype(np.uint8) * np.uint8(255) if a.dtype == bool else a
    if png.color_type == 3:
        return _luma(_palette_rgba(png)[a, :3])
    if a.shape[-1] == 2:
        return np.ascontiguousarray(a[..., 0])
    return _luma(a[..., :3])


def encode_png_rgb(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of a uint8 (H, W, 3) array: every row filter 0, one
    zlib IDAT at level 1 (the fabricated OnePose trees' frames)."""
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
        raise ValueError(f"encode_png_rgb takes uint8 (H, W, 3), got {rgb.dtype} {rgb.shape}")
    return encode_png(rgb)


def encode_png(img: np.ndarray) -> bytes:
    """A PNG of a uint8 or uint16 (H, W) grey, (H, W, 3) RGB or (H, W, 4)
    RGBA array, at the array's depth: every row filter 0, one zlib IDAT at
    level 1."""
    if img.dtype not in (np.uint8, np.uint16) or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (3, 4))):
        raise ValueError(f"encode_png takes uint8 or uint16 (H, W), (H, W, 3) or (H, W, 4), "
                         f"got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    depth = 8 * img.dtype.itemsize
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.reshape(h, w * c * depth // 8)],
                         1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, {1: 0, 3: 2, 4: 6}[c],
                                                   0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))
