"""WebP decoding without PIL, to Pillow's arrays.

gd3d's align, localize and demo CLIs collect `.webp` views and open them with
PIL (gd3d/data/images.py::_to_pil), which decodes through libwebp's
WebPAnimDecoder into non-premultiplied RGBA; the card's machine has no PIL.
`decode_webp` gives Pillow's mode ("RGB", or "RGBA" where the file has
alpha) and np.asarray of the image:

  * the RIFF container: a simple `VP8 ` or `VP8L` file, or `VP8X` with an
    `ALPH` chunk (raw or VP8L-compressed alpha, with its horizontal,
    vertical or gradient filter undone as libwebp's unfilters do) and an
    `EXIF` chunk, whose orientation `exif_bytes` gives data/images.py;
    ICCP and XMP are ignored, as Pillow's RGB ignores them;
  * lossless bitstreams through data/vp8l.py (ARGB to RGBA);
  * lossy bitstreams through data/vp8.py, then libwebp's fancy upsampler
    (UpsampleRgbaLinePair: the 9-3-3-1 chroma weights, the first and an
    even height's last row from one chroma row) and its 14-bit YUV -> RGB
    (yuv.h: MultHi by 19077, 26149, 6419, 13320, 33050, then the 6-bit
    clip), with no dithering, as Pillow asks for none.

`pil_rgb` is Image.open(f).convert("RGB") with gd3d's white composite of RGBA
when asked. Animated files (ANIM / ANMF) raise ValueError naming the file;
so do files libwebp would refuse.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from gd3d_torch.data import vp8, vp8l
from gd3d_torch.data.source import Source, read_source


class WebP(NamedTuple):
    """A decoded file: Pillow's `mode` and (H, W, 3 or 4) uint8 pixels."""

    mode: str
    pixels: np.ndarray


def is_webp(data: bytes) -> bool:
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def _chunks(data: bytes, name: str) -> Dict[bytes, bytes]:
    if not is_webp(data):
        raise ValueError(f"{name}: not a WebP file")
    end = min(len(data), 8 + int.from_bytes(data[4:8], "little"))
    out: Dict[bytes, bytes] = {}
    pos = 12
    while pos + 8 <= end:
        kind = data[pos:pos + 4]
        n = int.from_bytes(data[pos + 4:pos + 8], "little")
        if pos + 8 + n > len(data):
            raise ValueError(f"{name}: truncated WebP chunk {kind!r}")
        out.setdefault(kind, data[pos + 8:pos + 8 + n])
        pos += 8 + n + (n & 1)
    return out


def exif_bytes(data: bytes) -> Optional[bytes]:
    """The TIFF block of a WebP's EXIF chunk (an "Exif\\0\\0" prefix
    dropped), or None."""
    try:
        ex = _chunks(data, "<bytes>").get(b"EXIF")
    except ValueError:
        return None
    if ex is not None and ex.startswith(b"Exif\x00\x00"):
        ex = ex[6:]
    return ex


def webp_size(src: Source, name: Optional[str] = None) -> Tuple[int, int]:
    """(width, height), as PIL's Image.open(f).size (the canvas)."""
    data, name = read_source(src, name)
    ch = _chunks(data, name)
    if b"VP8X" in ch:
        x = ch[b"VP8X"]
        return 1 + int.from_bytes(x[4:7], "little"), 1 + int.from_bytes(x[7:10], "little")
    try:
        if b"VP8L" in ch:
            return vp8l.vp8l_header(ch[b"VP8L"])[:2]
        if b"VP8 " in ch:
            return vp8.vp8_size(ch[b"VP8 "])
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    raise ValueError(f"{name}: WebP file without an image chunk")


# libwebp's yuv.h, YUV_FIX2 = 6
def _clip8(v: np.ndarray) -> np.ndarray:
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    y, u, v = (a.astype(np.int64) for a in (y, u, v))
    yy = (y * 19077) >> 8
    r = _clip8(yy + ((v * 26149) >> 8) - 14234)
    g = _clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    b = _clip8(yy + ((u * 33050) >> 8) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def _upsample_rows(a: np.ndarray, b: np.ndarray, width: int):
    """One output row pair's chroma from chroma rows a (above) and b:
    (the upper row's, the lower row's) full-width samples."""
    a, b = a.astype(np.int64), b.astype(np.int64)
    top = np.empty(width, np.int64)
    bot = np.empty(width, np.int64)
    top[0] = (3 * a[0] + b[0] + 2) >> 2
    bot[0] = (3 * b[0] + a[0] + 2) >> 2
    pairs = (width - 1) >> 1
    if pairs:
        tl, t, lf, c = a[:pairs], a[1:pairs + 1], b[:pairs], b[1:pairs + 1]
        avg = tl + t + lf + c + 8
        d12 = (avg + 2 * (t + lf)) >> 3
        d03 = (avg + 2 * (tl + c)) >> 3
        top[1:2 * pairs:2] = (d12 + tl) >> 1
        top[2:2 * pairs + 1:2] = (d03 + t) >> 1
        bot[1:2 * pairs:2] = (d03 + lf) >> 1
        bot[2:2 * pairs + 1:2] = (d12 + c) >> 1
    if not width & 1:
        tl, lf = a[pairs], b[pairs]
        top[width - 1] = (3 * tl + lf + 2) >> 2
        bot[width - 1] = (3 * lf + tl + 2) >> 2
    return top, bot


def upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """libwebp's fancy upsampling of one (ceil(h/2), ceil(w/2)) chroma plane
    to (h, w), as EmitFancyRGB walks the rows."""
    out = np.empty((h, w), np.int64)
    out[0] = _upsample_rows(c[0], c[0], w)[0]
    for k in range(1, (h + 1) // 2 + 1):
        r1, r2 = 2 * k - 1, 2 * k
        if r1 >= h:
            break
        if k < c.shape[0]:
            top, bot = _upsample_rows(c[k - 1], c[k], w)
            out[r1] = top
            if r2 < h:
                out[r2] = bot
        else:  # the last row of an even height: one chroma row
            out[r1] = _upsample_rows(c[k - 1], c[k - 1], w)[0]
    return out


def _unfilter_alpha(a: np.ndarray, method: int) -> np.ndarray:
    """libwebp's HorizontalUnfilter / VerticalUnfilter / GradientUnfilter
    over the rows of the (H, W) filtered alpha."""
    a = a.astype(np.int64)
    h, w = a.shape
    out = np.empty_like(a)
    for y in range(h):
        prev = out[y - 1] if y else None
        if method == 1 or prev is None:
            pred0 = prev[0] if (method == 1 and prev is not None) else 0
            out[y] = (pred0 + np.cumsum(a[y])) & 255
        elif method == 2:
            out[y] = (prev + a[y]) & 255
        else:
            row = a[y].tolist()
            p = prev.tolist()
            left = top_left = p[0]
            res = []
            for x in range(w):
                top = p[x]
                g = left + top - top_left
                g = g if 0 <= g <= 255 else (0 if g < 0 else 255)
                left = (row[x] + g) & 255
                top_left = top
                res.append(left)
            out[y] = res
    return out.astype(np.uint8)


def _alpha(chunk: bytes, w: int, h: int, name: str) -> np.ndarray:
    head = chunk[0]
    comp, filt = head & 3, (head >> 2) & 3
    if head >> 6 or comp > 1:
        raise ValueError(f"{name}: WebP ALPH chunk with an invalid header")
    if comp == 0:
        if len(chunk) - 1 < w * h:
            raise ValueError(f"{name}: truncated WebP ALPH chunk")
        a = np.frombuffer(chunk, np.uint8, w * h, 1).reshape(h, w)
    else:
        try:
            a = ((vp8l.decode_image_stream(chunk, 1, w, h) >> 8) & 255).astype(np.uint8)
        except ValueError as e:
            raise ValueError(f"{name}: WebP alpha: {e}") from None
    return _unfilter_alpha(a, filt) if filt else a


def decode_webp(src: Source, name: Optional[str] = None) -> WebP:
    """The file's pixels in Pillow's mode (see WebP)."""
    data, name = read_source(src, name)
    ch = _chunks(data, name)
    if b"ANIM" in ch or b"ANMF" in ch:
        raise ValueError(f"{name}: animated WebP is not supported (still images only)")
    alpha_flag = False
    if b"VP8X" in ch:
        alpha_flag = bool(ch[b"VP8X"][0] & 0x10)
        if ch[b"VP8X"][0] & 0x02:
            raise ValueError(f"{name}: animated WebP is not supported (still images only)")
    try:
        if b"VP8L" in ch:
            argb = vp8l.decode_vp8l(ch[b"VP8L"])
            has_alpha = alpha_flag or vp8l.vp8l_header(ch[b"VP8L"])[2]
            px = np.stack([(argb >> 16) & 255, (argb >> 8) & 255, argb & 255, argb >> 24],
                          -1).astype(np.uint8)
            return WebP("RGBA", px) if has_alpha else WebP("RGB", np.ascontiguousarray(
                px[..., :3]))
        if b"VP8 " not in ch:
            raise ValueError("no image chunk")
        y, u, v = vp8.decode_vp8(ch[b"VP8 "])
    except ValueError as e:
        raise ValueError(f"{name}: WebP: {e}") from None
    h, w = y.shape
    rgb = yuv_to_rgb(y, upsample(u, h, w), upsample(v, h, w))
    if b"ALPH" in ch:
        a = _alpha(ch[b"ALPH"], w, h, name)
        return WebP("RGBA", np.concatenate([rgb, a[..., None]], -1))
    if alpha_flag:
        return WebP("RGBA", np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1))
    return WebP("RGB", rgb)


def pil_rgb(webp: WebP, composite: bool = True) -> np.ndarray:
    """(H, W, 3) uint8: Image.open(f).convert("RGB"), RGBA first composited
    onto white when `composite` (gd3d's _to_pil), its alpha dropped
    otherwise."""
    from gd3d_torch.data.png import _composite_on_white

    p = webp.pixels
    if webp.mode == "RGBA" and composite:
        return _composite_on_white(p[..., :3], p[..., 3])
    return np.ascontiguousarray(p[..., :3])
