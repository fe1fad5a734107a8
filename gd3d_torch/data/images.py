"""Teacher-format image loading (counterpart of gd3d/data/images.py),
without PIL: JPEG, PNG, BMP and WebP decoded by gd3d_torch/data/{jpeg,png,
bmp,webp}.py (dispatched on their magic bytes), EXIF orientation by
data/exif.py, PIL's Lanczos and bicubic resizes by
data/resample.py. Every function gives gd3d's arrays for the same file.

  - `load_image_mast3r`: dust3r's load_images (long side -> `size`, Lanczos
    when it shrinks and bicubic when it grows, centre crop to /16 halves, a
    3:4 crop of square inputs unless square_ok; the 224 branch a centre
    square), [-1, 1] float32 and true_shape;
  - `load_images_vggt`: VGGT's load_and_preprocess_images, "crop" (width
    518, height rounded to /14, centre-cropped to <= 518) or "pad" (long
    side 518, padded with 1.0 to 518^2), [0, 1] float32.

A path is opened as gd3d's `_to_pil` opens it: EXIF-transposed, RGBA
composited onto white, converted to RGB (`open_rgb`). A uint8 array is taken
as an RGB image that is already open; other arrays are clipped to [0, 1]
and scaled to uint8 first, as gd3d does.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from gd3d_torch.data import bmp, exif, png, webp
from gd3d_torch.data.jpeg import decode_jpeg, jpeg_size
from gd3d_torch.data.resample import resize_bicubic, resize_lanczos
from gd3d_torch.data.source import read_source

ImageLike = Union[str, os.PathLike, np.ndarray]


def read_bytes(path) -> bytes:
    return read_source(path)[0]


def decode_rgb(data: bytes, name: str = "<bytes>", composite: bool = True) -> np.ndarray:
    """A JPEG's, PNG's, BMP's or WebP's pixels as PIL's
    Image.open(f).convert("RGB") gives them, RGBA first composited onto
    white (gd3d's _to_pil) unless `composite` is False, before any EXIF
    transpose."""
    if data[:8] == png.SIGNATURE:
        return png.pil_rgb(png.decode_png(data, name), composite)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, name)
    if data[:2] == b"BM":
        return bmp.pil_rgb(bmp.decode_bmp(data, name), composite)
    if webp.is_webp(data):
        return webp.pil_rgb(webp.decode_webp(data, name), composite)
    raise ValueError(f"{name}: not a JPEG, PNG, BMP or WebP file")


def image_size(path) -> Tuple[int, int]:
    """(width, height) from the file's header, as PIL's Image.open(f).size,
    for JPEG, PNG, BMP and WebP; a ValueError naming the file otherwise."""
    data, name = read_source(path)
    if data[:8] == png.SIGNATURE:
        ihdr = next((p for kind, p in png.chunks(data, name) if kind == b"IHDR"), b"")
        if len(ihdr) < 8:
            raise ValueError(f"{name}: PNG without an IHDR chunk")
        return int.from_bytes(ihdr[:4], "big"), int.from_bytes(ihdr[4:8], "big")
    if data[:2] == b"\xff\xd8":
        return jpeg_size(data, name)
    if data[:2] == b"BM":
        return bmp.bmp_size(data, name)
    if webp.is_webp(data):
        return webp.webp_size(data, name)
    raise ValueError(f"{name}: not a JPEG, PNG, BMP or WebP file")


def file_orientation(data: bytes) -> int:
    """The EXIF orientation of a JPEG (APP1), PNG (eXIf) or WebP (EXIF
    chunk), 1 without one (and for BMP, which has no EXIF)."""
    if data[:8] == png.SIGNATURE:
        return exif.orientation(next(
            (p for kind, p in png.chunks(data, "<bytes>") if kind == b"eXIf"), None))
    if data[:2] == b"\xff\xd8":
        return exif.orientation(exif.jpeg_exif(data))
    if webp.is_webp(data):
        return exif.orientation(webp.exif_bytes(data))
    return 1


def open_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8: gd3d's _to_pil(path) as an array (EXIF transpose,
    RGBA onto white, RGB)."""
    data = read_bytes(path)
    return exif.transpose(decode_rgb(data, os.fspath(path)), file_orientation(data))


def _to_rgb(img: ImageLike) -> np.ndarray:
    if isinstance(img, (str, os.PathLike)):
        return open_rgb(img)
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return arr


def _resize_long_edge(img: np.ndarray, long_edge: int) -> np.ndarray:
    """dust3r's _resize_pil_image: Lanczos when it shrinks, bicubic else."""
    h, w = img.shape[:2]
    s = max(w, h)
    size = tuple(int(round(x * long_edge / s)) for x in (w, h))
    return (resize_lanczos if s > long_edge else resize_bicubic)(img, size)


def u8_to_f32_norm(img: np.ndarray, mean, std) -> np.ndarray:
    """(..., C) uint8 -> float32 (u8 * (1/255) - mean) / std, in float32 as
    gd3d's native host runtime computes it (gd3d_u8_to_f32_norm)."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (img.astype(np.float32) * np.float32(1.0 / 255.0) - mean) / std


def load_image_mast3r(img: ImageLike, size: int = 512,
                      square_ok: bool = False) -> Dict[str, np.ndarray]:
    """One image -> {'img': (H, W, 3) float32 in [-1, 1], 'true_shape': (2,)}."""
    im = _to_rgb(img)
    if size == 224:
        h, w = im.shape[:2]
        im = _resize_long_edge(im, round(size * max(w, h) / min(w, h)))
    else:
        im = _resize_long_edge(im, size)
    h, w = im.shape[:2]
    cx, cy = w // 2, h // 2
    if size == 224:
        half = min(cx, cy)
        im = im[cy - half:cy + half, cx - half:cx + half]
    else:
        halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
        if not square_ok and w == h:
            halfh = int(3 * halfw / 4)
        im = im[cy - halfh:cy + halfh, cx - halfw:cx + halfw]
    return {"img": u8_to_f32_norm(im, (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
            "true_shape": np.int32([im.shape[0], im.shape[1]])}


def load_images_vggt(imgs: Sequence[ImageLike], mode: str = "crop",
                     target_size: int = 518) -> np.ndarray:
    """Images -> (S, H, W, 3) float32 in [0, 1], width 518, height /14."""
    assert mode in ("crop", "pad")
    out: List[np.ndarray] = []
    shapes = set()
    for img in imgs:
        im = _to_rgb(img)
        height, width = im.shape[:2]
        if mode == "pad" and width < height:
            new_h = target_size
            new_w = round(width * (new_h / height) / 14) * 14
        else:
            new_w = target_size
            new_h = round(height * (new_w / width) / 14) * 14
        arr = u8_to_f32_norm(resize_bicubic(im, (new_w, new_h)), (0.0, 0.0, 0.0),
                             (1.0, 1.0, 1.0))
        if mode == "crop" and new_h > target_size:
            start = (new_h - target_size) // 2
            arr = arr[start:start + target_size]
        if mode == "pad":
            hp = target_size - arr.shape[0]
            wp = target_size - arr.shape[1]
            arr = np.pad(arr, ((hp // 2, hp - hp // 2), (wp // 2, wp - wp // 2), (0, 0)),
                         constant_values=1.0)
        shapes.add(arr.shape[:2])
        out.append(arr)
    assert len(shapes) == 1, f"inconsistent shapes {shapes}"
    return np.stack(out)
