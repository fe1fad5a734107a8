"""Miscellaneous utilities (counterpart of gd3d/utils/misc.py), in numpy:
no PIL and no PyYAML, whose results they reproduce.

  * `parse_yaml`: yaml.safe_load of a file, through the port's YAML reader
    (core/yaml_reader.py), which raises on what it does not read;
  * `rotation_angle_from_matrix`: gd3d's numpy;
  * `resize_crop`: PIL's Image.fromarray(img).crop(box).resize((s, s)) of
    every array Image.fromarray takes (`pil_mode`): `getbbox` as Pillow's
    (the box of the non-zero pixels, of the alpha for RGBA and LA), the
    float box rounded as Python's round (half to even), the region outside
    the image zero, then Image.resize's default: the bicubic filter
    (data/resample.py, byte for byte; RGBA and LA premultiplied around it,
    F, I and I;16 in Pillow's 32- and 16-bit resamplers), NEAREST for mode
    1.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gd3d_torch.core.yaml_reader import read_yaml
from gd3d_torch.data.resample import resize_bicubic, resize_nearest_pil, resize_wide


def parse_yaml(file_path: str):
    return read_yaml(file_path)


def rotation_angle_from_matrix(R) -> float:
    """Geodesic rotation angle (radians) from a 3x3 rotation matrix."""
    trace = float(np.trace(np.asarray(R)))
    return float(np.arccos(np.clip((trace - 1.0) / 2.0, -1.0, 1.0)))


def pil_mode(img: np.ndarray) -> Tuple[str, np.ndarray]:
    """(the mode of PIL's Image.fromarray(img), the pixels as that mode keeps
    them): uint8 grey, grey-alpha, RGB and RGBA (L, LA, RGB, RGBA), bool
    (1), int16, int32 and uint32 (I, as int32; uint32 wraps), uint16 in
    either byte order (I;16, I;16B, as stored), float32 and float64 (F, as
    float32). Pillow refuses the rest: so does this."""
    img = np.asarray(img)
    kind, size = img.dtype.kind, img.dtype.itemsize
    if kind == "u" and size == 1:
        modes = {2: "L", 3: {2: "LA", 3: "RGB", 4: "RGBA"}.get(img.shape[-1])}
        mode = modes.get(img.ndim)
        if mode:
            return mode, img
    elif img.ndim == 2:
        if kind == "b":
            return "1", img
        if kind == "i" and size in (2, 4):
            return "I", img.astype(np.int32)
        if kind == "u" and size == 4:
            return "I", img.astype(img.dtype.newbyteorder("=")).view(np.int32)
        if kind == "u" and size == 2:
            return ("I;16B" if img.dtype.byteorder == ">" else "I;16"), img
        if kind == "f" and size in (4, 8):
            return "F", img.astype(np.float32)
    raise ValueError(f"resize_crop: Pillow's Image.fromarray cannot handle {img.dtype} "
                     f"{img.shape}")


def getbbox(img: np.ndarray, mode: str) -> Optional[Tuple[int, int, int, int]]:
    """PIL's Image.getbbox() of an image in `mode` (pil_mode's): (left,
    upper, right, lower) of the pixels whose stored
    bits are not zero (any band; for RGBA and LA the alpha alone, float
    -0.0 counted), right and lower exclusive; for I;16 modes the first
    width bytes of each row, as Pillow's byte-wise scan reads them; None
    where nothing is set."""
    if mode in ("RGBA", "LA"):
        nz = img[..., -1] != 0
    elif mode.startswith("I;16"):
        nz = img.view(np.uint8).reshape(img.shape[0], -1)[:, :img.shape[1]] != 0
    elif mode == "F":
        nz = img.view(np.int32) != 0
    else:
        nz = img.any(axis=2) if img.ndim == 3 else img != 0
    rows, cols = np.flatnonzero(nz.any(axis=1)), np.flatnonzero(nz.any(axis=0))
    if rows.size == 0:
        return None
    return int(cols[0]), int(rows[0]), int(cols[-1]) + 1, int(rows[-1]) + 1


def crop(img: np.ndarray, box) -> np.ndarray:
    """PIL's Image.crop(box) of an array: the float box rounded half to even
    (Python's round), the part outside the image zero."""
    x0, y0, x1, y1 = (int(round(v)) for v in box)
    out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)) + img.shape[2:], img.dtype)
    H, W = img.shape[:2]
    sy0, sy1, sx0, sx1 = max(y0, 0), min(y1, H), max(x0, 0), min(x1, W)
    if sy1 > sy0 and sx1 > sx0:
        out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return out


def _premultiply(px: np.ndarray) -> np.ndarray:
    """Pillow's RGBA -> RGBa (and LA -> La): each colour band times alpha,
    MULDIV255 ((c a + 128) + ((c a + 128) >> 8)) >> 8."""
    a = px[..., -1:].astype(np.int64)
    t = px[..., :-1].astype(np.int64) * a + 128
    return np.concatenate([((t >> 8) + t) >> 8, a], -1).astype(np.uint8)


def _unpremultiply(px: np.ndarray) -> np.ndarray:
    """Pillow's RGBa -> RGBA: each colour band CLIP8(255 c / alpha), as it
    is where alpha is 0 or 255."""
    a = px[..., -1:].astype(np.int64)
    c = px[..., :-1].astype(np.int64)
    div = np.clip(255 * c // np.maximum(a, 1), 0, 255)
    c = np.where((a == 0) | (a == 255), c, div)
    return np.concatenate([c, a], -1).astype(np.uint8)


def pil_resize(img: np.ndarray, mode: str, size: Tuple[int, int]) -> np.ndarray:
    """np.array(Image.fromarray(img).resize(size)) for an image in `mode`:
    the same size is a copy; 1 resizes by NEAREST; RGBA and LA go through
    their premultiplied modes with the 8-bit bicubic filter; L and RGB take
    that filter as they are; F, I and I;16 Pillow's 32-bit and 16-bit
    resamplers (I;16B's bytes read as little-endian, as Pillow does on a
    little-endian machine)."""
    if img.shape[1::-1] == tuple(size):
        return img.copy()
    if mode == "1":
        return resize_nearest_pil(img.astype(np.uint8) * 255, size) != 0
    if mode in ("RGBA", "LA"):
        return _unpremultiply(resize_bicubic(_premultiply(img), size))
    if mode in ("L", "RGB"):
        return resize_bicubic(img, size)
    if mode == "I;16B":
        return resize_wide(img.view("<u2"), size).view(">u2")
    return resize_wide(img, size)


def resize_crop(
    img: np.ndarray,
    padding: float = 0.2,
    out_size: int = 224,
    bbox: Optional[Tuple[int, int, int, int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bbox-centered square crop+resize with the 3x3 pixel transform, as
    gd3d's (through PIL there), for every array Image.fromarray takes
    (pil_mode)."""
    mode, img = pil_mode(img)
    if bbox is None:
        bbox = getbbox(img, mode)
        if bbox is None:
            raise ValueError("resize_crop: the image is all zero, so it has no bounding box")
    width = bbox[2] - bbox[0]
    height = bbox[3] - bbox[1]
    size = max(height, width) * (1 + padding)
    center = ((bbox[2] + bbox[0]) / 2, (bbox[3] + bbox[1]) / 2)
    left = center[0] - size / 2
    top = center[1] - size / 2
    cropped = pil_resize(crop(img, (left, top, left + size, top + size)), mode,
                         (out_size, out_size))
    transform = (
        np.array([[1, 0, center[0]], [0, 1, center[1]], [0, 0, 1.0]])
        @ np.array([[size / out_size, 0, 0], [0, size / out_size, 0], [0, 0, 1]])
        @ np.array([[1, 0, -out_size / 2], [0, 1, -out_size / 2], [0, 0, 1.0]])
    )
    return cropped, transform
