"""Miscellaneous utilities (counterpart of gd3d/utils/misc.py), in numpy:
no PIL and no PyYAML, whose results they reproduce.

  * `parse_yaml`: yaml.safe_load of a file, through the port's YAML reader
    (core/yaml_reader.py), which raises on what it does not read;
  * `rotation_angle_from_matrix`: gd3d's numpy;
  * `resize_crop`: PIL's Image.fromarray(img).crop(box).resize((s, s)) of a
    uint8 RGB or grey image: `getbbox` as Pillow's (the box of the non-zero
    pixels), the float box rounded as Python's round (half to even), the
    region outside the image zero, then Pillow's bicubic filter, the
    default of Image.resize (data/resample.py, byte for byte).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gd3d_torch.core.yaml_reader import read_yaml
from gd3d_torch.data.resample import resize_bicubic


def parse_yaml(file_path: str):
    return read_yaml(file_path)


def rotation_angle_from_matrix(R) -> float:
    """Geodesic rotation angle (radians) from a 3x3 rotation matrix."""
    trace = float(np.trace(np.asarray(R)))
    return float(np.arccos(np.clip((trace - 1.0) / 2.0, -1.0, 1.0)))


def getbbox(img: np.ndarray) -> Optional[Tuple[int, int, int, int]]:
    """PIL's Image.getbbox() of a uint8 RGB or grey array: (left, upper,
    right, lower) of the pixels with a non-zero band, right and lower
    exclusive; None for an all-zero image."""
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


def resize_crop(
    img: np.ndarray,
    padding: float = 0.2,
    out_size: int = 224,
    bbox: Optional[Tuple[int, int, int, int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bbox-centered square crop+resize with the 3x3 pixel transform, as
    gd3d's (through PIL there). Takes uint8 (H, W, 3) and (H, W) images,
    the modes whose bicubic resize Pillow does not premultiply."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"resize_crop takes uint8 RGB or grey images, got {img.dtype} "
                         f"{img.shape}")
    if bbox is None:
        bbox = getbbox(img)
        if bbox is None:
            raise ValueError("resize_crop: the image is all zero, so it has no bounding box")
    width = bbox[2] - bbox[0]
    height = bbox[3] - bbox[1]
    size = max(height, width) * (1 + padding)
    center = ((bbox[2] + bbox[0]) / 2, (bbox[3] + bbox[1]) / 2)
    left = center[0] - size / 2
    top = center[1] - size / 2
    cropped = resize_bicubic(crop(img, (left, top, left + size, top + size)),
                             (out_size, out_size))
    transform = (
        np.array([[1, 0, center[0]], [0, 1, center[1]], [0, 0, 1.0]])
        @ np.array([[size / out_size, 0, 0], [0, size / out_size, 0], [0, 0, 1]])
        @ np.array([[1, 0, -out_size / 2], [0, 1, -out_size / 2], [0, 0, 1.0]])
    )
    return cropped, transform
