"""PIL's Lanczos and bicubic resizes of 8-bit images, without PIL.

gd3d's eval resizes with `Image.resize((w, h), Image.LANCZOS)` (PF-PASCAL
canvases, DAVIS frames), and its training images with LANCZOS or BICUBIC
(gd3d/data/images.py, gd3d/data/scannetpp.py::_square_rgb, BICUBIC being
Pillow's default). `resize_lanczos` and `resize_bicubic` give Pillow's
bytes: a transcription of Pillow's libImaging/Resample.c for 8 bits a
channel.

  * `precompute_coeffs`: for each output sample, the filter's window
    (Lanczos-3, sinc(x) sinc(x/3) on [-3, 3); bicubic, Keys' cubic with
    a = -0.5 on [-2, 2]) centred at in0 + (x + 0.5) * scale, stretched by
    the scale when it shrinks, clipped to the image, and normalised to sum 1
    in float64;
  * `normalize_coeffs_8bpc`: the weights rounded half away from zero to 22
    fractional bits (PRECISION_BITS = 32 - 8 - 2);
  * the horizontal pass first (where the width changes), then the vertical
    one (where the height changes), each summing from 2^21, shifting right
    by 22 and clipping to [0, 255]; a resize to the same size is a copy, as
    Pillow's Image.resize returns one.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2
SUPPORT = 3.0  # Lanczos-3


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


FILTERS = {"lanczos": (_lanczos, SUPPORT), "bicubic": (_bicubic, 2.0)}


def lanczos_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first input index (out,), int64 weights (out, ksize) in 22-bit fixed
    point, zero past each window) of a Lanczos resize of `in_size` samples
    to `out_size` over the whole input (box 0..in_size)."""
    return coeffs(in_size, out_size, "lanczos")


@functools.lru_cache(maxsize=64)
def coeffs(in_size: int, out_size: int, kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """lanczos_coeffs for the filter `kind` ("lanczos" or "bicubic")."""
    kernel, base_support = FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [kernel((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:  # in order, as the C loop (not sum(): it compensates)
            ww += v
        if ww != 0.0:
            k = [v / ww for v in k]
        for x, v in enumerate(k):
            weights[xx, x] = (int(-0.5 + v * (1 << PRECISION_BITS)) if v < 0
                              else int(0.5 + v * (1 << PRECISION_BITS)))
        first[xx] = xmin
    return first, weights


def _pass(img: np.ndarray, out_size: int, axis: int, kind: str) -> np.ndarray:
    """One 8-bit pass along `axis` of a uint8 (H, W, C) or (H, W) array, in
    int32 as Pillow sums (8-bit samples times 22-bit weights stay below
    2^31)."""
    first, weights = coeffs(img.shape[axis], out_size, kind)
    src = img.astype(np.int32)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int32)
    for j in range(weights.shape[1]):
        idx = np.minimum(first + j, img.shape[axis] - 1)  # past a window the weight is 0
        acc += weights[:, j].astype(np.int32).reshape(shape) * np.take(src, idx, axis=axis)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size: Tuple[int, int], kind: str) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> uint8 at size = (width, height), PIL's
    np.asarray(Image.fromarray(img).resize(size, filter)) for the filter
    `kind` ("lanczos" or "bicubic")."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize takes uint8 images, got {img.dtype}")
    w, h = size
    if w <= 0 or h <= 0:
        raise ValueError(f"resize: bad size {size}")
    out = img
    if w != img.shape[1]:
        out = _pass(out, w, 1, kind)
    if h != img.shape[0]:
        out = _pass(out, h, 0, kind)
    return out if out is not img else img.copy()


def resize_lanczos(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """resize(img, size, "lanczos"): Image.LANCZOS."""
    return resize(img, size, "lanczos")


def resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """resize(img, size, "bicubic"): Image.BICUBIC, Image.resize's default."""
    return resize(img, size, "bicubic")
