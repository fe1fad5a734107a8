"""PIL's Lanczos, bicubic, bilinear and nearest resizes, without PIL, and
cv2's bilinear resize of float64 images and nearest resize, without cv2.

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

gd3d's OnePose descriptors resize a float64 frame with `cv2.resize`
(INTER_LINEAR). `resize_linear_cv` gives OpenCV 5's bits: the source
coordinate fma(d + 0.5, in / out, -0.5), the taps clamped at the borders,
each sample fma(b - a, frac, a), rows first. numpy has no fused multiply-add,
so `fma64` emulates one exactly; it also runs on torch tensors, so that the
eval resizes on the card.
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


def _bilinear(x: float) -> float:
    if x < 0.0:
        x = -x
    if x < 1.0:
        return 1.0 - x
    return 0.0


FILTERS = {"lanczos": (_lanczos, SUPPORT), "bicubic": (_bicubic, 2.0),
           "bilinear": (_bilinear, 1.0)}


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


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """resize(img, size, "bilinear"): Image.BILINEAR, the triangle filter."""
    return resize(img, size, "bilinear")


def resize_nearest_pil(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Image.fromarray(img).resize(size, Image.NEAREST) for uint8 (L, RGB)
    and uint16 (I;16) arrays, size = (width, height). Pillow maps output
    pixel x to the source index int(x0 + s / 2 + x s) for s = in / out: for
    8-bit modes its ImagingScaleAffine adds s to the running coordinate
    once a pixel (float64, in that order), for I;16 (a "special" mode) its
    generic transform takes int(s (x + 0.5)) directly."""
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"resize_nearest_pil takes uint8 or uint16 images, got {img.dtype}")
    w, h = size

    def index(n_in, n_out):
        s = n_in / n_out
        if img.dtype == np.uint16:
            src = (s * (np.arange(n_out) + 0.5)).astype(np.int64)
        else:
            steps = np.full(n_out, s)
            steps[0] = 0.0 + s * 0.5
            src = np.cumsum(steps).astype(np.int64)  # np.cumsum adds in order
        return np.minimum(src, n_in - 1)

    return img[index(img.shape[0], h)[:, None], index(img.shape[1], w)[None, :]]


def resize_nearest_cv(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size, interpolation=cv2.INTER_NEAREST), size =
    (width, height): source index floor(x / (out / in)), the scale's
    reciprocal taken of the rounded out / in as OpenCV's resizeNN does,
    clipped to the last pixel."""
    w, h = int(size[0]), int(size[1])

    def index(n_in, n_out):
        inv = 1.0 / (n_out / n_in)
        return np.minimum(np.floor(np.arange(n_out) * inv).astype(np.int64), n_in - 1)

    return img[index(img.shape[0], h)[:, None], index(img.shape[1], w)[None, :]]



def resize_nearest_exact_cv(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size, interpolation=cv2.INTER_NEAREST_EXACT), size =
    (width, height), as OpenCV 5.0.0 computes it: the source index of
    output pixel x is int(s / 2 + s + ... + s) for s = in / out, the
    running coordinate a float64 sum in order (Pillow's NEAREST rule for
    8-bit images), clipped to the last pixel. Any dtype and channel count.
    Not INTER_NEAREST (resize_nearest_cv), which floors x in / out."""
    w, h = int(size[0]), int(size[1])

    def index(n_in, n_out):
        s = n_in / n_out
        steps = np.full(n_out, s)
        steps[0] = 0.0 + s * 0.5
        return np.minimum(np.cumsum(steps).astype(np.int64), n_in - 1)

    return img[index(img.shape[0], h)[:, None], index(img.shape[1], w)[None, :]]


# ------------------------------------------------- cv2.resize, INTER_LINEAR
_SPLIT = 134217729.0  # 2^27 + 1, Veltkamp's splitter for doubles


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    p = a * b
    ca, cb = _SPLIT * a, _SPLIT * b
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma64(a, b, c):
    """a * b + c in float64 with one rounding (std::fma), for finite values
    far from overflow: the exact product as two doubles, its exact sum with
    c, the low parts added rounding to odd, then one rounding to nearest
    (Boldo and Melquiond's emulation). numpy arrays, or torch tensors on any
    device, where each operation is its own exactly rounded kernel."""
    if any(type(x).__module__.startswith("torch") for x in (a, b, c)):
        import torch

        dev = next(x.device for x in (a, b, c) if isinstance(x, torch.Tensor))
        a, b, c = torch.broadcast_tensors(*(torch.as_tensor(x, dtype=torch.float64, device=dev)
                                            for x in (a, b, c)))
        where, nextafter, bits = torch.where, torch.nextafter, lambda v: v.view(torch.int64)
        inf = torch.tensor(np.inf, dtype=torch.float64, device=dev)
    else:
        a, b, c = np.broadcast_arrays(*(np.asarray(x, np.float64) for x in (a, b, c)))
        where, nextafter, bits, inf = np.where, np.nextafter, lambda v: v.view(np.int64), np.inf
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, e = _two_sum(tl, ul)
    inexact_even = (e != 0) & ((bits(v) & 1) == 0)
    v = where(inexact_even, nextafter(v, where(e > 0, inf, -inf)), v)
    return th + v


def linear_taps_cv(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv::resize's INTER_LINEAR taps along one axis for float64 images: the
    source coordinate fma(d + 0.5, in / out, -0.5), its floor and the next
    index (clamped), and the fraction, 0 where the floor lies left of the
    image or on its last sample."""
    f = fma64(np.arange(out_size) + 0.5, in_size / out_size, -0.5)
    s = np.floor(f)
    frac = np.where((s < 0) | (s >= in_size - 1), 0.0, f - s)
    s = np.clip(s.astype(np.int64), 0, in_size - 1)
    return s, np.minimum(s + 1, in_size - 1), frac


def resize_linear_cv(img, size: Tuple[int, int]):
    """cv2.resize(img, size) (INTER_LINEAR) of a float64 (H, W) or (H, W, C)
    image, size = (width, height), as OpenCV 5's CPU path computes it: each
    row first, then the rows, every sample fma(b - a, frac, a) of its two
    taps. `img` is a numpy array or a torch tensor (then computed on its
    device, to the same bits). A C = 1 image keeps its channel axis (cv2
    drops it)."""
    is_torch = type(img).__module__.startswith("torch")
    if str(img.dtype) not in ("float64", "torch.float64"):
        raise ValueError(f"resize_linear_cv takes float64 images, got {img.dtype}")
    w, h = size
    if w <= 0 or h <= 0:
        raise ValueError(f"resize_linear_cv: bad size {size}")
    extra = (None,) * (img.ndim - 2)
    x0, x1, fx = linear_taps_cv(img.shape[1], w)
    y0, y1, fy = linear_taps_cv(img.shape[0], h)
    if is_torch:
        import torch

        x0, x1, fx, y0, y1, fy = (torch.from_numpy(t).to(img.device) for t in (x0, x1, fx, y0, y1, fy))
    rows = fma64(img[:, x1] - img[:, x0], fx[(None, slice(None)) + extra], img[:, x0])
    return fma64(rows[y1] - rows[y0], fy[(slice(None), None) + extra], rows[y0])
