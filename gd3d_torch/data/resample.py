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

The augmentors' and the debug dumps' cv2.resize of uint8 and float32 images
is `resize_cv` (the caller's scale, as gd3d's augmentors call it) and
`resize_linear_f32` (the caller's size, as gd3d's vis_attn_map calls it),
OpenCV 5.0.0's bits, each route found against cv2 on the CPU:

  * uint8 images and 2-channel float32 ones go through OpenCV's own code:
    float32 taps, 11-bit fixed point for uint8, float32 products and sums
    for the flow; at fx = fy = 0.5 OpenCV takes INTER_AREA (`_halve_area`);
  * 1-, 3- and 4-channel float32 images, halving included, are computed as
    fma(b - a, t, a), rows first (`fma32` emulates std::fmaf exactly);
    given a scale, the taps are OpenCV 5's (`_taps_by_scale`: the floor
    clamped to [0, n - 2], the fraction to [0, 1]); given a size, OpenCV
    hands the resize to Intel IPP, whose taps copy the edge samples
    (`_taps_by_size`). Sides under 4 samples, and enlargements of 3- and
    4-channel images by size, take other paths of those libraries and raise.
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
def coeffs_float(in_size: int, out_size: int, kind: str):
    """Pillow's precompute_coeffs: (first input index (out,), float64 weights
    (out, ksize) normalised to sum 1, zero past each window, the window's
    tap count (out,))."""
    kernel, base_support = FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    taps = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
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
        weights[xx, :xmax] = k
        first[xx], taps[xx] = xmin, xmax
    return first, weights, taps


@functools.lru_cache(maxsize=64)
def coeffs(in_size: int, out_size: int, kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """lanczos_coeffs for the filter `kind` ("lanczos" or "bicubic"): the
    weights of coeffs_float rounded half away from zero to PRECISION_BITS."""
    first, k, _ = coeffs_float(in_size, out_size, kind)
    scaled = k * (1 << PRECISION_BITS)
    weights = np.where(k < 0, (-0.5 + scaled).astype(np.int64), (0.5 + scaled).astype(np.int64))
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


def _round_up(ss: np.ndarray) -> np.ndarray:
    """Resample.c's ROUND_UP: (int)(f + 0.5) or (int)(f - 0.5), truncated;
    past the int range (and NaN) x86's conversion gives INT_MIN."""
    v = np.trunc(np.where(ss >= 0.0, ss + 0.5, ss - 0.5))
    bad = ~((v >= -2.0 ** 31) & (v < 2.0 ** 31))
    return np.where(bad, -2 ** 31, np.where(bad, 0, v).astype(np.int64))


def _pass_wide(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 32-bit and 16-bit resamplers (ImagingResample*_
    32bpc, _16bpc) along `axis` of a 2-d image: each sample the float64 sum,
    in order, of the window's taps times the float64 weights; float32 ("F")
    stores the sum as it is, int32 ("I") rounds it (ROUND_UP), uint16
    ("I;16") rounds it and keeps CLIP8(v % 256) and CLIP8(v >> 8) as its low
    and high bytes."""
    first, weights, taps = coeffs_float(img.shape[axis], out_size, "bicubic")
    src = img.astype(np.float64)
    shape = [1, 1]
    shape[axis] = out_size
    ss = np.zeros(img.shape[:axis] + (out_size,) + img.shape[axis + 1:], np.float64)
    for j in range(weights.shape[1]):
        idx = np.minimum(first + j, img.shape[axis] - 1)
        term = weights[:, j].reshape(shape) * np.take(src, idx, axis=axis)
        ss = np.where((j < taps).reshape(shape), ss + term, ss)
    if img.dtype == np.float32:
        return ss.astype(np.float32)
    v = _round_up(ss)
    if img.dtype == np.int32:
        return v.astype(np.int32)
    lo = np.clip(np.fmod(v, 256), 0, 255)  # C's %: the sign of v
    hi = np.clip(v >> 8, 0, 255)
    return (lo + (hi << 8)).astype(np.uint16)


def resize_wide(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's bicubic resize (Image.resize's default) of a 2-d float32 ("F"),
    int32 ("I") or little-endian uint16 ("I;16") image to size = (width,
    height): the horizontal pass
    where the width changes, then the vertical one."""
    if img.dtype not in (np.float32, np.int32, np.uint16) or img.ndim != 2:
        raise ValueError(f"resize_wide takes 2-d float32, int32 or uint16 images, got "
                         f"{img.dtype} {img.shape}")
    w, h = size
    out = img
    if w != img.shape[1]:
        out = _pass_wide(out, w, 1)
    if h != img.shape[0]:
        out = _pass_wide(out, h, 0)
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


# ------------------------------- cv2.resize of uint8 and float32 images
_COEF_BITS = 11  # INTER_RESIZE_COEF_BITS
# The least input and output size along an axis that OpenCV 5's float32
# INTER_LINEAR route takes as `resize_cv` computes it; narrower images go
# through paths of OpenCV's that differ from it and from each other.
MIN_LINEAR_F32 = 4


def fma32(a, b, c) -> np.ndarray:
    """a * b + c for float32 values with one rounding to float32 (std::fmaf):
    the product is exact in float64 (24 + 24 bits), its sum with c exact as
    two doubles, the double rounded to odd and then to float32, which gives
    the correctly rounded result (Boldo and Melquiond). Non-finite sums pass
    through."""
    a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    to_odd = (e != 0) & ((s.view(np.int64) & 1) == 0) & np.isfinite(s)
    return np.where(to_odd, np.nextafter(s, np.where(e > 0, np.inf, -np.inf)), s).astype(np.float32)


def _taps_classic(in_size: int, out_size: int, inv_scale: float, clamp_weights: bool):
    """OpenCV's INTER_LINEAR taps along one axis for uint8 and 2-channel
    float32 images: the float32 source coordinate, its floor and the next
    index (clamped), and the two float32 weights; at the borders the
    horizontal weights become (1, 0) on the edge sample (clamp_weights), the
    vertical ones stay."""
    fx = ((np.arange(out_size) + 0.5) * (1.0 / inv_scale) - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        edge = (sx < 0) | (sx >= in_size - 1)
        fx = np.where(edge, np.float32(0), fx)
        sx = np.where(sx < 0, 0, np.where(sx >= in_size - 1, in_size - 1, sx))
    w0 = (np.float32(1) - fx).astype(np.float32)
    return np.clip(sx, 0, in_size - 1), np.clip(sx + 1, 0, in_size - 1), w0, fx


def _taps_by_scale(in_size: int, out_size: int, inv: float):
    """OpenCV 5's float32 INTER_LINEAR taps when the caller gives the scale
    (fx, fy): the float64 source coordinate (d + 0.5) / scale - 0.5, its
    floor clamped to [0, in - 2] and the fraction from there clamped to
    [0, 1] (so the last samples interpolate with weight 1 instead of
    copying), as float32."""
    f = (np.arange(out_size) + 0.5) * inv - 0.5
    s = np.clip(np.floor(f), 0, in_size - 2)
    return s.astype(np.int64), s.astype(np.int64) + 1, np.clip(f - s, 0.0, 1.0).astype(np.float32)


def _taps_by_size(in_size: int, out_size: int):
    """The float32 INTER_LINEAR taps when the caller gives the size (OpenCV
    hands such resizes to Intel IPP): the float64 source coordinate
    (d + 0.5) in / out - 0.5, its floor and the next index clamped to the
    image, and the fraction, 0 where the floor lies left of the image or on
    its last sample."""
    f = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    s = np.floor(f)
    frac = np.where((s < 0) | (s >= in_size - 1), 0.0, f - s).astype(np.float32)
    s = np.clip(s.astype(np.int64), 0, in_size - 1)
    return s, np.minimum(s + 1, in_size - 1), frac


def _lerp_f32(img: np.ndarray, taps_x, taps_y) -> np.ndarray:
    """Each row first, then the rows, every sample fma(b - a, t, a) of its
    two taps in float32."""
    (x0, x1, tx), (y0, y1, ty) = taps_x, taps_y
    ex = (slice(None),) + (None,) * (img.ndim - 2)
    ey = (slice(None), None) + (None,) * (img.ndim - 2)
    rows = fma32(img[:, x1] - img[:, x0], tx[ex], img[:, x0])
    return fma32(rows[y1] - rows[y0], ty[ey], rows[y0])


def _classic_linear(img: np.ndarray, dw: int, dh: int, fx: float, fy: float) -> np.ndarray:
    """OpenCV's own INTER_LINEAR of uint8 images and of 2-channel float32 ones."""
    H, W = img.shape[:2]
    x0, x1, a0, a1 = _taps_classic(W, dw, fx, True)
    y0, y1, b0, b1 = _taps_classic(H, dh, fy, False)
    ex = (slice(None),) + (None,) * (img.ndim - 2)
    ey = (slice(None), None) + (None,) * (img.ndim - 2)
    if img.dtype == np.uint8:
        scale = 1 << _COEF_BITS
        ia0, ia1, ib0, ib1 = (np.rint(w * scale).astype(np.int64) for w in (a0, a1, b0, b1))
        src = img.astype(np.int64)
        rows = src[:, x0] * ia0[ex] + src[:, x1] * ia1[ex]
        # the vertical pass as OpenCV's vector loop computes it: rows >> 4,
        # the high halves of the 16-bit products, then a rounding >> 2
        out = ((((rows[y0] >> 4) * ib0[ey]) >> 16) + (((rows[y1] >> 4) * ib1[ey]) >> 16)
               + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    rows = (img[:, x0] * a0[ex] + img[:, x1] * a1[ex]).astype(np.float32)
    return (rows[y0] * b0[ey] + rows[y1] * b1[ey]).astype(np.float32)


def _halve_area(img: np.ndarray) -> np.ndarray:
    """cv2.resize at fx = fy = 0.5 of a uint8 image or a 2-channel float32
    one, which OpenCV computes with INTER_AREA over 2 x 2 blocks: the output
    is round(W / 2) x round(H / 2) (half to even), so an input side of 4 k +
    3 leaves a last block of one row or column, averaged over the samples it
    has. A whole block: ((a + b + c + d + 2) >> 2) for uint8 at 1, 3 and 4
    channels, the sum times 0.25 rounded half to even at 2 channels, and
    (((a + b) + c) + d) * 0.25 in float32; a partial block: its sum over its
    count, rounded half to even for uint8."""
    H, W = img.shape[:2]
    dh, dw = int(np.rint(H * 0.5)), int(np.rint(W * 0.5))
    pad = [(0, max(2 * dh - H, 0)), (0, max(2 * dw - W, 0))] + [(0, 0)] * (img.ndim - 2)
    wide = img.dtype == np.uint8
    x = np.pad(img.astype(np.int64) if wide else img, pad)[:2 * dh, :2 * dw]
    a, b, c, d = x[0::2, 0::2], x[0::2, 1::2], x[1::2, 0::2], x[1::2, 1::2]
    count = np.pad(np.ones((H, W), np.int64), pad[:2])[:2 * dh, :2 * dw]
    n = (count[0::2, 0::2] + count[0::2, 1::2] + count[1::2, 0::2] + count[1::2, 1::2])
    n = n.reshape(n.shape + (1,) * (img.ndim - 2))
    s = ((a + b) + c) + d  # the padded samples are 0
    if wide:
        whole = ((s + 2) >> 2 if img.ndim == 2 or img.shape[2] != 2
                 else np.rint(s.astype(np.float32) * np.float32(0.25)))
        part = np.rint(s.astype(np.float32) / n.astype(np.float32))
        return np.where(n == 4, whole, part).astype(np.uint8)
    return np.where(n == 4, s * np.float32(0.25), s / n.astype(np.float32)).astype(np.float32)


def resize_cv(img: np.ndarray, fx: float, fy: float, nearest: bool = False) -> np.ndarray:
    """cv2.resize(img, None, fx=fx, fy=fy, interpolation=INTER_LINEAR or
    INTER_NEAREST) of an (H, W) or (H, W, C) image, as OpenCV 5.0.0 computes
    it on the CPU, bit for bit:

      * INTER_NEAREST of any image: source index floor(d / scale);
      * INTER_LINEAR of uint8 images and of 2-channel float32 ones (a dense
        flow): OpenCV's own fixed-point and float32 routes
        (`_taps_classic`); at fx = fy = 0.5 OpenCV takes INTER_AREA
        for them (`_halve_area`);
      * INTER_LINEAR of 1-, 3- and 4-channel float32 images, halving
        included: fma(b - a, t, a) along rows then columns at OpenCV 5's
        float64 coordinates (`_taps_by_scale`), for inputs and outputs of at
        least MIN_LINEAR_F32 samples a side; narrower ones raise. Where the
        scales are exactly the output sizes over the input's (2.0 on an
        even side, say), OpenCV takes its route by size (Intel IPP), and so
        does this (`resize_linear_f32`, with its refusals).

    A resize to the input's own size is a copy, as in OpenCV."""
    H, W = img.shape[:2]
    dw, dh = int(np.rint(W * fx)), int(np.rint(H * fy))
    if dw <= 0 or dh <= 0:
        raise ValueError(f"resize_cv: {W}x{H} at fx={fx}, fy={fy} is empty")
    if (dw, dh) == (W, H):
        return img.copy()
    if nearest:
        xs = np.minimum(np.floor(np.arange(dw) * (1.0 / fx)).astype(np.int64), W - 1)
        ys = np.minimum(np.floor(np.arange(dh) * (1.0 / fy)).astype(np.int64), H - 1)
        return img[ys][:, xs]
    channels = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype == np.uint8 or (img.dtype == np.float32 and channels == 2):
        if fx == fy == 0.5:
            return _halve_area(img)
        return _classic_linear(img, dw, dh, fx, fy)
    if img.dtype != np.float32 or channels not in (1, 3, 4):
        raise ValueError(f"resize_cv: INTER_LINEAR of {img.dtype} images of shape {img.shape} "
                         "is not reproduced (uint8 and float32 images are)")
    if dw / W == fx and dh / H == fy:  # the scale is the sizes' ratio: the route by size
        return resize_linear_f32(img, (dw, dh))
    if min(H, W, dh, dw) < MIN_LINEAR_F32:
        raise ValueError(f"resize_cv: float32 INTER_LINEAR from {W}x{H} to {dw}x{dh} is not "
                         f"reproduced (sides of {MIN_LINEAR_F32} or more are)")
    return _lerp_f32(img, _taps_by_scale(W, dw, 1.0 / fx), _taps_by_scale(H, dh, 1.0 / fy))


def resize_linear_f32(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size) (INTER_LINEAR, size = (width, height)) of a
    float32 image, as OpenCV 5.0.0 with Intel IPP computes it on this CPU
    path: fma(b - a, t, a) along rows then columns at `_taps_by_size`'s
    taps, bit for bit for 1-channel images at any size, and for 3- and
    4-channel ones that no side enlarges (IPP's border code for enlarged
    3- and 4-channel images rounds differently by position: those raise).
    A resize to the input's own size is a copy."""
    w, h = int(size[0]), int(size[1])
    H, W = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype != np.float32 or channels not in (1, 3, 4) or w <= 0 or h <= 0:
        raise ValueError(f"resize_linear_f32 takes float32 images of 1, 3 or 4 channels and "
                         f"a size, got {img.dtype} {img.shape} to {size}")
    if (w, h) == (W, H):
        return img.copy()
    if min(H, W, h, w) < MIN_LINEAR_F32 or (channels > 1 and (w > W or h > H)):
        raise ValueError(f"resize_linear_f32: {W}x{H} to {w}x{h} at {channels} channels is not "
                         "reproduced")
    return _lerp_f32(img, _taps_by_size(W, w), _taps_by_size(H, h))
