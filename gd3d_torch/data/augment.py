"""Image augmentations of gd3d's datasets (counterpart of
gd3d/data/augment.py), without cv2.

Each augmentation draws from the caller's np.random.RandomState in the
order and number of gd3d's (the state is equal after each call), and each
cv2 call it stands for is reproduced on uint8 images as OpenCV 5's CPU
code computes it:

  - `gaussian_blur`: cv2.GaussianBlur(img, (k, k), 0), k = 3, 5, 7: the
    binomial kernels OpenCV takes for sigma 0 ([1 2 1]/4, [1 4 6 4 1]/16,
    [2 7 14 18 14 7 2]/64) as 8-bit fixed point, a horizontal then a
    vertical pass in integers, rounded by (v + 2^15) >> 16; border
    BORDER_REFLECT_101;
  - `rgb2lab` / `lab2rgb`: COLOR_RGB2LAB and COLOR_LAB2RGB on 8 bits,
    OpenCV's integer paths (RGB2Lab_b: the sRGB gamma table in 3 fractional
    bits and the cube-root table in 15; Lab2RGBinteger: the L -> y, f(y)
    table, a and b through abToXZ_b, the inverse gamma table of 4096
    entries);
  - `clahe_apply`: createCLAHE(clip, (8, 8)).apply on one 8-bit channel:
    the image padded to a multiple of 8 tiles (BORDER_REFLECT_101), tile
    histograms clipped at max(int(clip * tile_area / 256), 1) with the
    excess spread evenly and its residual every 256 // residual bins, the
    cumulative LUT scaled by 255 / tile_area in float32, the four nearest
    tiles' LUTs blended bilinearly in float32 and rounded;
  - `rgb2hsv` / `hsv2rgb`: COLOR_RGB2HSV and COLOR_HSV2RGB on 8 bits, hue
    in [0, 180): the forward one in 12-bit fixed point with OpenCV's
    division tables, the inverse in float32 with fused multiply-adds,
    truncated to uint8 in the vector loop and rounded in the scalar tail of
    each row;
  - `rotation_matrix_2d`, `warp_affine`: getRotationMatrix2D, and
    warpAffine with INTER_LINEAR or INTER_NEAREST and a zero border, as
    OpenCV 5 computes them: the inverse map in float64, then float32 source
    coordinates (the row's offset, then a fused multiply-add along x), the
    nearest pixel by round-half-even, or the bilinear blend of the four
    neighbours by fused multiply-adds in float32, rounded.

The float parts (gauss_noise, brightness_contrast, color_jitter's
brightness, contrast, saturation and hue) are gd3d's numpy code as written.
tests/test_torch_augment.py holds each one to cv2 (the colour conversions
over every input value).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np

f32 = np.float32


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding: the product of two float32 is
    exact in float64, and so is its sum with c wherever the operands'
    exponents lie close, as they do in these uses."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def reflect101(img: np.ndarray, top: int, bottom: int, left: int, right: int) -> np.ndarray:
    """cv2.copyMakeBorder(..., BORDER_REFLECT_101) of the first two axes."""
    def index(n, before, after):
        i = np.arange(-before, n + after)
        if n == 1:
            return np.zeros_like(i)
        period = 2 * (n - 1)
        i = np.abs(i) % period
        return np.where(i >= n, period - i, i)

    h, w = img.shape[:2]
    return img[index(h, top, bottom)][:, index(w, left, right)]


# ---------------------------------------------------------------------------
# GaussianBlur
# ---------------------------------------------------------------------------

# OpenCV's small Gaussian kernels for sigma <= 0, in 1/256
_BLUR_KERNELS = {3: (64, 128, 64), 5: (16, 64, 96, 64, 16), 7: (8, 28, 56, 72, 56, 28, 8)}


def gaussian_blur_cv(img: np.ndarray, k: int) -> np.ndarray:
    """cv2.GaussianBlur(img, (k, k), 0) of a uint8 image, k in 3, 5, 7."""
    w = np.asarray(_BLUR_KERNELS[k], np.int64)
    r = k // 2
    h_, w_ = img.shape[:2]
    p = reflect101(img.astype(np.int64), r, r, r, r)
    rows = sum(w[i] * p[:, i:i + w_] for i in range(k))
    out = sum(w[j] * rows[j:j + h_] for j in range(k))
    return ((out + (1 << 15)) >> 16).astype(np.uint8)


# ---------------------------------------------------------------------------
# Lab
# ---------------------------------------------------------------------------

_LAB_SHIFT, _GAMMA_SHIFT = 12, 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_INV_GAMMA_SIZE = 4096
_BASE = 1 << 14
_SRGB2XYZ = np.array([[0.412453, 0.357580, 0.180423], [0.212671, 0.715160, 0.072169],
                      [0.019334, 0.119193, 0.950227]])
_XYZ2SRGB = np.array([[3.240479, -1.53715, -0.498535], [-0.969256, 1.875991, 0.041556],
                      [0.055648, -0.204043, 1.057311]])
_D65 = np.array([0.950456, 1.0, 1.088754])


def _apply_gamma(x: np.ndarray) -> np.ndarray:
    lo = (x.astype(np.float64) / 12.92).astype(np.float32)
    base = ((x + f32(0.055)).astype(np.float32) / f32(1.055)).astype(np.float32)
    hi = np.power(base.astype(np.float64), 2.4).astype(np.float32)
    return np.where(x <= f32(0.04045), lo, hi)


def _apply_inv_gamma(x: np.ndarray) -> np.ndarray:
    lo = (x * f32(12.92)).astype(np.float32)
    pw = np.power(x.astype(np.float64), 1 / 2.4).astype(np.float32)
    hi = (f32(1.055) * pw - f32(0.055)).astype(np.float32)
    return np.where(x <= f32(0.0031308), lo, hi)


@functools.lru_cache(maxsize=1)
def _lab_tables():
    """OpenCV's 8-bit Lab tables (initLabTabs), from their float32 formulas."""
    x = (np.arange(256).astype(np.float32) / f32(255)).astype(np.float32)
    gamma = np.rint((f32(255 * (1 << _GAMMA_SHIFT)) * _apply_gamma(x))
                    .astype(np.float64)).astype(np.int64)
    n = 256 * 3 // 2 * (1 << _GAMMA_SHIFT)
    step = f32(1) / (f32(255) * f32(1 << _GAMMA_SHIFT))
    xc = (step * np.arange(n).astype(np.float32)).astype(np.float32)
    lin = _fma(xc, f32(841) / f32(108), f32(16) / f32(116))
    cbrt = np.cbrt(xc.astype(np.float64)).astype(np.float32)
    fx = np.where(xc < f32(216) / f32(24389), lin, cbrt)
    cbrt_tab = np.rint((f32(1 << _LAB_SHIFT2) * fx).astype(np.float64)).astype(np.int64)
    # OpenCV's software cube root gives one ulp less here, where the scaled
    # value is a tie (17745.5): the only entry of the table that it moves
    cbrt_tab[324] -= 1
    to_xyz = np.rint((1 << _LAB_SHIFT) * _SRGB2XYZ / _D65[:, None]).astype(np.int64)

    xi = (f32(1) / f32(_INV_GAMMA_SIZE) * np.arange(_INV_GAMMA_SIZE).astype(np.float32))
    inv_gamma = np.rint((f32(255) * _apply_inv_gamma(xi.astype(np.float32)))
                        .astype(np.float64)).astype(np.int64)
    l_to_y = np.zeros(256, np.int64)
    l_to_fy = np.zeros(256, np.int64)
    for i in range(256):
        if i <= 20:
            l_to_y[i] = round(i * _BASE * 100 / 255 / 903.3)
            l_to_fy[i] = round(_BASE * (7.787 * (i * 100 / 255 / 903.3) + 16 / 116))
        else:
            fy = i * 100 * _BASE / (255 * 116) + 16 * _BASE / 116
            l_to_fy[i] = round(fy)
            l_to_y[i] = round(fy * fy * fy / (_BASE * _BASE))
    to_rgb = np.rint((1 << _LAB_SHIFT) * _XYZ2SRGB * _D65[None, :]).astype(np.int64)
    return gamma, cbrt_tab, to_xyz, inv_gamma, l_to_y, l_to_fy, to_rgb


def _descale(v, n):
    return (v + (1 << (n - 1))) >> n


def rgb2lab(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_RGB2LAB) of a uint8 RGB image."""
    gamma, cbrt_tab, c, *_ = _lab_tables()
    r, g, b = (gamma[img[..., i]] for i in range(3))
    fx, fy, fz = (cbrt_tab[_descale(r * c[i, 0] + g * c[i, 1] + b * c[i, 2], _LAB_SHIFT)]
                  for i in range(3))
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    lab = np.stack([_descale(l_scale * fy + l_shift, _LAB_SHIFT2),
                    _descale(500 * (fx - fy) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2),
                    _descale(200 * (fy - fz) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)], -1)
    return np.clip(lab, 0, 255).astype(np.uint8)


def _ab_to_xz(v: np.ndarray) -> np.ndarray:
    lo = np.trunc(v * 108 / 841).astype(np.int64) - (_BASE * 16 // 116 * 108 // 841)
    hi = v * v // _BASE * v // _BASE
    return np.where(v <= 3390, lo, hi)


def lab2rgb(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_LAB2RGB) of a uint8 Lab image."""
    *_, inv_gamma, l_to_y, l_to_fy, c = _lab_tables()
    L, a, b = (img[..., i].astype(np.int64) for i in range(3))
    y, fy = l_to_y[L], l_to_fy[L]
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * _BASE // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * _BASE // 200 + 1
    x, z = _ab_to_xz(fy + adiv), _ab_to_xz(fy - bdiv)
    shift = _LAB_SHIFT + 2
    rgb = [inv_gamma[np.clip(_descale(c[i, 0] * x + c[i, 1] * y + c[i, 2] * z, shift), 0,
                             _INV_GAMMA_SIZE - 1)] for i in range(3)]
    return np.clip(np.stack(rgb, -1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# CLAHE
# ---------------------------------------------------------------------------

def clahe_apply(src: np.ndarray, clip_limit: float, tiles: Tuple[int, int] = (8, 8)
                ) -> np.ndarray:
    """cv2.createCLAHE(clip_limit, tiles).apply(src) of a uint8 (H, W) image."""
    tx, ty = tiles
    h, w = src.shape
    ext = src
    if h % ty or w % tx:
        ext = reflect101(src, 0, ty - h % ty, 0, tx - w % tx)
    th, tw = ext.shape[0] // ty, ext.shape[1] // tx
    area = th * tw
    tiles_px = ext[:ty * th, :tx * tw].reshape(ty, th, tx, tw).transpose(0, 2, 1, 3)
    flat = tiles_px.reshape(ty * tx, area).astype(np.int64)
    hist = np.zeros((ty * tx, 256), np.int64)
    np.add.at(hist, (np.arange(ty * tx)[:, None], flat), 1)
    if clip_limit > 0:
        limit = max(int(clip_limit * area / 256), 1)
        clipped = np.maximum(hist - limit, 0).sum(1)
        hist = np.minimum(hist, limit) + (clipped // 256)[:, None]
        for t, residual in enumerate(clipped % 256):
            if residual:
                step = max(256 // int(residual), 1)
                hist[t, np.arange(0, 256, step)[:residual]] += 1
    scale = f32(255) / f32(area)
    lut = np.rint(np.cumsum(hist, 1).astype(np.float32) * scale).clip(0, 255)
    lut = lut.astype(np.uint8).reshape(ty, tx, 256)

    def axis(n, size, count):
        t = (np.arange(n).astype(np.float32) * (f32(1) / f32(size)) - f32(0.5)).astype(
            np.float32)
        i1 = np.floor(t).astype(np.int64)
        frac = (t - i1.astype(np.float32)).astype(np.float32)
        return np.maximum(i1, 0), np.minimum(i1 + 1, count - 1), frac, (f32(1) - frac)

    x1, x2, xa, xa1 = axis(w, tw, tx)
    y1, y2, ya, ya1 = axis(h, th, ty)
    v = src.astype(np.int64)
    l11, l12 = (lut[y1[:, None], xs[None, :], v].astype(np.float32) for xs in (x1, x2))
    l21, l22 = (lut[y2[:, None], xs[None, :], v].astype(np.float32) for xs in (x1, x2))
    res = ((l11 * xa1 + l12 * xa) * ya1[:, None] + (l21 * xa1 + l22 * xa) * ya[:, None])
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# HSV
# ---------------------------------------------------------------------------

_HSV_SHIFT = 12


@functools.lru_cache(maxsize=1)
def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


def rgb2hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_RGB2HSV) of a uint8 RGB image."""
    sdiv, hdiv = _hsv_tables()
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


# pixels of a row that COLOR_HSV2RGB converts a vector step
_HSV_VECTOR = 32
# sector -> the tab entries that give (b, g, r)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv2rgb(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_HSV2RGB) of a uint8 HSV image (hue in
    [0, 180); larger hues wrap)."""
    h = img[..., 0].astype(np.float32) * f32(6.0 / 180)
    s = img[..., 1].astype(np.float32) * f32(1 / 255)
    v = img[..., 2].astype(np.float32) * f32(1 / 255)
    while (h >= 6).any():
        h = np.where(h >= 6, h - f32(6), h)
    sector = np.floor(h).astype(np.int64)
    h = (h - sector.astype(np.float32)).astype(np.float32)
    one = np.ones_like(h)
    tab = np.stack([v, (v * (f32(1) - s)).astype(np.float32),
                    (v * _fma(-s, h, one)).astype(np.float32),
                    (v * _fma(-s, (f32(1) - h).astype(np.float32), one)).astype(np.float32)],
                   -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], -1)
    out = np.where((s == 0)[..., None], v[..., None], bgr[..., ::-1]) * f32(255)
    # OpenCV's vector loop (32 pixels a step in its AVX-512 build) truncates,
    # its scalar loop over the rest of each row rounds half to even
    vec = img.shape[-2] // _HSV_VECTOR * _HSV_VECTOR
    out = np.concatenate([np.trunc(out[..., :vec, :]), np.rint(out[..., vec:, :])], -2)
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Affine warps
# ---------------------------------------------------------------------------

def rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3) float64, the centre as float32."""
    cx, cy = float(f32(center[0])), float(f32(center[1]))
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _inverse_affine(m: np.ndarray) -> np.ndarray:
    """warpAffine's own inverse of a forward (2, 3) map, in float64."""
    m = np.asarray(m, np.float64).ravel().copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine(img: np.ndarray, m: np.ndarray, size: Tuple[int, int],
                nearest: bool = False) -> np.ndarray:
    """cv2.warpAffine(img, m, size, flags=INTER_LINEAR or INTER_NEAREST,
    borderMode=BORDER_CONSTANT, borderValue=0) of a uint8 (H, W) or
    (H, W, C) image; size = (width, height)."""
    w, h = size
    mi = _inverse_affine(m).astype(np.float32)
    x = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], (h, w))
    y = np.arange(h, dtype=np.float32)[:, None]
    sx = _fma(mi[0], x, (mi[1] * y + mi[2]).astype(np.float32))
    sy = _fma(mi[3], x, (mi[4] * y + mi[5]).astype(np.float32))
    src = img if img.ndim == 3 else img[..., None]
    H, W = src.shape[:2]
    if nearest:
        xi, yi = np.rint(sx).astype(np.int64), np.rint(sy).astype(np.int64)
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        out = np.where(inside[..., None], src[yi.clip(0, H - 1), xi.clip(0, W - 1)], 0)
        out = out.astype(np.uint8)
    else:
        pad = np.zeros((H + 2, W + 2, src.shape[2]), np.float32)
        pad[1:-1, 1:-1] = src
        xi, yi = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
        ax = (sx - xi.astype(np.float32)).astype(np.float32)[..., None]
        ay = (sy - yi.astype(np.float32)).astype(np.float32)[..., None]

        def at(yy, xx):
            ok = (xx >= -1) & (xx <= W) & (yy >= -1) & (yy <= H)
            return np.where(ok[..., None], pad[(yy + 1).clip(0, H + 1), (xx + 1).clip(0, W + 1)],
                            f32(0))

        p00, p01, p10, p11 = at(yi, xi), at(yi, xi + 1), at(yi + 1, xi), at(yi + 1, xi + 1)
        top = _fma(ax, p01 - p00, p00)
        bottom = _fma(ax, p11 - p10, p10)
        out = np.clip(np.rint(_fma(ay, bottom - top, top)), 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]


# ---------------------------------------------------------------------------
# gd3d's augmentations
# ---------------------------------------------------------------------------

def gaussian_blur(img: np.ndarray, rng: np.random.RandomState,
                  blur_limit=(1, 3)) -> np.ndarray:
    k = int(rng.randint(blur_limit[0], blur_limit[1] + 1))
    if k % 2 == 0:
        k += 1
    if k <= 1:
        return img
    return gaussian_blur_cv(img, k)


def gauss_noise(img: np.ndarray, rng: np.random.RandomState,
                var_limit=(10.0, 50.0)) -> np.ndarray:
    var = rng.uniform(*var_limit)
    noise = rng.normal(0, var**0.5, img.shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def clahe(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    clip = rng.uniform(1.0, 4.0)
    lab = rgb2lab(img)
    lab[..., 0] = clahe_apply(lab[..., 0], clip)
    return lab2rgb(lab)


def brightness_contrast(img: np.ndarray, rng: np.random.RandomState,
                        limit=0.2) -> np.ndarray:
    alpha = 1.0 + rng.uniform(-limit, limit)
    beta = rng.uniform(-limit, limit) * 255
    return np.clip(img.astype(np.float32) * alpha + beta, 0, 255).astype(np.uint8)


def color_jitter(img: np.ndarray, rng: np.random.RandomState,
                 brightness=0.2, contrast=0.2, saturation=0.2, hue=0.1):
    out = img.astype(np.float32) / 255.0
    b = 1.0 + rng.uniform(-brightness, brightness)
    out = np.clip(out * b, 0, 1)
    c = 1.0 + rng.uniform(-contrast, contrast)
    mean = out.mean()
    out = np.clip((out - mean) * c + mean, 0, 1)
    hsv = rgb2hsv((out * 255).astype(np.uint8)).astype(np.float32)
    s = 1.0 + rng.uniform(-saturation, saturation)
    hsv[..., 1] = np.clip(hsv[..., 1] * s, 0, 255)
    h = rng.uniform(-hue, hue) * 180
    hsv[..., 0] = (hsv[..., 0] + h) % 180
    return hsv2rgb(hsv.astype(np.uint8))


def color_augs_objaverse(img: np.ndarray, rng: np.random.RandomState,
                         p: float = 0.5) -> np.ndarray:
    """uint8 RGB in, uint8 RGB out (gd3d's color set A)."""
    if rng.rand() < p:
        img = gaussian_blur(img, rng)
    if rng.rand() < p:
        img = gauss_noise(img, rng)
    if rng.rand() < p:
        img = clahe(img, rng)
    if rng.rand() < p:
        img = brightness_contrast(img, rng)
    return img


def color_augs_scannetpp(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    img = color_jitter(img, rng)
    return gaussian_blur(img, rng, blur_limit=(3, 7))


def shift_scale_rotate(
    img: np.ndarray,
    kps: np.ndarray,
    mask: Optional[np.ndarray],
    rng: np.random.RandomState,
    shift_limit: float = 0.25,
    scale_limit: float = 0.25,
    rotate_limit: float = 45.0,
    p: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """A.ShiftScaleRotate with keypoint transport and a zero border."""
    if rng.rand() >= p:
        return img, kps, mask
    h, w = img.shape[:2]
    angle = rng.uniform(-rotate_limit, rotate_limit)
    scale = 1.0 + rng.uniform(-scale_limit, scale_limit)
    dx = rng.uniform(-shift_limit, shift_limit) * w
    dy = rng.uniform(-shift_limit, shift_limit) * h
    M = rotation_matrix_2d((w / 2, h / 2), angle, scale)
    M[0, 2] += dx
    M[1, 2] += dy
    img_out = warp_affine(img, M, (w, h))
    mask_out = None
    if mask is not None:
        mask_out = warp_affine(mask.astype(np.uint8), M, (w, h), nearest=True)
    ones = np.ones((kps.shape[0], 1), kps.dtype)
    kps_out = np.concatenate([kps[:, :2], ones], axis=1) @ M.T
    return img_out, kps_out.astype(np.float32), mask_out
