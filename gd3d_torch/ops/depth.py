"""Depth-map post-processing (counterpart of gd3d/ops/depth.py).

kornia is not a dependency, so the median, bilateral, guided and joint
bilateral filters are written in torch with kornia's conventions: reflect
padding, and even kernels pad (k-1)//2 in front and the rest behind. The
hole-fill convolutions and the outlier statistics pad with zeros; the
morphology pads with -inf/+inf (max-pool semantics).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad2d(x: torch.Tensor, k: int, mode: str) -> torch.Tensor:
    """(H, W) -> (1, 1, H+k-1, W+k-1)."""
    front = (k - 1) // 2
    rear = (k - 1) - front
    return F.pad(x[None, None], (front, rear, front, rear), mode=mode)


def _windows(x: torch.Tensor, k: int, mode: str = "reflect") -> torch.Tensor:
    """(k*k, H, W) stack of the shifted views of the padded map."""
    H, W = x.shape
    p = _pad2d(x, k, mode)[0, 0]
    return torch.stack(
        [p[dy: dy + H, dx: dx + W] for dy in range(k) for dx in range(k)], 0)


def _window_sum(x: torch.Tensor, k: int, mode: str) -> torch.Tensor:
    ones = torch.ones((1, 1, k, k), dtype=x.dtype, device=x.device)
    return F.conv2d(_pad2d(x, k, mode), ones)[0, 0]


def _box_filter(x: torch.Tensor, k: int, mode: str = "reflect") -> torch.Tensor:
    return _window_sum(x, k, mode) / float(k * k)


def _conv_ones(x: torch.Tensor, k: int) -> torch.Tensor:
    """F.conv2d with an all-ones k x k kernel and zero 'same' padding."""
    return _window_sum(x, k, mode="constant")


def median_blur(x: torch.Tensor, k: int) -> torch.Tensor:
    """kornia.filters.median_blur for odd k: reflect pad, window median."""
    return torch.median(_windows(x, k), dim=0).values


def _gaussian_kernel1d(k: int, sigma: float, device) -> torch.Tensor:
    half = (k - 1) / 2.0
    xs = torch.arange(k, dtype=torch.float32, device=device) - half
    g = torch.exp(-0.5 * (xs / sigma) ** 2)
    return g / g.sum()


def _space_kernel(k: int, sigma: float, device) -> torch.Tensor:
    g = _gaussian_kernel1d(k, sigma, device)
    return (g[:, None] * g[None, :]).reshape(-1)


def joint_bilateral_blur(
    inp: torch.Tensor,
    guide: torch.Tensor,
    k: int,
    sigma_color: float,
    sigma_space: float,
) -> torch.Tensor:
    """kornia joint_bilateral_blur: the range kernel comes from the guide."""
    wins = _windows(inp, k)
    gwin = _windows(guide, k)
    diff = gwin - guide[None]
    color_w = torch.exp(-0.5 * (diff / sigma_color) ** 2)
    space_w = _space_kernel(k, sigma_space, inp.device)[:, None, None]
    w = color_w * space_w
    return (w * wins).sum(0) / (w.sum(0) + 1e-12)


def bilateral_blur(
    x: torch.Tensor, k: int, sigma_color: float, sigma_space: float
) -> torch.Tensor:
    return joint_bilateral_blur(x, x, k, sigma_color, sigma_space)


def guided_blur(
    guidance: torch.Tensor, inp: torch.Tensor, k: int, eps: float
) -> torch.Tensor:
    """kornia guided_blur(guidance, input, kernel_size, eps)."""
    mean_I = _box_filter(guidance, k)
    mean_p = _box_filter(inp, k)
    corr_Ip = _box_filter(guidance * inp, k)
    var_I = _box_filter(guidance * guidance, k) - mean_I * mean_I
    cov_Ip = corr_Ip - mean_I * mean_p
    a = cov_Ip / (var_I + eps)
    b = mean_p - a * mean_I
    return _box_filter(a, k) * guidance + _box_filter(b, k)


def _dilate(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.max_pool2d(x[None, None], k, stride=1, padding=k // 2)[0, 0]


def _erode(x: torch.Tensor, k: int) -> torch.Tensor:
    return -_dilate(-x, k)


def _fill_holes(depth: torch.Tensor, k: int) -> torch.Tensor:
    """One neighbourhood-average hole-fill pass."""
    valid = (depth > 0).to(depth.dtype)
    dist_w = _conv_ones(valid, k)
    expanded = (dist_w > 0).to(depth.dtype)
    value_prop = _conv_ones(depth * valid, k)
    normalized = value_prop / (dist_w + 1e-8)
    fill = torch.clamp(expanded - valid, 0.0, 1.0)
    return depth * valid + normalized * fill


def post_process_depth(
    depth_img: torch.Tensor,
    kernel_size: int = 3,
    bilateral_d: int = 3,
    bilateral_sigma_color: float = 0.1,
    bilateral_sigma_space: float = 1.0,
    guided_r: int = 8,
    guided_eps: float = 1e-2,
) -> torch.Tensor:
    """Close -> two hole fills (5, 7) -> median -> bilateral -> guided ->
    3-sigma outlier replacement -> joint bilateral. (H, W) -> (H, W)."""
    d = depth_img.reshape(depth_img.shape[-2:]).float()
    eroded = _erode(_dilate(d, kernel_size), kernel_size)
    eroded = eroded * (eroded >= 1e-5).to(d.dtype)
    eroded = _fill_holes(eroded, 5)
    eroded = _fill_holes(eroded, 7)

    depth_median = median_blur(eroded, kernel_size)
    guide_img = depth_median
    depth_bilateral = bilateral_blur(
        depth_median, bilateral_d, bilateral_sigma_color, bilateral_sigma_space)
    depth_guided = guided_blur(depth_bilateral, guide_img, guided_r, guided_eps)

    local_mean = _box_filter(depth_guided, kernel_size, mode="constant")
    local_sq = _box_filter(depth_guided ** 2, kernel_size, mode="constant")
    local_std = torch.sqrt(torch.clamp(local_sq - local_mean ** 2, min=1e-6))
    outlier = (torch.abs(depth_guided - local_mean) > 3.0 * local_std).to(d.dtype)
    depth_filtered = depth_guided * (1.0 - outlier) + depth_median * outlier

    return joint_bilateral_blur(
        depth_filtered, guide_img, bilateral_d,
        bilateral_sigma_color / 2.0, bilateral_sigma_space)
