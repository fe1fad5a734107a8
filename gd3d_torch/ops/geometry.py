"""Depth rasterization and keypoint depth (counterpart of the device-side
part of gd3d/ops/geometry.py that the MASt3R step calls)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def point_cloud_to_depth(
    points: torch.Tensor, K: torch.Tensor, w: int, h: int
) -> torch.Tensor:
    """Rasterize camera-frame points (N, 3) to a (1, 1, h, w) average-Z map.

    Round to the nearest pixel (half to even, as jnp.round), average Z of
    the points landing on a pixel, zero where empty. Invalid points go to an
    overflow bin. The range test runs on the rounded floats, so a point far
    off the image never reaches an integer cast."""
    X, Y, Z = points[:, 0], points[:, 1], points[:, 2]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    zsafe = torch.where(Z > 0, Z, torch.ones_like(Z))
    u = torch.round((X / zsafe) * fx + cx)
    v = torch.round((Y / zsafe) * fy + cy)
    valid = (Z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    idx = torch.where(valid, v * w + u, torch.full_like(u, h * w)).long()
    zsum = torch.zeros(h * w + 1, dtype=torch.float32, device=points.device)
    cnt = torch.zeros(h * w + 1, dtype=torch.float32, device=points.device)
    zsum.index_add_(0, idx, torch.where(valid, Z, torch.zeros_like(Z)).float())
    cnt.index_add_(0, idx, valid.float())
    avg = torch.where(cnt > 0, zsum / torch.clamp(cnt, min=1.0),
                      torch.zeros_like(zsum))[: h * w]
    return avg.reshape(1, 1, h, w)


def extract_kp_depth(
    depth_map: torch.Tensor, kp: torch.Tensor, window_size: int = 3
) -> torch.Tensor:
    """Mean depth in a replicate-padded window around floor(kp).

    depth_map (H, W), kp (B, N, 2) as (x, y). Returns (B, N). `.long()`
    truncates toward zero like the reference; keypoints are non-negative."""
    H, W = depth_map.shape[-2:]
    half = window_size // 2
    padded = F.pad(depth_map.reshape(1, 1, H, W), (half, half, half, half),
                   mode="replicate")[0, 0]
    patches = torch.zeros((H, W), dtype=padded.dtype, device=padded.device)
    for dy in range(window_size):
        for dx in range(window_size):
            patches = patches + padded[dy: dy + H, dx: dx + W]
    patch_means = patches / float(window_size * window_size)
    x = torch.clamp(kp[..., 0].long(), 0, W - 1)
    y = torch.clamp(kp[..., 1].long(), 0, H - 1)
    return patch_means[y, x]
