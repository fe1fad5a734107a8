"""Bilinear keypoint-feature interpolation with patch-centre alignment
(counterpart of gd3d/ops/interpolate.py)."""
from __future__ import annotations

import torch

from gd3d_torch.ops.basic import l2_normalize


def grid_sample_bilinear(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample img (B, C, H, W) at normalized coords (B, N, 2) in [-1, 1].

    grid_sample(align_corners=True, padding_mode='border') semantics: pixel
    p = (c + 1) / 2 * (size - 1), taps clamped to the border. Returns
    (B, C, N).
    """
    B, C, H, W = img.shape
    x = (coords[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = (x - x0)[:, None]
    ty = (y - y0)[:, None]
    flat = img.reshape(B, C, H * W)

    def tap(yi, xi):
        yi = torch.clamp(yi, 0, H - 1).long()
        xi = torch.clamp(xi, 0, W - 1).long()
        idx = (yi * W + xi)[:, None].expand(B, C, yi.shape[-1])
        return torch.gather(flat, 2, idx)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    top = v00 * (1.0 - tx) + v01 * tx
    bot = v10 * (1.0 - tx) + v11 * tx
    return top * (1.0 - ty) + bot * ty


def interpolate_features(
    descriptors: torch.Tensor, pts: torch.Tensor, h: int, w: int, normalize: bool = True,
    patch_size: int = 14, stride: int = 14,
) -> torch.Tensor:
    """Per-keypoint features from a (B, C, ph, pw) patch map at pts (B, N, 2)
    in (x, y) pixels of the h x w image. Patch centres sit at patch_size / 2
    + k * stride, so keypoint (patch_size / 2, patch_size / 2) lands on grid
    node (0, 0). Returns (B, C, N), L2-normalized over C when `normalize`.
    gd3d's signature and defaults (the DINO-era 14-px patch, which the PCK
    harness keeps as a quirk)."""
    last_coord_h = ((h - patch_size) // stride) * stride + (patch_size / 2)
    last_coord_w = ((w - patch_size) // stride) * stride + (patch_size / 2)
    ah = 2.0 / (last_coord_h - (patch_size / 2))
    aw = 2.0 / (last_coord_w - (patch_size / 2))
    bh = 1.0 - last_coord_h * 2.0 / (last_coord_h - (patch_size / 2))
    bw = 1.0 - last_coord_w * 2.0 / (last_coord_w - (patch_size / 2))
    a = torch.tensor([aw, ah], dtype=pts.dtype, device=pts.device)
    b = torch.tensor([bw, bh], dtype=pts.dtype, device=pts.device)
    out = grid_sample_bilinear(descriptors, a * pts + b)
    return l2_normalize(out, axis=1) if normalize else out
