"""Bilinear keypoint-feature interpolation with patch-centre alignment
(counterpart of gd3d/ops/interpolate.py)."""
from __future__ import annotations

import torch


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
    descriptors: torch.Tensor, pts: torch.Tensor, h: int, w: int, patch_size: int,
) -> torch.Tensor:
    """Per-keypoint features from a (B, C, ph, pw) patch map at pts (B, N, 2)
    in (x, y) pixels of the h x w image, patch centres at patch_size / 2 +
    k * patch_size. Returns (B, C, N), unnormalized (gd3d's normalize=False,
    stride = patch_size: the only form the step uses)."""
    last_coord_h = ((h - patch_size) // patch_size) * patch_size + (patch_size / 2)
    last_coord_w = ((w - patch_size) // patch_size) * patch_size + (patch_size / 2)
    ah = 2.0 / (last_coord_h - (patch_size / 2))
    aw = 2.0 / (last_coord_w - (patch_size / 2))
    bh = 1.0 - last_coord_h * 2.0 / (last_coord_h - (patch_size / 2))
    bw = 1.0 - last_coord_w * 2.0 / (last_coord_w - (patch_size / 2))
    a = torch.tensor([aw, ah], dtype=pts.dtype, device=pts.device)
    b = torch.tensor([bw, bh], dtype=pts.dtype, device=pts.device)
    return grid_sample_bilinear(descriptors, a * pts + b)
