"""2D rotary position embedding, CroCo flavour (counterpart of the
`rope2d_xla` path of gd3d/ops/rope2d.py).

The head dim splits into a y half and an x half; each half gets 1D RoPE at
its integer grid position. gd3d's Pallas RoPE kernel (K5,
gd3d/kernels/rope2d.py) is off by default there and is not ported yet; this
plain version is what gd3d runs by default. Autograd differentiates it.
"""
from __future__ import annotations

import torch


def _rope1d(tokens: torch.Tensor, pos1d: torch.Tensor, base: float):
    """tokens (B, H, N, D), pos1d (B, N) int."""
    D = tokens.shape[-1]
    exponent = torch.arange(0, D, 2, dtype=torch.float32, device=tokens.device) / D
    inv_freq = 1.0 / (base ** exponent)
    angles = pos1d[..., None].to(torch.float32) * inv_freq  # (B, N, D/2)
    angles = torch.cat([angles, angles], dim=-1)
    cos = torch.cos(angles).to(tokens.dtype)[:, None]
    sin = torch.sin(angles).to(tokens.dtype)[:, None]
    x1, x2 = tokens.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return tokens * cos + rot * sin


def rope2d(tokens: torch.Tensor, positions: torch.Tensor, base: float = 100.0) -> torch.Tensor:
    """tokens (B, H, N, D) with D % 4 == 0, positions (B, N, 2) as (y, x)."""
    y, x = tokens.chunk(2, dim=-1)
    y = _rope1d(y, positions[:, :, 0], base)
    x = _rope1d(x, positions[:, :, 1], base)
    return torch.cat([y, x], dim=-1)


def grid_positions(h: int, w: int, batch: int = 1, device=None) -> torch.Tensor:
    """(B, h*w, 2) integer (y, x) positions."""
    ys, xs = torch.meshgrid(
        torch.arange(h, device=device), torch.arange(w, device=device),
        indexing="ij")
    pos = torch.stack([ys, xs], dim=-1).reshape(1, h * w, 2)
    return pos.expand(batch, h * w, 2)
