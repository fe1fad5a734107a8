"""2D rotary position embedding, CroCo flavour (counterpart of
gd3d/ops/rope2d.py).

The head dim splits into a y half and an x half; each half gets 1D RoPE at
its integer grid position. Every call goes through `RoPE2D`, an
autograd.Function whose forward is K5 (gd3d_torch/kernels/rope2d.py) and
whose backward is K5 with -F0, as gd3d's custom_vjp. For CUDA tensors the
wrapper launches the hand-written kernel; for CPU tensors it runs the plain
twin, gd3d's `rope2d_xla` formula. The CroCo teacher and the VGGT
aggregator both call it.
"""
from __future__ import annotations

import torch

from gd3d_torch.kernels.rope2d import RoPE2D


def rope2d(tokens: torch.Tensor, positions: torch.Tensor, base: float = 100.0,
           f0: float = 1.0) -> torch.Tensor:
    """tokens (B, H, N, D) with D % 4 == 0, positions (B, N, 2) as (y, x)
    integers. The result is stored in (B, N, H, D) order (see K5)."""
    return RoPE2D.apply(tokens, positions, float(base), float(f0))


def grid_positions(h: int, w: int, batch: int = 1, device=None) -> torch.Tensor:
    """(B, h*w, 2) integer (y, x) positions."""
    ys, xs = torch.meshgrid(
        torch.arange(h, device=device), torch.arange(w, device=device),
        indexing="ij")
    pos = torch.stack([ys, xs], dim=-1).reshape(1, h * w, 2)
    return pos.expand(batch, h * w, 2)
