"""2D rotary position embedding, CroCo flavour (counterpart of
gd3d/ops/rope2d.py).

The head dim splits into a y half and an x half; each half gets 1D RoPE at
its integer grid position. Every call goes through `RoPE2DQK`, an
autograd.Function whose forward is K5 (gd3d_torch/kernels/rope2d.py) on the
q and k of one attention layer, or on one tensor, and whose backward is K5
with -F0, as gd3d's custom_vjp. For CUDA tensors the wrappers launch the
hand-written kernel (once for q and k together); for CPU tensors they run
the plain twin, gd3d's `rope2d_xla` formula. The CroCo teacher and the
VGGT aggregator both call `rope2d_qk`; `rope2d` is the one-tensor form.
"""
from __future__ import annotations

import torch

from gd3d_torch.kernels.rope2d import RoPE2DQK, _aligned, vec_width


def _on_vectors(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy where K5's vector loads could not read the
    view (the kernel raises on one; the models' views are on the grid)."""
    if t.shape[-1] % 4 or t.stride(-1) != 1 or _aligned(t, vec_width(t.shape[-1], t.dtype)):
        return t
    return t.contiguous()


def rope2d(tokens: torch.Tensor, positions: torch.Tensor, base: float = 100.0,
           f0: float = 1.0) -> torch.Tensor:
    """tokens (B, H, N, D) with D % 4 == 0, positions (B, N, 2) as (y, x)
    integers. The result is stored in (B, N, H, D) order (see K5)."""
    return RoPE2DQK.apply(_on_vectors(tokens), positions, None, None, float(base),
                          float(f0))[0]


def rope2d_qk(q: torch.Tensor, qpos: torch.Tensor, k: torch.Tensor, kpos: torch.Tensor,
              base: float = 100.0, f0: float = 1.0):
    """(rope2d(q, qpos), rope2d(k, kpos)) in one K5 launch. q and k share the
    dtype and D; their B, H, N and positions may differ (cross attention)."""
    return RoPE2DQK.apply(_on_vectors(q), qpos, _on_vectors(k), kpos, float(base), float(f0))


def grid_positions(h: int, w: int, batch: int = 1, device=None) -> torch.Tensor:
    """(B, h*w, 2) integer (y, x) positions."""
    ys, xs = torch.meshgrid(
        torch.arange(h, device=device), torch.arange(w, device=device),
        indexing="ij")
    pos = torch.stack([ys, xs], dim=-1).reshape(1, h * w, 2)
    return pos.expand(batch, h * w, 2)
