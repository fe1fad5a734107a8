"""Scaled-dot-product attention dispatch (counterpart of
gd3d/ops/attention.py::scaled_dot_attention).

Every call goes through `FlashAttention`, an autograd.Function whose forward
is K1 (gd3d_torch/kernels/flash_fwd.py) and whose backward is K2
(gd3d_torch/kernels/flash_bwd_fused.py). For CUDA tensors those wrappers
launch the hand-written kernels; for CPU tensors they run their plain
PyTorch twins. The TPU plumbing of gd3d's dispatch (tile plans, segment-id
padding, head packing, partitioning wrappers) has no counterpart: the
kernels read the (B, N, H, D) layout through strides, mask ragged lengths
and read any head dim themselves (below their widths 64, 128 and 256, and
above 256 in column chunks) where a row is a multiple of 16 bytes; the
wrappers zero-pad the other head dims.
"""
from __future__ import annotations

from typing import Optional

import torch

from gd3d_torch.kernels.flash_bwd_fused import flash_attention_bwd_fused
from gd3d_torch.kernels.flash_fwd import flash_attention_fwd


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # di = rowsum(O * dO) outside the kernel, as gd3d does
        di = torch.einsum("bnhd,bnhd->bhn", o.float(), do.float()).contiguous()
        dq, dk, dv = flash_attention_bwd_fused(q, k, v, lse, do, di, ctx.scale)
        return dq, dk, dv, None


def scaled_dot_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """(B, N, H, D) x (B, M, H, D) -> (B, N, H, D), non-causal."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, float(scale))
