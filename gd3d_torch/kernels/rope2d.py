"""K5: RoPE2D, forward and backward.

Wrapper of the CUDA kernel in gd3d_torch/csrc/rope2d.cu, which replaces
gd3d/kernels/rope2d.py::_rope2d_call (the Pallas `_rope2d_kernel`, reached
through `rope2d_pallas`). `rope2d_plain` is its plain PyTorch twin, the
formula of gd3d's `rope2d_xla`: the CPU path, and the oracle the kernel is
checked against. The backward is the same kernel with -f0.

Tokens are (B, H, N, D) at the public function, as in gd3d. The kernel
reads them through strides, so the transposed (B, N, H, D) views the models
hold are not copied, and it writes its output in (B, N, H, D) memory order:
the models transpose it back to a contiguous (B, N, H, D) tensor, the
layout K1 reads.
"""
from __future__ import annotations

import torch

from gd3d_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)


def _rope1d_plain(tokens: torch.Tensor, pos1d: torch.Tensor, base: float, f0: float):
    """tokens (B, H, N, D), pos1d (B, N) int; cos and sin in the tokens'
    dtype, as gd3d's rope2d_xla."""
    D = tokens.shape[-1]
    exponent = torch.arange(0, D, 2, dtype=torch.float32, device=tokens.device) / D
    inv_freq = f0 / (base ** exponent)
    angles = pos1d[..., None].to(torch.float32) * inv_freq  # (B, N, D/2)
    angles = torch.cat([angles, angles], dim=-1)
    cos = torch.cos(angles).to(tokens.dtype)[:, None]
    sin = torch.sin(angles).to(tokens.dtype)[:, None]
    x1, x2 = tokens.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return tokens * cos + rot * sin


def rope2d_plain(tokens: torch.Tensor, positions: torch.Tensor, base: float = 100.0,
                 f0: float = 1.0) -> torch.Tensor:
    """tokens (B, H, N, D) with D % 4 == 0, positions (B, N, 2) as (y, x)."""
    y, x = tokens.chunk(2, dim=-1)
    y = _rope1d_plain(y, positions[:, :, 0], base, f0)
    x = _rope1d_plain(x, positions[:, :, 1], base, f0)
    return torch.cat([y, x], dim=-1)


def rope2d_fwd(tokens: torch.Tensor, positions: torch.Tensor, base: float = 100.0,
               f0: float = 1.0) -> torch.Tensor:
    """K5 (the backward is this with -f0). CPU tensors run the plain twin;
    CUDA tensors launch the kernel. tokens (B, H, N, D), any strides with a
    contiguous last dim; positions (B or 1, N, 2) integers, any strides.
    Returns (B, H, N, D) stored in (B, N, H, D) order."""
    if tokens.device.type == "cpu":
        return rope2d_plain(tokens, positions, base, f0)
    if tokens.dim() != 4 or tokens.shape[-1] % 4 or tokens.stride(-1) != 1:
        raise ValueError(f"rope2d takes (B, H, N, D) tokens with D % 4 == 0 and a "
                         f"contiguous last dim, got shape {tuple(tokens.shape)} "
                         f"strides {tokens.stride()}")
    if tokens.dtype not in DTYPES:
        raise ValueError(f"rope2d takes tokens of {DTYPES}, got {tokens.dtype}")
    B, H, N, D = tokens.shape
    if (positions.device != tokens.device or positions.dtype != torch.int64
            or positions.dim() != 3 or positions.shape[1:] != (N, 2)
            or positions.shape[0] not in (1, B)):
        raise ValueError(f"rope2d takes int64 positions (B, {N}, 2) on {tokens.device}, "
                         f"got {positions.dtype} {tuple(positions.shape)} on "
                         f"{positions.device}")
    out = torch.empty((B, N, H, D), dtype=tokens.dtype, device=tokens.device)
    psb = positions.stride(0) if positions.shape[0] == B else 0
    stream = torch.cuda.current_stream(tokens.device).cuda_stream
    err = build.library().gd3d_rope2d(
        tokens.data_ptr(), out.data_ptr(), positions.data_ptr(), B, N, H, D,
        tokens.stride(0), tokens.stride(2), tokens.stride(1),
        out.stride(0), out.stride(1), out.stride(2),
        psb, positions.stride(1), positions.stride(2),
        float(base), float(f0), int(tokens.dtype == torch.bfloat16), stream)
    build.check(err, "rope2d_fwd")
    rope2d_fwd.launches += 1
    return out.transpose(1, 2)


rope2d_fwd.launches = 0


class RoPE2D(torch.autograd.Function):
    """Forward K5 with f0; backward K5 with -f0 on the incoming gradient."""

    @staticmethod
    def forward(ctx, tokens, positions, base, f0):
        ctx.save_for_backward(positions)
        ctx.base, ctx.f0 = base, f0
        return rope2d_fwd(tokens, positions, base, f0)

    @staticmethod
    def backward(ctx, g):
        (positions,) = ctx.saved_tensors
        if g.stride(-1) != 1:  # e.g. the expanded gradient of a sum
            g = g.contiguous()
        return rope2d_fwd(g, positions, ctx.base, -ctx.f0), None, None, None
