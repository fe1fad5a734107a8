"""K5: RoPE2D, forward and backward, on one tensor or on q and k at once.

Wrapper of the CUDA kernel in gd3d_torch/csrc/rope2d.cu, which replaces
gd3d/kernels/rope2d.py::_rope2d_call (the Pallas `_rope2d_kernel`, reached
through `rope2d_pallas`). `rope2d_plain` is its plain PyTorch twin, the
formula of gd3d's `rope2d_xla`: the CPU path, and the oracle the kernel is
checked against. The backward is the same kernel with -f0.

Tokens are (B, H, N, D) at the public functions, as in gd3d. The kernel
reads them through strides, so the transposed (B, N, H, D) views the models
hold are not copied, and it writes its output in (B, N, H, D) memory order:
the models transpose it back to a contiguous (B, N, H, D) tensor, the
layout K1 reads. The kernel reads and writes `vec_width(D, dtype)` elements
at a time (16 bytes where D allows), so a view's address and its (B, N, H)
steps must be multiples of that many elements; a view that is not (or whose
last dim is strided) is copied to a fresh contiguous tensor first. The
output is a new tensor either way, so nothing is copied back.
"""
from __future__ import annotations

from collections import Counter

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


def vec_width(D: int, dtype: torch.dtype) -> int:
    """Elements per load and store of the kernel: the widest power of two
    that divides D / 4 and spans at most 16 bytes."""
    vec = 16 // (4 if dtype == torch.float32 else 2)
    while (D // 4) % vec:
        vec //= 2
    return vec


def _aligned(t: torch.Tensor, vec: int) -> bool:
    """Whether the view's address and its (B, H, N) steps (of a dim longer
    than 1) fall on `vec` elements."""
    vb = vec * t.element_size()
    return t.data_ptr() % vb == 0 and all(
        n == 1 or (s * t.element_size()) % vb == 0 for n, s in zip(t.shape[:3], t.stride()[:3]))


def fit_view(tokens: torch.Tensor) -> torch.Tensor:
    """`tokens` itself where K5 reads it as it is (or where `check_view`
    refuses it for its shape or dtype), else a fresh contiguous copy."""
    if tokens.dim() != 4 or tokens.shape[-1] % 4 or tokens.dtype not in DTYPES:
        return tokens
    if tokens.stride(-1) == 1 and _aligned(tokens, vec_width(tokens.shape[-1], tokens.dtype)):
        return tokens
    return tokens.clone(memory_format=torch.contiguous_format)


def check_view(tokens: torch.Tensor) -> int:
    """The layout K5 takes, on any device: (B, H, N, D) tokens of an fp32 or
    bf16 dtype with D % 4 == 0, a contiguous last dim, and an address and
    (B, H, N) steps on `vec_width` elements. Returns the vector width. It
    raises where a view does not fit (the wrappers pass it views that
    `fit_view` made fit)."""
    if tokens.dim() != 4 or tokens.shape[-1] % 4 or tokens.stride(-1) != 1:
        raise ValueError(f"rope2d takes (B, H, N, D) tokens with D % 4 == 0 and a "
                         f"contiguous last dim, got shape {tuple(tokens.shape)} "
                         f"strides {tokens.stride()}")
    if tokens.dtype not in DTYPES:
        raise ValueError(f"rope2d takes tokens of {DTYPES}, got {tokens.dtype}")
    vec = vec_width(tokens.shape[-1], tokens.dtype)
    if not _aligned(tokens, vec):
        vb = vec * tokens.element_size()
        raise ValueError(f"rope2d reads {vb}-byte vectors at D={tokens.shape[-1]}: the "
                         f"{tokens.dtype} view's address and its (B, H, N) steps must fall "
                         f"on {vb} bytes, got offset {tokens.data_ptr() % vb} strides "
                         f"{tokens.stride()}")
    return vec


def _check_positions(positions: torch.Tensor, tokens: torch.Tensor) -> None:
    B, _, N, _ = tokens.shape
    if (positions.device != tokens.device or positions.dtype != torch.int64
            or positions.dim() != 3 or positions.shape[1:] != (N, 2)
            or positions.shape[0] not in (1, B)):
        raise ValueError(f"rope2d takes int64 positions (B, {N}, 2) on {tokens.device}, "
                         f"got {positions.dtype} {tuple(positions.shape)} on "
                         f"{positions.device}")


def _task(tokens, positions):
    """The kernel's arguments for one tensor, and its fresh (B, N, H, D)
    output."""
    B, H, N, D = tokens.shape
    out = torch.empty((B, N, H, D), dtype=tokens.dtype, device=tokens.device)
    ps = positions.stride()
    args = (tokens.data_ptr(), out.data_ptr(), positions.data_ptr(), B, N, H,
            tokens.stride(0), tokens.stride(2), tokens.stride(1),
            ps[0] if positions.shape[0] == B else 0, ps[1], ps[2])
    return out, args


_NO_TASK = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)


def _launch(what, tokens, tasks, vec, base, f0):
    stream = torch.cuda.current_stream(tokens.device).cuda_stream
    err = build.library().gd3d_rope2d(
        len(tasks), *tasks[0], *(tasks[1] if len(tasks) > 1 else _NO_TASK),
        tokens.shape[-1], vec, float(base), float(f0), int(tokens.dtype == torch.bfloat16),
        stream)
    build.check(err, what)
    rope2d_fwd.launches += 1
    rope2d_fwd.launches_bwd += int(f0 < 0)
    rope2d_fwd.launches_by[(str(tokens.dtype).removeprefix("torch."), tokens.shape[2])] += 1


def rope2d_fwd(tokens: torch.Tensor, positions: torch.Tensor, base: float = 100.0,
               f0: float = 1.0) -> torch.Tensor:
    """K5 (the backward is this with -f0). CPU tensors run the plain twin;
    CUDA tensors launch the kernel. tokens (B, H, N, D), D % 4 == 0, any
    strides; positions (B or 1, N, 2) int64, any strides. Returns
    (B, H, N, D) stored in (B, N, H, D) order."""
    if tokens.device.type == "cpu":
        return rope2d_plain(tokens, positions, base, f0)
    tokens = fit_view(tokens)
    vec = check_view(tokens)
    _check_positions(positions, tokens)
    out, task = _task(tokens, positions)
    _launch("rope2d_fwd", tokens, (task,), vec, base, f0)
    return out.transpose(1, 2)


rope2d_fwd.launches = 0
rope2d_fwd.launches_bwd = 0  # of `launches`, those with -f0: a backward
rope2d_fwd.launches_by = Counter()  # (dtype, N of q) -> launches


def rope2d_qk_fwd(q: torch.Tensor, qpos: torch.Tensor, k: torch.Tensor, kpos: torch.Tensor,
                  base: float = 100.0, f0: float = 1.0):
    """K5 on q and k in one launch: (rope2d_fwd(q, qpos), rope2d_fwd(k,
    kpos)). q and k share the dtype and D; their B, H, N, strides and
    positions may differ. CPU tensors run the plain twin twice. Counts one
    launch of K5."""
    if q.device.type == "cpu":
        return rope2d_plain(q, qpos, base, f0), rope2d_plain(k, kpos, base, f0)
    if k.device != q.device or k.dtype != q.dtype or k.shape[-1:] != q.shape[-1:]:
        raise ValueError(f"rope2d_qk takes q and k of one device, dtype and D, got "
                         f"{q.device} {q.dtype} {tuple(q.shape)} and {k.device} {k.dtype} "
                         f"{tuple(k.shape)}")
    q, k = fit_view(q), fit_view(k)
    vec = check_view(q)
    check_view(k)
    _check_positions(qpos, q)
    _check_positions(kpos, k)
    q_out, q_task = _task(q, qpos)
    k_out, k_task = _task(k, kpos)
    _launch("rope2d_qk_fwd", q, (q_task, k_task), vec, base, f0)
    return q_out.transpose(1, 2), k_out.transpose(1, 2)


class RoPE2DQK(torch.autograd.Function):
    """K5 on q and k in one launch (or on q alone when k is None), forward
    with f0; the backward rotates both incoming gradients with -f0 in one
    launch, or the one that is not None."""

    @staticmethod
    def forward(ctx, q, qpos, k, kpos, base, f0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(qpos, kpos)
        ctx.base, ctx.f0 = base, f0
        if k is None:
            return rope2d_fwd(q, qpos, base, f0), None
        return rope2d_qk_fwd(q, qpos, k, kpos, base, f0)

    @staticmethod
    def backward(ctx, gq, gk):
        qpos, kpos = ctx.saved_tensors
        base, f0 = ctx.base, -ctx.f0
        if gq is not None and gk is not None:
            gq, gk = rope2d_qk_fwd(gq, qpos, gk, kpos, base, f0)
        elif gq is not None:
            gq = rope2d_fwd(gq, qpos, base, f0)
        elif gk is not None:
            gk = rope2d_fwd(gk, kpos, base, f0)
        return gq, None, gk, None, None, None
