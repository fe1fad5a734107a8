"""K2: flash-attention backward (dQ, dK, dV).

Wrapper of the CUDA kernels in gd3d_torch/csrc/flash_bwd_sm90.cu (bf16 at
every kernel width, 64, 128 and 256: TMA, wgmma and warp specialisation),
flash_bwd.cu (fp32 at 64) and flash_bwd_tf32_wide.cu (fp32 at 128 and 256),
both three TF32 products for each fp32 one on the tensor cores, and
flash_chunked.cu (both dtypes above 256: column chunks on the CUDA cores,
dQ, dK and dV in one launch), which replace gd3d/kernels/flash_bwd_fused.py::
flash_attention_bwd_fused. gd3d's kernel sums per-KV-block dQ partials
after one pass; the port runs a dK/dV kernel and a second, dQ kernel (see
the source notes), which is deterministic. K1's routing rule
(kernels/flash_fwd.py::runs_direct) routes each head dim: where a row of D
elements is a multiple of 16 bytes the kernels read the caller's q, k, v
and dO at the width `kernel_width(D)` (zero-filled past D) and write D
columns of dQ, dK and dV (the direct route); any other D takes the pad
route (`bwd_padded`: q, k, v and dO zero-padded along D to the width, dQ,
dK and dV cut back; exact, as for K1). A view the kernels cannot read as
it is is copied first (`fit_views`). A failed build or a refused launch
raises; nothing falls back.
`flash_attention_bwd_plain` is the plain PyTorch twin.
"""
from __future__ import annotations

from collections import Counter
from functools import partial

import torch

from gd3d_torch.kernels import build
from gd3d_torch.kernels.flash_fwd import (
    check_operands, fit_views, kernel_width, pad_head_dim, runs_chunked, runs_direct)


def flash_attention_bwd_plain(q, k, v, lse, do, di, scale: float):
    """Recompute P from lse and form the gradients in fp32.

    q, do (B, N, H, D); k, v (B, M, H, D); lse, di (B, H, N) fp32 with
    di = rowsum(O * dO). Returns (dq, dk, dv) in the operands' dtype."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dof)
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    ds = p * (dp - di[..., None]) * scale
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_padded(run, q, k, v, lse, do, di, scale: float):
    """K2's pad route at any head dim D: `run` (the kernels' launch, or a
    plain twin) on q, k, v and dO zero-padded along D to the kernel width
    (64, 128, 256, or above 256 a multiple of 8), with the caller's scale;
    dQ, dK and dV cut back to D columns. di = rowsum(O * dO) is the same
    either way."""
    D = q.shape[-1]
    width = kernel_width(D)
    if width == D:
        return run(q, k, v, lse, do, di, scale)
    q, k, v, do = pad_head_dim(width, q, k, v, do)
    return tuple(g[..., :D] for g in run(q, k, v, lse, do, di, scale))


def bwd_routed(run, q, k, v, lse, do, di, scale: float):
    """K2 by K1's routing rule: `run` on the operands as they are where their
    head dim runs direct, else through `bwd_padded`."""
    if runs_direct(q.shape[-1], q.dtype):
        return run(q, k, v, lse, do, di, scale)
    return bwd_padded(run, q, k, v, lse, do, di, scale)


def _launch(q, k, v, lse, do, di, scale: float, padded: bool = False):
    q, k, v, do = fit_views(q, k, v, do)
    check_operands(q, k, v, do, fp32_copies_16=True)
    B, N, H, D = q.shape
    M = k.shape[1]
    for name, t in (("lse", lse), ("di", di)):
        if (t.shape != (B, H, N) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 (B, H, N) on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)}")
    dq = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, M, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, M, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.library().gd3d_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, N, M, H, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        float(scale), int(q.dtype == torch.bfloat16), stream)
    build.check(err, "flash_attention_bwd_fused")
    flash_attention_bwd_fused.launches += 1
    flash_attention_bwd_fused.launches_padded += padded
    flash_attention_bwd_fused.launches_wide += runs_chunked(D)
    flash_attention_bwd_fused.launches_by[(str(q.dtype).removeprefix("torch."), N)] += 1
    return dq, dk, dv


def flash_attention_bwd_fused(q, k, v, lse, do, di, scale: float):
    """K2. CPU tensors run the plain twin; CUDA tensors launch the kernels,
    direct or on the pad route by `runs_direct`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, lse, do, di, scale)
    if runs_direct(q.shape[-1], q.dtype):
        return _launch(q, k, v, lse, do, di, scale)
    return bwd_padded(partial(_launch, padded=True), q, k, v, lse, do, di, scale)


flash_attention_bwd_fused.launches = 0
flash_attention_bwd_fused.launches_padded = 0  # of them, launches on the pad route
flash_attention_bwd_fused.launches_wide = 0  # of them, on the chunked kernels (as K1's)
flash_attention_bwd_fused.launches_by = Counter()  # (dtype, N) -> launches
