"""K1: flash-attention forward with the row log-sum-exp.

Wrapper of the CUDA kernel in gd3d_torch/csrc/flash_fwd.cu, which replaces
the stock TPU Pallas flash forward that gd3d reaches through
gd3d/ops/attention.py::_flash_call. `flash_attention_fwd_plain` is its plain
PyTorch twin: the CPU path, and the oracle the kernel is checked against.
"""
from __future__ import annotations

import torch

from gd3d_torch.kernels import build

HEAD_DIMS = (64, 128)  # K1 takes both; K2 takes 64 only
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_fwd_plain(q, k, v, scale: float):
    """(B, N, H, D) x (B, M, H, D) -> O (B, N, H, D) in q's dtype and LSE
    (B, H, N) fp32, computed in fp32."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhnm,bmhd->bnhd", p, v.float())
    return o.to(q.dtype), lse


def aligned_16(t: torch.Tensor) -> bool:
    """Whether the kernels' 16-byte cp.async copies can read the
    (B, N, H, D) view `t`: its first element and every step along B, N and H
    (of a dim longer than 1) fall on 16 bytes."""
    elt = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or (s * elt) % 16 == 0 for n, s in zip(t.shape[:3], t.stride()[:3]))


def check_views(*ts: torch.Tensor, head_dims=HEAD_DIMS, fp32_copies_16: bool = False) -> None:
    """The layout the flash kernels take, on any device: tensors of one dtype
    (fp32 or bf16), (B, N, H, D) with D in `head_dims` and a contiguous last
    dim. bf16 views must be `aligned_16`, and with `fp32_copies_16` (K1, whose
    fp32 head-dim-64 kernel copies 16 bytes at a time) fp32 views of head dim
    64 too. Nothing is copied to make a view fit: it raises."""
    t0 = ts[0]
    for t in ts:
        if t.dtype != t0.dtype or t.dtype not in DTYPES:
            raise ValueError(f"flash kernels take one dtype of {DTYPES}, got "
                             f"{[x.dtype for x in ts]}")
        if (t.dim() != 4 or t.shape[-1] not in head_dims or t.shape[-1] != t0.shape[-1]
                or t.stride(-1) != 1):
            raise ValueError(f"flash kernels take (B, N, H, D) views with D in "
                             f"{head_dims} and a contiguous last dim, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
        copies_16 = t.dtype == torch.bfloat16 or (fp32_copies_16 and t.shape[-1] == 64)
        if copies_16 and not aligned_16(t):
            raise ValueError(f"this flash kernel copies 16-byte chunks: the "
                             f"{t.dtype} view's address and its (B, N, H) steps must "
                             f"fall on 16 bytes, got offset {t.data_ptr() % 16} strides "
                             f"{t.stride()}")


def check_operands(*ts: torch.Tensor, **layout) -> None:
    """What the flash kernels take: CUDA tensors on one device, in the layout
    of `check_views`."""
    for t in ts:
        if not t.is_cuda or t.device != ts[0].device:
            raise ValueError(f"flash kernels need CUDA tensors on one device, "
                             f"got {t.device}")
    check_views(*ts, **layout)


def flash_attention_fwd(q, k, v, scale: float):
    """K1. CPU tensors run the plain twin; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, scale)
    check_operands(q, k, v, fp32_copies_16=True)
    B, N, H, D = q.shape
    M = k.shape[1]
    if k.shape != (B, M, H, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {q.shape} k {k.shape} v {v.shape}")
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.library().gd3d_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, N, M, H, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        float(scale), int(q.dtype == torch.bfloat16), stream)
    build.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
