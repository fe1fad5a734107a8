"""K2: flash-attention backward (dQ, dK, dV).

Wrapper of the CUDA kernels in gd3d_torch/csrc/flash_bwd_sm90.cu (bf16 at
every kernel width, 64, 128 and 256: TMA, wgmma and warp specialisation),
flash_bwd.cu (fp32 at 64) and flash_bwd_tf32_wide.cu (fp32 at 128 and 256),
both three TF32 products for each fp32 one on the tensor cores, which
replace gd3d/kernels/flash_bwd_fused.py::
flash_attention_bwd_fused. gd3d's kernel sums per-KV-block dQ partials
after one pass; the port runs a dK/dV kernel and a second, dQ kernel (see
the source notes), which is deterministic. The wrapper zero-pads q, k, v
and dO along other head dims to the next of the three widths (`bwd_padded`;
exact, as for K1, and the padded columns of dQ, dK and dV come out 0 and
are cut off), and copies a view the kernels cannot read as it is first
(`fit_views`). A failed build or launch raises; nothing falls back.
`flash_attention_bwd_plain` is the plain PyTorch twin.
"""
from __future__ import annotations

from collections import Counter

import torch

from gd3d_torch.kernels import build
from gd3d_torch.kernels.flash_fwd import check_operands, fit_views, kernel_width, pad_head_dim


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
    """K2's route at any head dim D up to 256: `run` (the kernels' launch, or
    a plain twin) on q, k, v and dO zero-padded along D to the kernel width
    (64, 128 or 256), with the caller's scale; dQ, dK and dV cut back to D
    columns. di = rowsum(O * dO) is the same either way."""
    D = q.shape[-1]
    width = kernel_width(D)
    if width == D:
        return run(q, k, v, lse, do, di, scale)
    q, k, v, do = pad_head_dim(width, q, k, v, do)
    return tuple(g[..., :D] for g in run(q, k, v, lse, do, di, scale))


def _launch(q, k, v, lse, do, di, scale: float):
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
    flash_attention_bwd_fused.launches_by[(str(q.dtype).removeprefix("torch."), N)] += 1
    return dq, dk, dv


def flash_attention_bwd_fused(q, k, v, lse, do, di, scale: float):
    """K2. CPU tensors run the plain twin; CUDA tensors launch the kernels
    (through `bwd_padded`)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, lse, do, di, scale)
    return bwd_padded(_launch, q, k, v, lse, do, di, scale)


flash_attention_bwd_fused.launches = 0
flash_attention_bwd_fused.launches_by = Counter()  # (dtype, N) -> launches
