"""K3: fused masked-softmax + KL per cost-volume row.

Wrapper of the CUDA kernel in gd3d_torch/csrc/cost_kl.cu, which replaces
gd3d/kernels/cost_kl.py::_fwd_impl (the Pallas `_kl_kernel`).
`_reference_rows` is the plain PyTorch twin. The backward is the analytic
formula of gd3d's `_vjp_bwd` in plain torch, as in gd3d, w.r.t. the
student cost only (the teacher map is frozen).
"""
from __future__ import annotations

import torch

from gd3d_torch.kernels import build


def _reference_rows(teacher_p, student_cost, row_mask, eps):
    """Per-row KL(max(teacher, eps) || max(softmax(masked cost), eps))."""
    masked = torch.where(row_mask[..., None], student_cost,
                         torch.zeros((), dtype=student_cost.dtype,
                                     device=student_cost.device))
    q = torch.softmax(masked.float(), dim=-1)
    pc = torch.clamp(teacher_p, min=eps)
    qc = torch.clamp(q, min=eps)
    return (pc * torch.log(pc / qc)).sum(-1)


def masked_softmax_kl_fwd(teacher_p, student_cost, row_mask, eps: float = 1e-8):
    """K3 forward -> (B, N) fp32. CPU tensors run the plain twin; CUDA
    tensors launch the kernel."""
    if student_cost.device.type == "cpu":
        return _reference_rows(teacher_p, student_cost, row_mask, eps)
    B, N, M = student_cost.shape
    for name, t, dt in (("teacher_p", teacher_p, torch.float32),
                        ("student_cost", student_cost, torch.float32),
                        ("row_mask", row_mask, torch.bool)):
        want = (B, N, M) if t.dim() == 3 else (B, N)
        if (not t.is_cuda or t.device != student_cost.device or t.dtype != dt
                or tuple(t.shape) != want or not t.is_contiguous()):
            raise ValueError(f"{name}: need contiguous {dt} {want} on "
                             f"{student_cost.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if (teacher_p.data_ptr() - student_cost.data_ptr()) % 16:
        raise ValueError("teacher_p and student_cost: the kernel reads both maps in 16-byte "
                         "vectors at one index, so their addresses must agree modulo 16, got "
                         f"{teacher_p.data_ptr() % 16} and {student_cost.data_ptr() % 16}")
    out =torch.empty((B, N), dtype=torch.float32, device=student_cost.device)
    stream = torch.cuda.current_stream(student_cost.device).cuda_stream
    err = build.library().gd3d_cost_kl(
        teacher_p.data_ptr(), student_cost.data_ptr(), row_mask.data_ptr(),
        out.data_ptr(), B, N, M, float(eps), stream)
    build.check(err, "masked_softmax_kl_fwd")
    masked_softmax_kl_fwd.launches += 1
    return out


masked_softmax_kl_fwd.launches = 0


class _MaskedSoftmaxKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, teacher_p, student_cost, row_mask, eps):
        ctx.save_for_backward(teacher_p, student_cost, row_mask)
        ctx.eps = eps
        return masked_softmax_kl_fwd(teacher_p, student_cost, row_mask, eps)

    @staticmethod
    def backward(ctx, g):
        teacher_p, student_cost, row_mask = ctx.saved_tensors
        eps = ctx.eps
        zero = torch.zeros((), dtype=student_cost.dtype, device=student_cost.device)
        q = torch.softmax(torch.where(row_mask[..., None], student_cost, zero), -1)
        pc = torch.clamp(teacher_p, min=eps)
        # d/dq of -pc * log(max(q, eps)): the clamp gates the gradient
        u = torch.where(q > eps, -pc / torch.clamp(q, min=eps), zero)
        u = u * g[..., None]
        dmasked = q * (u - (u * q).sum(-1, keepdim=True))
        dcost = torch.where(row_mask[..., None], dmasked, zero)
        return None, dcost, None, None


def masked_softmax_kl_rows(teacher_p, student_cost, row_mask, eps: float = 1e-8):
    """Per-row KL(teacher || masked-softmax(student)) -> (B, N).

    teacher_p (B, N, M) row-normalized, student_cost (B, N, M) raw
    similarities, row_mask (B, N) bool. Inputs are taken to fp32, and a map
    off a 16-byte address is copied (K3 reads both maps in 16-byte vectors
    at one index)."""
    maps = [t.float().contiguous() for t in (teacher_p, student_cost)]
    maps = [t.clone() if t.data_ptr() % 16 else t for t in maps]
    return _MaskedSoftmaxKL.apply(*maps, row_mask.contiguous(), eps)
