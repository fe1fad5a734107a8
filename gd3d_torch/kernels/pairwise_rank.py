"""K4: fused pairwise depth-ranking loss.

Wrapper of the CUDA kernels in gd3d_torch/csrc/pairwise_rank.cu, which
replace gd3d/kernels/pairwise_rank.py: the forward `_fwd_kernel` and the
row and column backward passes of `_vjp_bwd`. For every keypoint pair
(i, j) of a view, with u the head's first Linear applied per keypoint,

    score[i, j] = tanh(w_out . gelu(LN(u[j] - u[i] + bias)) + b_out)
    loss[i, j]  = log1p(exp(-sign(d_j - d_i) * score[i, j]))

summed over the valid pairs (|d_j - d_i| > thr, both keypoints valid).
Outputs are per-row (per i) loss sums and valid-pair counts, (B, N) each;
callers sum them per view. `pairwise_rank_sums_plain` is the plain PyTorch
twin (gd3d's `_reference`, per row): the CPU path, and the oracle.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gd3d_torch.kernels import build

HIDDEN = (32, 64, 96, 128)
ROWS_PER_BLOCK = 8  # warps per block in the kernel: one owned row each


def pairwise_rank_sums_plain(u, bias, ln_s, ln_b, w_out, b_out, depths, valid,
                             thr: float, eps: float = 1e-5):
    """Per-row (loss sum, valid-pair count), each (B, N), in fp32. Autograd
    differentiates it."""
    u = u.float()
    diff = u[:, None, :, :] - u[:, :, None, :] + bias  # [b, i, j] = u_j - u_i + bias
    mu = diff.mean(-1, keepdim=True)
    var = ((diff - mu) ** 2).mean(-1, keepdim=True)
    y = (diff - mu) * torch.rsqrt(var + eps) * ln_s + ln_b
    score = torch.tanh((F.gelu(y) * w_out).sum(-1) + b_out.reshape(()))
    di, dj = depths[:, :, None], depths[:, None, :]
    alpha = torch.sign(dj - di)
    valid = valid > 0
    pv = ((dj - di).abs() > thr) & valid[:, :, None] & valid[:, None, :]
    pvf = pv.to(score.dtype)
    loss = torch.log1p(torch.exp(-alpha * score))
    return (loss * pvf).sum(-1), pvf.sum(-1)


def _check(u, head, depths, valid, *rest):
    B, N, h = u.shape
    if h not in HIDDEN:
        raise ValueError(f"pairwise_rank takes hidden width in {HIDDEN}, got {h}")
    for name, t, shape in (("u", u, (B, N, h)), ("depths", depths, (B, N)),
                           ("valid", valid, (B, N)),
                           *((f"head[{i}]", p, (h,)) for i, p in enumerate(head[:4])),
                           ("b_out", head[4], (1,)),
                           *(("grad_rows", t, (B, N)) for t in rest)):
        if (t.device != u.device or t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"pairwise_rank: {name} must be contiguous fp32 {shape} on "
                             f"{u.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _prep(u, bias, ln_s, ln_b, w_out, b_out, depths, valid):
    head = tuple(p.float().reshape(-1).contiguous() for p in (bias, ln_s, ln_b, w_out, b_out))
    return (u.float().contiguous(), head, depths.float().contiguous(),
            valid.float().contiguous())


def pairwise_rank_fwd(u, bias, ln_s, ln_b, w_out, b_out, depths, valid,
                      thr: float, eps: float = 1e-5):
    """K4 forward -> (row sums, row counts), (B, N) fp32. CPU tensors run the
    plain twin; CUDA tensors launch the kernel."""
    if u.device.type == "cpu":
        return pairwise_rank_sums_plain(u, bias, ln_s, ln_b, w_out, b_out, depths,
                                        valid, thr, eps)
    u, head, depths, valid = _prep(u, bias, ln_s, ln_b, w_out, b_out, depths, valid)
    _check(u, head, depths, valid)
    B, N, h = u.shape
    row_sum = torch.empty((B, N), dtype=torch.float32, device=u.device)
    row_cnt = torch.empty((B, N), dtype=torch.float32, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = build.library().gd3d_pairwise_rank_fwd(
        u.data_ptr(), depths.data_ptr(), valid.data_ptr(),
        *(p.data_ptr() for p in head), row_sum.data_ptr(), row_cnt.data_ptr(),
        B, N, h, float(thr), float(eps), stream)
    build.check(err, "pairwise_rank_fwd")
    pairwise_rank_fwd.launches += 1
    return row_sum, row_cnt


pairwise_rank_fwd.launches = 0


def pairwise_rank_bwd_plain(u, bias, ln_s, ln_b, w_out, b_out, depths, valid, grad_rows,
                            thr: float, eps: float = 1e-5):
    """Gradients of sum(row_sums * grad_rows) w.r.t. (u, bias, ln_s, ln_b,
    w_out, b_out) through autograd of the plain twin."""
    with torch.enable_grad():
        ins = [t.detach().float().requires_grad_(True)
               for t in (u, bias, ln_s, ln_b, w_out, b_out)]
        sums, _ = pairwise_rank_sums_plain(*ins, depths, valid, thr, eps)
        grads = torch.autograd.grad((sums * grad_rows).sum(), ins, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g for g, x in zip(grads, ins))


def pairwise_rank_bwd(u, bias, ln_s, ln_b, w_out, b_out, depths, valid, grad_rows,
                      thr: float, eps: float = 1e-5):
    """K4 backward (row pass, column pass, partial sums): the gradients of
    sum(row_sums * grad_rows) w.r.t. (u, bias, ln_s, ln_b, w_out, b_out),
    fp32. CUDA tensors only."""
    u, head, depths, valid = _prep(u, bias, ln_s, ln_b, w_out, b_out, depths, valid)
    grad_rows = grad_rows.float().contiguous()
    if not u.is_cuda:
        raise ValueError("pairwise_rank_bwd launches a CUDA kernel; got CPU tensors")
    _check(u, head, depths, valid, grad_rows)
    B, N, h = u.shape
    du = torch.empty_like(u)
    n_blocks = B * math.ceil(N / ROWS_PER_BLOCK)
    partials = torch.empty((n_blocks, 4 * h + 1), dtype=torch.float32, device=u.device)
    pgrad = torch.empty(4 * h + 1, dtype=torch.float32, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = build.library().gd3d_pairwise_rank_bwd(
        u.data_ptr(), depths.data_ptr(), valid.data_ptr(),
        *(p.data_ptr() for p in head), grad_rows.data_ptr(), du.data_ptr(),
        partials.data_ptr(), pgrad.data_ptr(), B, N, h, float(thr), float(eps), stream)
    build.check(err, "pairwise_rank_bwd")
    pairwise_rank_bwd.launches += 1
    dbias, dln_s, dln_b, dw_out = pgrad[:4 * h].reshape(4, h)
    return du, dbias, dln_s, dln_b, dw_out, pgrad[4 * h:]


pairwise_rank_bwd.launches = 0


class _PairwiseRank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, bias, ln_s, ln_b, w_out, b_out, depths, valid, thr, eps):
        ctx.save_for_backward(u, bias, ln_s, ln_b, w_out, b_out, depths, valid)
        ctx.thr, ctx.eps = thr, eps
        sums, cnts = pairwise_rank_fwd(u, bias, ln_s, ln_b, w_out, b_out, depths, valid,
                                       thr, eps)
        ctx.mark_non_differentiable(cnts)
        return sums, cnts

    @staticmethod
    def backward(ctx, g_sums, g_cnts):
        u, bias, ln_s, ln_b, w_out, b_out, depths, valid = ctx.saved_tensors
        grads = pairwise_rank_bwd(u, bias, ln_s, ln_b, w_out, b_out, depths, valid,
                                  g_sums, ctx.thr, ctx.eps)
        shaped = [g.reshape(x.shape).to(x.dtype)
                  for g, x in zip(grads, (u, bias, ln_s, ln_b, w_out, b_out))]
        return (*shaped, None, None, None, None)


def pairwise_ranking_sums(u, bias, ln_scale, ln_bias, w_out, b_out, depths, valid,
                          depth_threshold: float, eps: float = 1e-5):
    """Per-row (loss sum, valid-pair count), (B, N) each (counterpart of
    gd3d's pairwise_ranking_sums_fused, which returns their per-view sums).

    u (B, N, h): the head's first Linear per keypoint; bias (h,): that
    Linear's bias (it commutes with the pair subtraction); ln_scale,
    ln_bias, w_out (h,), b_out (1,): the rest of the head."""
    if u.device.type == "cpu":
        return pairwise_rank_sums_plain(u, bias, ln_scale, ln_bias, w_out, b_out,
                                        depths, valid, float(depth_threshold), float(eps))
    return _PairwiseRank.apply(u, bias, ln_scale, ln_bias, w_out, b_out, depths, valid,
                               float(depth_threshold), float(eps))
