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

The kernels visit only the valid keypoints of a view, compacted into
scratch, and split the streamed keypoints of a pair into `stream_chunks`
chunks across the grid; per-chunk partial sums go to scratch too and are
summed by the kernels in a fixed order (no atomics: the same bits from run
to run). `scratch_floats` is the size of that scratch; the wrappers allocate
it per call with `torch.empty`. The kernels take any hidden width h: up to
128 a lane holds its part of a row in registers, above it a kernel of its
own walks the row in chunks of 128 units (`padded_hidden`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gd3d_torch.kernels import build

CHUNK_HIDDEN = 128  # the wide kernel's hidden chunk; up to it, rows are held padded to 32
BWD_ROWS_PER_BLOCK = 4  # warps per block of the backward passes: one owned row each
TARGET_WARPS = 4096     # owned rows x chunks the grid should reach: ~8 per scheduler


def stream_chunks(B: int, N: int) -> int:
    """Into how many chunks the kernels split the streamed keypoints, so that
    B * N owned rows times the chunks give the card's 528 schedulers several
    warps each, with at least 32 keypoints a chunk."""
    return max(1, min(math.ceil(TARGET_WARPS / (B * N)), math.ceil(N / 32)))


def _align4(n: int) -> int:
    return (n + 3) // 4 * 4


def padded_hidden(h: int) -> int:
    """The hidden width the kernels hold for width h: h rounded up to 32,
    and above 128 (the wide kernel's chunks) up to 128."""
    step = 32 if h <= CHUNK_HIDDEN else CHUNK_HIDDEN
    return (h + step - 1) // step * step


def scratch_floats(B: int, N: int, h: int, n_chunks: int, backward: bool) -> int:
    """fp32 elements of scratch for one forward or backward call at hidden
    width h (PrScratch in csrc/pairwise_rank.cu, at `padded_hidden(h)`): the
    compacted view (rows, depths, upstream gradients, keypoint indices, the
    count of valid keypoints) and the per-chunk partials: row sums and counts
    forward; both roles of du and the per-block parameter-gradient partials
    backward."""
    h = padded_hidden(h)
    total = _align4(B * N * h) + 3 * _align4(B * N) + _align4(B)
    if backward:
        blocks = B * math.ceil(N / BWD_ROWS_PER_BLOCK) * n_chunks
        return total + 2 * _align4(B * N * n_chunks * h) + _align4(blocks * (4 * h + 1))
    return total + 2 * _align4(B * N * n_chunks)


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


def _f32(t):
    """`t` as contiguous fp32, itself where it already is."""
    return t if t.dtype is torch.float32 and t.is_contiguous() else t.float().contiguous()


def _prep(u, bias, ln_s, ln_b, w_out, b_out, depths, valid, *rest):
    """The operands as the kernels read them (contiguous fp32, u on 16 bytes,
    the head's vectors flat, u and the first four vectors zero-padded to
    `padded_hidden` units, each vector on 16 bytes), checked: one device, a
    hidden width of at least 1, shapes that fit u's (B, N, h). `rest` is the
    backward's grad_rows."""
    B, N, h = u.shape
    if h < 1:
        raise ValueError(f"pairwise_rank takes hidden widths of at least 1, got {h}")
    head = tuple(_f32(p).reshape(-1) for p in (bias, ln_s, ln_b, w_out, b_out))
    rows = tuple(_f32(t) for t in (depths, valid, *rest))
    for t, shape in (*((p, (h,)) for p in head[:4]), (head[4], (1,)),
                     *((t, (B, N)) for t in rows)):
        if t.shape != shape or t.device != u.device:
            raise ValueError(f"pairwise_rank: operands must fit u {tuple(u.shape)} on "
                             f"{u.device}: got {tuple(t.shape)} on {t.device}, want {shape}")
    pad = padded_hidden(h) - h
    u = _f32(u)
    if pad:
        u = F.pad(u, (0, pad))
        head = (*(F.pad(p, (0, pad)) for p in head[:4]), head[4])
    u, *head = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (u, *head))
    return (u, tuple(head), *rows)


def pairwise_rank_fwd(u, bias, ln_s, ln_b, w_out, b_out, depths, valid,
                      thr: float, eps: float = 1e-5):
    """K4 forward -> (row sums, row counts), (B, N) fp32. CPU tensors run the
    plain twin; CUDA tensors launch the kernel."""
    if u.device.type == "cpu":
        return pairwise_rank_sums_plain(u, bias, ln_s, ln_b, w_out, b_out, depths,
                                        valid, thr, eps)
    h = u.shape[-1]
    u, head, depths, valid = _prep(u, bias, ln_s, ln_b, w_out, b_out, depths, valid)
    B, N, _ = u.shape
    row_sum = torch.empty((B, N), dtype=torch.float32, device=u.device)
    row_cnt = torch.empty((B, N), dtype=torch.float32, device=u.device)
    n_chunks = stream_chunks(B, N)
    scratch = torch.empty(scratch_floats(B, N, h, n_chunks, False), dtype=torch.float32,
                          device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = build.library().gd3d_pairwise_rank_fwd(
        u.data_ptr(), depths.data_ptr(), valid.data_ptr(),
        *(p.data_ptr() for p in head), row_sum.data_ptr(), row_cnt.data_ptr(),
        scratch.data_ptr(), B, N, h, n_chunks, float(thr), float(eps), stream)
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
    """K4 backward (compaction, row pass, column pass, partial sums): the
    gradients of sum(row_sums * grad_rows) w.r.t. (u, bias, ln_s, ln_b, w_out, b_out),
    fp32. CUDA tensors only."""
    if not u.is_cuda:
        raise ValueError("pairwise_rank_bwd launches a CUDA kernel; got CPU tensors")
    h = u.shape[-1]
    u, head, depths, valid, grad_rows = _prep(u, bias, ln_s, ln_b, w_out, b_out, depths,
                                              valid, grad_rows)
    B, N, hp = u.shape
    du = torch.empty_like(u)
    n_chunks = stream_chunks(B, N)
    scratch = torch.empty(scratch_floats(B, N, h, n_chunks, True), dtype=torch.float32,
                          device=u.device)
    pgrad = torch.empty(4 * hp + 1, dtype=torch.float32, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = build.library().gd3d_pairwise_rank_bwd(
        u.data_ptr(), depths.data_ptr(), valid.data_ptr(),
        *(p.data_ptr() for p in head), grad_rows.data_ptr(), du.data_ptr(),
        scratch.data_ptr(), pgrad.data_ptr(), B, N, h, n_chunks, float(thr), float(eps),
        stream)
    build.check(err, "pairwise_rank_bwd")
    pairwise_rank_bwd.launches += 1
    dbias, dln_s, dln_b, dw_out = pgrad[:4 * hp].reshape(4, hp)[:, :h]
    return du[..., :h], dbias, dln_s, dln_b, dw_out, pgrad[4 * hp:]


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
