"""Distillation losses with padded-keypoint validity masks (counterpart of
the parts of gd3d/ops/losses.py that the MASt3R, VGGT and ME steps call)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from gd3d_torch.ops.basic import temp_sigmoid


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mean(x[mask]), or 0 when the mask is empty."""
    mask = mask.to(x.dtype)
    count = mask.sum()
    total = (x * mask).sum()
    return torch.where(count > 0, total / torch.clamp(count, min=1.0),
                       torch.zeros_like(total))


def pairwise_logistic_ranking_loss(
    score_diff: torch.Tensor,
    gt_depths: torch.Tensor,
    depth_threshold: float,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Masked mean of log(1 + exp(-sign(d_j - d_i) * score[b, i, j])) over
    pairs with |d_j - d_i| > threshold."""
    depth_i = gt_depths[:, :, None]
    depth_j = gt_depths[:, None, :]
    alpha = torch.sign(depth_j - depth_i)
    pair_valid = ((torch.abs(depth_j - depth_i) > depth_threshold)
                  & valid[:, :, None] & valid[:, None, :])
    loss = torch.log1p(torch.exp(-alpha * score_diff))
    return _masked_mean(loss, pair_valid)


def ap_loss_paired(
    desc_1: torch.Tensor,
    desc_2: torch.Tensor,
    pts3d_1: torch.Tensor,
    pts3d_2: torch.Tensor,
    valid: torch.Tensor,
    thres3d_neg: float = 0.1,
    temp: float = 0.01,
    legacy_rpos1: bool = False,
) -> torch.Tensor:
    """Smooth-AP matching loss for 1:1-paired keypoints: positives on the
    diagonal, negatives farther than thres3d_neg in 3D, two ranking
    directions averaged. legacy_rpos1: the VGGT module's first-direction
    rpos, sigmoid(1 - pos_sim) + 1, where the MASt3R module has
    sigmoid(pos_sim - 1) + 1 (gd3d's flag of the same name)."""
    B, N, _ = desc_1.shape
    sim = torch.einsum("bnc,bmc->bnm", desc_1, desc_2)
    dist = torch.linalg.vector_norm(
        pts3d_1[:, :, None, :] - pts3d_2[:, None, :, :], dim=-1)
    eye = torch.eye(N, dtype=torch.bool, device=desc_1.device)[None]
    neg_mask = (dist > thres3d_neg) & ~eye & valid[:, :, None] & valid[:, None, :]
    pos_sim = torch.diagonal(sim, dim1=1, dim2=2)
    negf = neg_mask.to(sim.dtype)

    rpos1 = temp_sigmoid((1.0 - pos_sim) if legacy_rpos1 else (pos_sim - 1.0), temp) + 1.0
    rall1 = rpos1 + (temp_sigmoid(sim - 1.0, temp) * negf).sum(-1)
    ap1 = rpos1 / rall1

    rpos2 = temp_sigmoid(1.0 - pos_sim, temp) + 1.0
    rall2 = rpos2 + (temp_sigmoid(sim - pos_sim[:, :, None], temp) * negf).sum(-1)
    ap2 = rpos2 / rall2

    return _masked_mean(1.0 - (ap1 + ap2) / 2.0, valid)


def first_true_indices(mask: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flat indices of the first n True entries of a 1-D bool mask, in
    order, and how many of the n slots are filled; the unfilled slots hold
    index 0. A cumulative-sum compaction: static shapes, no host sync, and
    the order torch.nonzero would give (gd3d takes them with a stable
    lax.top_k over the mask)."""
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    keep = mask & (rank < n)
    # every dropped entry lands in the spare slot n, which is cut off
    slot = torch.where(keep, rank, torch.full_like(rank, n))
    idx = torch.zeros(n + 1, dtype=torch.int64, device=mask.device)
    idx.scatter_(0, slot, torch.arange(mask.numel(), device=mask.device))
    return idx[:n], keep.sum()


def ap_loss_me(
    desc_1: torch.Tensor,
    desc_2: torch.Tensor,
    pts3d_1: torch.Tensor,
    pts3d_2: torch.Tensor,
    valid_1: Optional[torch.Tensor] = None,
    valid_2: Optional[torch.Tensor] = None,
    thresh3d_pos: float = 5e-3,
    thres3d_neg: float = 0.1,
    temp: float = 0.01,
    max_pos: int = 8192,
    return_overflow: bool = False,
):
    """Smooth-AP loss with distance-derived positives (the ME baseline):
    every (i, j) with 3D distance < thresh3d_pos is a positive, the
    negatives of source row i are the targets farther than thres3d_neg, two
    ranking directions averaged, mean over the positives. The first max_pos
    positives of each pair in row-major order are kept (a static cap, as in
    gd3d); with return_overflow also the count of positives beyond it."""
    B, S, _ = desc_1.shape
    T = desc_2.shape[1]
    sim = torch.einsum("bsc,btc->bst", desc_1, desc_2)
    dist = torch.linalg.vector_norm(pts3d_1[:, :, None, :] - pts3d_2[:, None, :, :], dim=-1)
    pos_mask = dist < thresh3d_pos
    neg_mask = dist > thres3d_neg
    if valid_1 is not None:
        pos_mask = pos_mask & valid_1[:, :, None]
        neg_mask = neg_mask & valid_1[:, :, None]
    if valid_2 is not None:
        pos_mask = pos_mask & valid_2[:, None, :]
        neg_mask = neg_mask & valid_2[:, None, :]
    P = min(max_pos, S * T)

    sums, counts = [], []
    for b in range(B):
        idx, filled = first_true_indices(pos_mask[b].reshape(-1), P)
        pvalid = (torch.arange(P, device=idx.device) < filled).to(sim.dtype)
        rows, cols = idx // T, idx % T
        sim_rows = sim[b][rows]                      # (P, T)
        negf = neg_mask[b][rows].to(sim.dtype)       # (P, T)
        pos_sim = sim[b][rows, cols]                 # (P,)

        rpos1 = temp_sigmoid(pos_sim - 1.0, temp) + 1.0
        rall1 = rpos1 + (temp_sigmoid(sim_rows - 1.0, temp) * negf).sum(-1)
        rpos2 = temp_sigmoid(1.0 - pos_sim, temp) + 1.0
        rall2 = rpos2 + (temp_sigmoid(sim_rows - pos_sim[:, None], temp) * negf).sum(-1)
        ap = (rpos1 / rall1 + rpos2 / rall2) / 2.0
        sums.append(((1.0 - ap) * pvalid).sum())
        counts.append(pvalid.sum())
    total, count = torch.stack(sums).sum(), torch.stack(counts).sum()
    loss = torch.where(count > 0, total / torch.clamp(count, min=1.0), torch.zeros_like(total))
    if return_overflow:
        true_pos = pos_mask.to(torch.float32).sum(dim=(1, 2))
        return loss, torch.clamp(true_pos - P, min=0.0).sum()
    return loss
