"""Distillation losses with padded-keypoint validity masks (counterpart of
the parts of gd3d/ops/losses.py that the MASt3R step calls)."""
from __future__ import annotations

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
) -> torch.Tensor:
    """Smooth-AP matching loss for 1:1-paired keypoints: positives on the
    diagonal, negatives farther than thres3d_neg in 3D, two ranking
    directions averaged."""
    B, N, _ = desc_1.shape
    sim = torch.einsum("bnc,bmc->bnm", desc_1, desc_2)
    dist = torch.linalg.vector_norm(
        pts3d_1[:, :, None, :] - pts3d_2[:, None, :, :], dim=-1)
    eye = torch.eye(N, dtype=torch.bool, device=desc_1.device)[None]
    neg_mask = (dist > thres3d_neg) & ~eye & valid[:, :, None] & valid[:, None, :]
    pos_sim = torch.diagonal(sim, dim1=1, dim2=2)
    negf = neg_mask.to(sim.dtype)

    rpos1 = temp_sigmoid(pos_sim - 1.0, temp) + 1.0
    rall1 = rpos1 + (temp_sigmoid(sim - 1.0, temp) * negf).sum(-1)
    ap1 = rpos1 / rall1

    rpos2 = temp_sigmoid(1.0 - pos_sim, temp) + 1.0
    rall2 = rpos2 + (temp_sigmoid(sim - pos_sim[:, :, None], temp) * negf).sum(-1)
    ap2 = rpos2 / rall2

    return _masked_mean(1.0 - (ap1 + ap2) / 2.0, valid)
