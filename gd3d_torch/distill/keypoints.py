"""Keypoint pipeline: reciprocal nearest-neighbour matching + filtering
(counterpart of gd3d/distill/keypoints.py).

gd3d's static design is kept: G subsample-grid slots with a validity mask,
so the shapes never depend on the data and parity with gd3d is
element-wise. Argmax ties break to the lowest index, as in gd3d.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from gd3d_torch.ops.basic import kth_smallest


def blockwise_argmax_dot(queries: torch.Tensor, db: torch.Tensor,
                         block: int = 8192) -> torch.Tensor:
    """argmax_n (queries @ db^T) streamed over db blocks: (G, D) x (N, D) ->
    (G,) int64, without materializing (G, N). An earlier block wins a tie."""
    best = torch.full((queries.shape[0],), -torch.inf, dtype=queries.dtype,
                      device=queries.device)
    best_idx = torch.zeros(queries.shape[0], dtype=torch.long, device=queries.device)
    for off in range(0, db.shape[0], block):
        sim = queries @ db[off: off + block].T
        blk_best, blk_idx = sim.max(dim=1)
        take = blk_best > best
        best = torch.where(take, blk_best, best)
        best_idx = torch.where(take, blk_idx + off, best_idx)
    return best_idx


def subsample_grid_indices(H: int, W: int, S: int, device=None) -> torch.Tensor:
    """np.mgrid[S//2:H:S, S//2:W:S] flattened to linear indices."""
    ys = torch.arange(S // 2, H, S, device=device)
    xs = torch.arange(S // 2, W, S, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return (yy * W + xx).reshape(-1)


def reciprocal_nn_grid(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    H: int,
    W: int,
    subsample: int = 16,
    max_iter: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-point reciprocal NN from a subsample grid, stopping early once
    every slot has converged (at most max_iter rounds).

    desc1/desc2 (H, W, D). Returns xy1, xy2 linear indices (G,) and the
    converged mask (G,)."""
    d1 = desc1.reshape(-1, desc1.shape[-1])
    d2 = desc2.reshape(-1, desc2.shape[-1])
    xy1 = subsample_grid_indices(H, W, subsample, device=desc1.device)
    xy2 = torch.full_like(xy1, -1)
    notyet = torch.ones_like(xy1, dtype=torch.bool)
    for _ in range(max_iter):
        if not bool(notyet.any()):
            break
        old_xy1, old_xy2 = xy1, xy2
        xy2 = torch.where(notyet, blockwise_argmax_dot(d1[xy1], d2), xy2)
        notyet = notyet & (old_xy2 != xy2)
        xy1 = torch.where(notyet, blockwise_argmax_dot(d2[xy2], d1), xy1)
        notyet = notyet & (old_xy1 != xy1)
    return xy1, xy2, ~notyet


def merge_corres_static(xy1, xy2, valid, HW1: int):
    """Unique (xy2, xy1) pairs in xy2-major order, static shape: invalid
    slots sort to the end (HW1 is the sentinel, above any linear index).
    Lexicographic order from two stable sorts."""
    k1 = torch.where(valid, xy1, torch.full_like(xy1, HW1))
    k2 = torch.where(valid, xy2, torch.full_like(xy2, HW1))
    order1 = torch.sort(k1, stable=True).indices
    order2 = torch.sort(k2[order1], stable=True).indices
    order = order1[order2]
    sxy1, sxy2, svalid = xy1[order], xy2[order], valid[order]
    same = (sxy1[1:] == sxy1[:-1]) & (sxy2[1:] == sxy2[:-1]) & svalid[:-1]
    uniq = torch.cat([torch.ones(1, dtype=torch.bool, device=same.device), ~same])
    return sxy1, sxy2, svalid & uniq


def filter_and_match_keypoints(
    feats: Dict[str, torch.Tensor],
    H: int,
    W: int,
    subsample: int = 16,
    border: int = 3,
    min_conf_percent: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keypoints of one pair. feats: desc_1/desc_2 (H, W, D), conf_1/conf_2
    (H, W). Returns kp_1, kp_2 float (G, 2) as (x, y) and valid (G,): in
    the 3 px border on both views, and above the bottom-percentile
    confidence in either view."""
    xy1, xy2, conv = reciprocal_nn_grid(feats["desc_1"], feats["desc_2"], H, W,
                                        subsample)
    xy1, xy2, valid = merge_corres_static(xy1, xy2, conv, H * W)
    x1, y1 = xy1 % W, xy1 // W
    x2, y2 = xy2 % W, xy2 // W
    in_border = (
        (x1 >= border) & (x1 < W - border) & (y1 >= border) & (y1 < H - border)
        & (x2 >= border) & (x2 < W - border) & (y2 >= border) & (y2 < H - border)
    )
    valid = valid & in_border
    conf1 = feats["conf_1"].reshape(-1)
    conf2 = feats["conf_2"].reshape(-1)
    q = int(conf1.shape[0] * min_conf_percent * 0.01)
    ok1 = conf1[xy1] >= kth_smallest(conf1, q)
    ok2 = conf2[xy2] >= kth_smallest(conf2, q)
    valid = valid & (ok1 | ok2)
    kp1 = torch.stack([x1, y1], dim=-1).float()
    kp2 = torch.stack([x2, y2], dim=-1).float()
    return kp1, kp2, valid
