"""MASt3R pretraining matching criteria: InfoNCE, the true-AP score, the
correspondence gather and ConfMatchingLoss (counterpart of
gd3d/ops/matching_loss.py).

As in gd3d the per-match losses stay (B, N) maps and reductions are masked
means; the blockwise shuffle's permutation is an input. The (B, N, M)
similarity is one batched product (torch.matmul), outside any kernel in
gd3d too. With a single positive a query, true AP is the reciprocal rank of
the positive under a stable descending sort.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Tensor = torch.Tensor


def get_similarities(desc1: Tensor, desc2: Tensor, euc: bool = False) -> Tensor:
    """(B, N, D) x (B, M, D) -> (B, N, M): dot products, or
    1 / (1 + euclidean distance) when euc."""
    if euc:
        d = torch.linalg.vector_norm(desc1[:, :, None] - desc2[:, None], dim=-1)
        return 1.0 / (1.0 + d)
    return torch.matmul(desc1, desc2.transpose(-1, -2))


def _exp_sim(desc1, desc2, temperature, euc):
    sim = get_similarities(desc1, desc2, euc) / temperature
    return torch.exp(torch.where(torch.isnan(sim), -torch.inf, sim))


def _valid_mean(x: Tensor, valid: Tensor, count=None) -> Tensor:
    n = valid.sum() if count is None else count(valid.sum())
    mean = torch.where(valid, x, 0.0).sum() / torch.clamp(n, min=1)
    return torch.where(n > 0, mean, torch.zeros_like(mean))


def _infonce_map(sim: Tensor, mode: str, eps: float) -> Tensor:
    """Per-match InfoNCE of exp-similarities (B, N, M), positives on the
    diagonal of the first N columns."""
    N = sim.shape[1]
    positives = torch.diagonal(sim, dim1=1, dim2=2)[:, :N]
    if mode == "all":
        denom = sim.sum(dim=-1).sum(dim=-1, keepdim=True)
        return -torch.log(torch.clamp(positives / denom, min=eps))
    if mode == "proper":
        return -(torch.log(torch.clamp(positives / sim.sum(dim=-2)[:, :N], min=eps))
                 + torch.log(torch.clamp(positives / sim.sum(dim=-1), min=eps)))
    if mode == "dual":
        return -torch.log(torch.clamp(
            positives ** 2 / sim.sum(dim=-1) / sim.sum(dim=-2)[:, :N], min=eps))
    raise ValueError(f"bad InfoNCE mode {mode!r}")


def infonce_loss(desc1: Tensor, desc2: Tensor, valid_matches: Optional[Tensor] = None,
                 temperature: float = 0.07, eps: float = 1e-8, mode: str = "all",
                 euc: bool = False) -> Tensor:
    """InfoNCE over diagonal positives, the mean over valid matches. NaN
    similarities count as -inf; desc2 may carry extra negatives (M >= N)."""
    B, N, _ = desc1.shape
    if valid_matches is None:
        valid_matches = torch.ones((B, N), dtype=torch.bool, device=desc1.device)
    loss = _infonce_map(_exp_sim(desc1, desc2, temperature, euc), mode, eps)
    return _valid_mean(loss, valid_matches)


@torch.no_grad()
def ap_scores(scores: Tensor) -> Tensor:
    """True average precision with diagonal positives, (B, N, M) -> (B, N):
    1 / (1 + the positive's rank), ties in sorted order. No gradient."""
    B, N, M = scores.shape
    order = torch.argsort(-scores, dim=-1, stable=True)
    posmask = order == torch.arange(N, device=scores.device)[None, :, None]
    posrank = torch.argmax(posmask.to(torch.uint8), dim=-1)
    return 1.0 / (1.0 + posrank.to(scores.dtype))


def gather_matching_descs(desc1_map: Tensor, desc2_map: Tensor, corres1: Tensor,
                          corres2: Tensor) -> Tuple[Tensor, Tensor]:
    """Descriptors of (B, H, W, D) maps at (B, N, 2) integer (x, y) pixels."""
    bid = torch.arange(desc1_map.shape[0], device=desc1_map.device)[:, None]
    d1 = desc1_map[bid, corres1[..., 1], corres1[..., 0]]
    d2 = desc2_map[bid, corres2[..., 1], corres2[..., 0]]
    return d1, d2


def blockwise_infonce(descs1: Tensor, descs2: Tensor, valid_matches: Tensor,
                      perm: Optional[Tensor] = None, blocksize: int = 4096,
                      temperature: float = 0.07, mode: str = "all",
                      euc: bool = False) -> Tensor:
    """InfoNCE on the block diagonal when N > blocksize, after shuffling the
    matches by `perm` (B, N), an input; N must divide by blocksize then."""
    B, N, D = descs1.shape
    if N <= blocksize:
        return infonce_loss(descs1, descs2, valid_matches, temperature=temperature,
                            mode=mode, euc=euc)
    if N % blocksize != 0:
        raise ValueError("can't chunk block-diagonal; check blocksize")
    if perm is not None:
        bid = torch.arange(B, device=descs1.device)[:, None]
        descs1, descs2 = descs1[bid, perm], descs2[bid, perm]
        valid_matches = valid_matches[bid, perm]
    n = N // blocksize
    return infonce_loss(descs1.reshape(B * n, blocksize, D), descs2.reshape(B * n, blocksize, D),
                        valid_matches.reshape(B * n, blocksize), temperature=temperature,
                        mode=mode, euc=euc)


def conf_matching_loss(gt1: Dict[str, Tensor], gt2: Dict[str, Tensor],
                       pred1: Dict[str, Tensor], pred2: Dict[str, Tensor],
                       alpha: float = 1.0, confmode: str = "prod",
                       temperature: float = 0.07, mode: str = "all",
                       neg_conf_loss_quantile: float = 0.0,
                       use_pts3d: bool = False, count=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """ConfMatchingLoss(MatchingLoss(InfoNCE)): gt1['corres'] /
    gt2['corres'] (B, N, 2) integer pixels, gt1['valid_corres'] (B, N);
    descriptor maps pred{1,2}['desc'] with 'desc_conf' (or 'pts3d' / 'conf'
    with use_pts3d, which also takes euclidean similarities). Invalid
    matches add 0 through masked means; the negative-quantile term takes
    the quantile of the valid per-match losses, interpolated linearly as
    torch.quantile does. `count` maps a count of valid matches to the
    global batch's (data parallelism; not with the quantile, which needs
    every rank's losses)."""
    if count is not None and neg_conf_loss_quantile:
        raise ValueError("the negative-quantile term is not split over data-parallel ranks")
    dkey, ckey = ("pts3d", "conf") if use_pts3d else ("desc", "desc_conf")
    d2map = pred2["pts3d_in_other_view"] if use_pts3d else pred2[dkey]
    corres1, corres2 = gt1["corres"], gt2["corres"]
    descs1, descs2 = gather_matching_descs(pred1[dkey], d2map, corres1, corres2)
    valid = gt1["valid_corres"]
    bid = torch.arange(valid.shape[0], device=valid.device)[:, None]
    c1 = pred1[ckey][bid, corres1[..., 1], corres1[..., 0]]
    c2 = pred2[ckey][bid, corres2[..., 1], corres2[..., 0]]

    loss_map = _infonce_map(_exp_sim(descs1, descs2, temperature, use_pts3d), mode, 1e-8)
    if confmode == "prod":
        conf_pos = c1 * c2
    elif confmode == "mean":
        conf_pos = 0.5 * (c1 + c2)
    else:
        raise ValueError(f"unknown conf mode {confmode!r}")

    conf_loss = _valid_mean(loss_map * conf_pos - alpha * torch.log(conf_pos), valid, count)
    details = {"matching_loss": _valid_mean(loss_map, valid, count)}
    if neg_conf_loss_quantile:
        # the confidences of unmatched rows are pulled toward a quantile of
        # the matched losses
        n = valid.sum()
        big = torch.finfo(loss_map.dtype).max
        vals = torch.sort(torch.where(valid, loss_map, big).reshape(-1)).values
        last = vals.shape[0] - 1
        pos = neg_conf_loss_quantile * (n.to(torch.float32) - 1)
        lo = torch.clamp(torch.floor(pos).to(torch.int32), 0, last)
        hi = torch.clamp(lo + 1, 0, last)
        frac = torch.clamp(pos - lo.to(torch.float32), 0.0, 1.0)
        neg_value = (vals[lo.long()] * (1.0 - frac) + vals[hi.long()] * frac).detach()
        conf_neg = torch.cat([c1, c2], dim=0)
        neg_mask = torch.cat([~valid, ~valid], dim=0)
        neg_loss = _valid_mean(neg_value * conf_neg - alpha * torch.log(conf_neg), neg_mask)
        conf_loss = conf_loss + neg_loss
        details["neg_conf_loss"] = neg_loss
    details["matching_conf_loss"] = conf_loss
    return conf_loss, details
