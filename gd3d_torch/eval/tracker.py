"""DINO-Tracker-style feature-volume tracker (counterpart of
gd3d/eval/tracker.py), on the device.

For each query point: correlation maps against every frame's dense
features, ReLU and softmax over the map, a radius-35 circular mask around
the hard argmax on the patch-centre pixel grid, and the soft argmax under it
(with gd3d's uniform fallback for an empty mask); the trajectory's features
give the cosine gating; every trajectory point is tracked back to every
frame (the T x T anchor cycles); occlusion follows from the lower median of
the anchor distances and the cosine thresholds.

Everything stays on the features' device and nothing waits for the host:
the ragged visible-anchor sets of `compute_occlusion` are masked sorts, not
a Python loop per query. The anchor maps of one query are (T, T, gh, gw)
fp32 (117 MB at T = 70 on the 57 x 105 grid of a 464 x 848 frame), so the
queries go through in chunks that keep those maps under MAP_BYTES.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

EPS = 1e-8
# the largest stack of correlation maps one chunk of queries may hold; the
# soft argmax keeps about five such stacks alive at once
MAP_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    patch_size: int = 16
    stride: int = 8
    argmax_radius: int = 35
    anchor_cos_threshold: float = 0.7
    cos_threshold: float = 0.6
    video_h: int = 464
    video_w: int = 848


def _patch_center_grid(cfg: TrackerConfig, gh: int, gw: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel x and y of the patch centres, each (gh, gw): they start at
    patch / 2 and step by the stride."""
    h0 = cfg.patch_size // 2
    ys = (h0 + torch.arange(gh, device=device) * cfg.stride).float()
    xs = (h0 + torch.arange(gw, device=device) * cfg.stride).float()
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx, gy


def _normalize_points(cfg: TrackerConfig, pts_xy: torch.Tensor) -> torch.Tensor:
    """Pixels -> [-1, 1] grid coordinates with patch-centre alignment (the
    affine map of interpolate_features)."""
    h, w, ps, st = cfg.video_h, cfg.video_w, cfg.patch_size, cfg.stride
    last_h = ((h - ps) // st) * st + ps / 2
    last_w = ((w - ps) // st) * st + ps / 2
    a = torch.tensor([2 / (last_w - ps / 2), 2 / (last_h - ps / 2)], device=pts_xy.device)
    b = torch.tensor([1 - last_w * 2 / (last_w - ps / 2), 1 - last_h * 2 / (last_h - ps / 2)],
                     device=pts_xy.device)
    return pts_xy * a + b


def _sample_embed(features: torch.Tensor, pts_xyt: torch.Tensor, cfg: TrackerConfig) -> torch.Tensor:
    """features (T, gh, gw, C); pts (N, 3) as (x, y, t) pixels -> (N, C),
    bilinear with the taps clamped to the grid."""
    T, gh, gw, C = features.shape
    norm = _normalize_points(cfg, pts_xyt[:, :2])
    x = (norm[:, 0] + 1) * 0.5 * (gw - 1)
    y = (norm[:, 1] + 1) * 0.5 * (gh - 1)
    t = torch.clamp(torch.round(pts_xyt[:, 2]).to(torch.int64), 0, T - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = (x - x0)[:, None], (y - y0)[:, None]

    def tap(yi, xi):
        yi = torch.clamp(yi, 0, gh - 1).to(torch.int64)
        xi = torch.clamp(xi, 0, gw - 1).to(torch.int64)
        return features[t, yi, xi]

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    return (v00 * (1 - tx) + v01 * tx) * (1 - ty) + (v10 * (1 - tx) + v11 * tx) * ty


def _soft_argmax_batch(corr: torch.Tensor, cfg: TrackerConfig) -> torch.Tensor:
    """corr (..., gh, gw) cosine maps -> (..., 2) pixel (x, y): ReLU, softmax
    over the map, the circular radius mask at the hard argmax's patch
    centre, the weighted mean of the patch centres under it (uniform over the
    mask where the masked mass is below 1e-8)."""
    gh, gw = corr.shape[-2:]
    gx, gy = _patch_center_grid(cfg, gh, gw, corr.device)
    flat = torch.relu(corr).reshape(*corr.shape[:-2], gh * gw)
    am = torch.argmax(flat, dim=-1)
    sm = torch.softmax(flat, dim=-1).reshape(corr.shape)
    h0 = cfg.patch_size // 2
    cx = ((am % gw) * cfg.stride + h0).float()[..., None, None]
    cy = ((am // gw) * cfg.stride + h0).float()[..., None, None]
    # |grid - centre| <= radius on integer pixels, compared squared: the same
    # set as gd3d's norm (the squares are exact, the root correctly rounded)
    mask = ((gx - cx) ** 2 + (gy - cy) ** 2 <= float(cfg.argmax_radius) ** 2).to(sm.dtype)
    hm = sm * mask
    hm_sum = hm.sum(dim=(-1, -2))
    uniform = mask / torch.clamp(mask.sum(dim=(-1, -2), keepdim=True), min=1.0)
    hm = torch.where((hm_sum < 1e-8)[..., None, None], uniform, hm)
    hm_sum = hm.sum(dim=(-1, -2))
    px = (hm * gx).sum(dim=(-1, -2)) / hm_sum
    py = (hm * gy).sum(dim=(-1, -2)) / hm_sum
    return torch.stack([px, py], dim=-1)


def _chunk(n_maps_per_query: int, gh: int, gw: int) -> int:
    return max(1, MAP_BYTES // (4 * n_maps_per_query * gh * gw))


def generate_trajectories(features: torch.Tensor, query_points: torch.Tensor,
                          cfg: TrackerConfig) -> torch.Tensor:
    """features (T, gh, gw, C) (refine conv applied); query (N, 3) as (x, y,
    t) pixels -> (N, T, 2) predicted pixels in every frame."""
    T, gh, gw, C = features.shape
    e = _sample_embed(features, query_points, cfg)  # (N, C)
    fnorm = torch.linalg.vector_norm(features, dim=-1)  # (T, gh, gw)
    enorm = torch.linalg.vector_norm(e, dim=-1)
    step = _chunk(T, gh, gw)
    out = []
    for lo in range(0, e.shape[0], step):
        corr = torch.einsum("nc,tghc->ntgh", e[lo: lo + step], features)
        den = torch.clamp(enorm[lo: lo + step, None, None, None] * fnorm[None], min=EPS)
        out.append(_soft_argmax_batch(corr / den, cfg))
    return torch.cat(out) if out else features.new_zeros((0, T, 2))


def trajectory_cos_sims(features: torch.Tensor, trajectories: torch.Tensor,
                        query_points: torch.Tensor, cfg: TrackerConfig):
    """Cosine similarity of each trajectory point's feature with its
    query-frame feature. Returns (cos (N, T), trajectory features (N, T, C))."""
    T = features.shape[0]
    N = trajectories.shape[0]
    ts = torch.arange(T, dtype=torch.float32, device=features.device).expand(N, T)
    pts = torch.cat([trajectories, ts[..., None]], dim=-1).reshape(-1, 3)
    tf = _sample_embed(features, pts, cfg).reshape(N, T, -1)
    qframe = torch.clamp(query_points[:, 2].to(torch.int64), 0, T - 1)
    qf = tf[torch.arange(N, device=tf.device), qframe]  # (N, C)
    cos = (tf * qf[:, None]).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(tf, dim=-1)
        * torch.linalg.vector_norm(qf, dim=-1)[:, None], min=EPS)
    return cos, tf


def anchor_trajectories(features: torch.Tensor, trajectories: torch.Tensor,
                        cfg: TrackerConfig) -> torch.Tensor:
    """Cycle predictions: every trajectory point (n, s) tracked to every
    frame a. Returns (N, T_anchor, T_source, 2); the queries go in chunks
    whose (n, T, T, gh, gw) maps stay under MAP_BYTES."""
    T, gh, gw, C = features.shape
    N = trajectories.shape[0]
    fnorm = torch.linalg.vector_norm(features, dim=-1)
    ts = torch.arange(T, dtype=torch.float32, device=features.device)[:, None]
    step = _chunk(T * T, gh, gw)
    out = []
    for lo in range(0, N, step):
        traj = trajectories[lo: lo + step]
        n = traj.shape[0]
        pts = torch.cat([traj, ts.expand(n, T, 1)], dim=-1).reshape(-1, 3)
        e = _sample_embed(features, pts, cfg).reshape(n, T, C)  # (n, T_source, C)
        corr = torch.einsum("nsc,aghc->nasgh", e, features)
        den = torch.clamp(torch.linalg.vector_norm(e, dim=-1)[:, None, :, None, None]
                          * fnorm[None, :, None], min=EPS)
        out.append(_soft_argmax_batch(corr / den, cfg))
    return torch.cat(out) if out else features.new_zeros((0, T, T, 2))


def compute_occlusion(trajectories: torch.Tensor, cos_sims: torch.Tensor,
                      anchors: torch.Tensor, cfg: TrackerConfig) -> torch.Tensor:
    """Occlusion flags (N, T), all queries at once. For query n, the anchor
    frames a whose cosine reaches anchor_cos_threshold are visible; d[a, s]
    is the distance of the cycle prediction (n, a, s) from the trajectory
    point at frame a; the threshold is the largest, over visible frames s,
    of the lower median over visible a of d[a, s] (torch.median's middle,
    not numpy's average); a frame is occluded where its median exceeds it or
    its cosine is below cos_threshold. Without a visible anchor, the cosine
    alone decides."""
    vis = cos_sims >= cfg.anchor_cos_threshold  # (N, T)
    diff = anchors - trajectories[:, :, None, :]  # (N, T_a, T_s, 2)
    dists = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    dists = torch.where(vis[:, :, None], dists, torch.full_like(dists, float("inf")))
    count = vis.sum(dim=1)  # (N,)
    k = torch.clamp((count - 1) // 2, min=0)
    srt = torch.sort(dists, dim=1).values
    med = torch.gather(srt, 1, k[:, None, None].expand(-1, 1, srt.shape[2]))[:, 0]  # (N, T_s)
    th = torch.where(vis, med, torch.full_like(med, -float("inf"))).amax(dim=1)
    low_cos = cos_sims < cfg.cos_threshold
    occ = (med > th[:, None]) | low_cos
    return torch.where((count > 0)[:, None], occ, low_cos)


def infer_tracks(features: torch.Tensor, query_points: torch.Tensor,
                 cfg: TrackerConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """features (T, gh, gw, C), query (N, 3) -> (trajectories (N, T, 2),
    occlusion (N, T) bool), both on the features' device."""
    q = query_points.to(features.device, torch.float32)
    trajs = generate_trajectories(features, q, cfg)
    cos, _ = trajectory_cos_sims(features, trajs, q, cfg)
    anchors = anchor_trajectories(features, trajs, cfg)
    return trajs, compute_occlusion(trajs, cos, anchors, cfg)
