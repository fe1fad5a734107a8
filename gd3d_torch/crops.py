"""Coarse-to-fine crop planning for high-resolution matching (counterpart of
gd3d/crops.py, copied: numpy only).

Given coarse correspondences between two images, plan pairs of crop windows
that jointly cover the matches, so that a second (fine) matching pass can
run the teacher at native pixel density inside each window (mast3r's
coarse_to_fine.py, select_pairs_of_crops:184-215 and helpers). With a
`forced_resolution` every crop has the same shape, and the fine pass
batches all crop pairs into one teacher forward
(gd3d_torch/visloc.py::fine_match_crops).

All functions use (l, t, r, b) pixel boxes ("cells") and (x, y) points.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _window_starts(total: int, win: int, overlap: float) -> np.ndarray:
    """Start offsets covering [0, total) with >= `overlap` window overlap
    (coarse_to_fine.py:18-26): first at 0, last at total-win, evenly spaced."""
    assert 0 <= overlap < 1 and total >= win
    spacing = win * (1 - overlap)
    last = total - win
    n = 2 + int((last - 1) // spacing)
    return np.linspace(0, last, n).round().astype(int)


def _floor16(x):
    return (x // 16) * 16


def overlapping_grid(H: int, W: int, size: int, overlap: float) -> np.ndarray:
    """All candidate (l, t, r, b) windows of long side ~`size` (/16-aligned)
    tiling the image with `overlap` (coarse_to_fine.py:33-40)."""
    hw = _floor16(H * size // max(H, W))
    ww = _floor16(W * size // max(H, W))
    xs = _window_starts(W, ww, overlap)
    ys = _window_starts(H, hw, overlap)
    lt = np.stack(np.meshgrid(xs, ys, indexing="xy"), axis=-1).reshape(-1, 2)
    return np.concatenate([lt, lt + (ww, hw)], axis=-1).astype(float)


def norm_windows(
    cells: np.ndarray,
    H: int,
    W: int,
    forced_resolution: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Snap windows to a 3:4 aspect ratio (or to forced (h, w)), centered on
    the original box, floored to ints and shifted fully inside the image
    (coarse_to_fine.py:50-89)."""
    out = cells.astype(float).copy()
    w = cells[:, 2] - cells[:, 0]
    h = cells[:, 3] - cells[:, 1]
    w2, h2 = w.clip(max=W), h.clip(max=H)
    if forced_resolution is None:
        # make the short side 3/4 of the long side (the 3.01 guards the
        # floor-to-int below from landing one pixel short)
        portrait = w < h
        w2 = np.where(portrait, (h2 * 3.01 / 4).clip(max=W), w2)
        h2 = np.where(portrait, h2, (w2 * 3.01 / 4).clip(max=H))
    else:
        fh, fw = forced_resolution
        w2 = np.full_like(w2, fw)
        h2 = np.full_like(h2, fh)

    out[:, 0] -= (w2 - w) / 2
    out[:, 2] += (w2 - w) / 2
    out[:, 1] -= (h2 - h) / 2
    out[:, 3] += (h2 - h) / 2
    out = np.floor(out).astype(int)
    # re-anchor the right/bottom edge so the int box is exactly (w2, h2)
    out[:, 0] += (out[:, 2] - out[:, 0]) - w2.astype(int)
    out[:, 1] += (out[:, 3] - out[:, 1]) - h2.astype(int)
    # then shift inside [0, W) x [0, H)
    out[:, 0::2] -= out[:, [0]].clip(max=0)
    out[:, 1::2] -= out[:, [1]].clip(max=0)
    out[:, 0::2] -= out[:, [2]].clip(min=W) - W
    out[:, 1::2] -= out[:, [3]].clip(min=H) - H
    assert (out[:, 2] - out[:, 0] == w2.astype(int)).all()
    assert (out[:, 3] - out[:, 1] == h2.astype(int)).all()
    return out


def _points_in_cells(pts: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """(n_cells, n_pts) bool: point inside box (coarse_to_fine.py:104-108)."""
    x, y = pts[:, 0], pts[:, 1]
    l, t, r, b = cells[:, 0:1], cells[:, 1:2], cells[:, 2:3], cells[:, 3:4]
    return (l <= x) & (x < r) & (t <= y) & (y < b)


def _gauss_weights(cells: np.ndarray, pts: np.ndarray, assigned: np.ndarray,
                   var: float = 2.0) -> np.ndarray:
    """Per-(cell, point) weight: Gaussian in the cell-normalized distance
    from the cell center, zero if unassigned (coarse_to_fine.py:91-101)."""
    center = cells.reshape(-1, 2, 2).mean(axis=1)
    size = np.stack([cells[:, 2] - cells[:, 0],
                     cells[:, 3] - cells[:, 1]], axis=-1)
    d2 = np.square((center[:, None] - pts[None]) / size[:, None]).sum(-1)
    return np.where(assigned, np.exp(-var * d2), 0.0)


def score_cells(
    cells1: np.ndarray,
    H2: int,
    W2: int,
    p1: np.ndarray,
    p2: np.ndarray,
    min_corres: int = 10,
    forced_resolution: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For each image-1 cell holding >= min_corres matches, derive the
    matching image-2 window (translate to the assigned points' mean, scale
    by the robust 10-90% spread ratio) and the joint coverage weights
    (coarse_to_fine.py:111-153). Returns (cells1, cells2, weights)."""
    assigned = _points_in_cells(p1, cells1)
    keep = assigned.sum(axis=1) >= min_corres
    cells1, assigned = cells1[keep], assigned[keep]
    if len(cells1) == 0:
        return cells1, cells1.copy(), assigned.astype(float)

    a1 = np.where(assigned[..., None], p1[None], np.nan)
    a2 = np.where(assigned[..., None], p2[None], np.nan)
    center2 = np.nanmean(a2, axis=1)
    q1lo, q1hi = np.nanquantile(a1, (0.1, 0.9), axis=1)
    q2lo, q2hi = np.nanquantile(a2, (0.1, 0.9), axis=1)
    spread1 = (q1hi - q1lo).clip(20.0)
    spread2 = (q2hi - q2lo).clip(20.0)

    size1 = cells1[:, 2:4] - cells1[:, 0:2]
    size2 = size1 * spread2 / spread1
    cells2 = np.c_[center2 - size2 / 2, center2 + size2 / 2]
    cells2 = norm_windows(cells2, H2, W2, forced_resolution=forced_resolution)

    weights = _gauss_weights(cells1, p1, assigned) * _gauss_weights(
        cells2, p2, assigned)
    return cells1, cells2, weights


def greedy_cover(weights: np.ndarray, target: float = 0.9,
                 max_pairs: int = 64) -> list:
    """Greedy set cover: pick cell pairs until `target` of the attainable
    correspondence weight is covered (coarse_to_fine.py:156-181). max_pairs
    bounds the loop (deviation: the reference can spin if the residual
    weights go flat; a cap is also what a static-shape fine batch wants)."""
    assert 0 < target <= 1
    w = weights.copy()
    goal = target * w.max(axis=0).sum()
    picked, covered = [], np.zeros(w.shape[1])
    while covered.sum() < goal and len(picked) < max_pairs:
        best = int(w.sum(axis=1).argmax())
        if w[best].sum() <= 0:
            break
        picked.append(best)
        covered += w[best]
        w = (w - w[best]).clip(min=0)
    return picked


def select_crop_pairs(
    shape1: Sequence[int],
    shape2: Sequence[int],
    p1: np.ndarray,
    p2: np.ndarray,
    maxdim: int = 512,
    overlap: float = 0.5,
    forced_resolution=None,
    min_corres: int = 10,
    max_pairs: int = 64,
) -> Tuple[np.ndarray, np.ndarray]:
    """Plan crop-window pairs covering the coarse matches p1 (in image 1,
    (N, 2) xy) <-> p2 (in image 2) (coarse_to_fine.py:184-215, both
    directions' grids scored and greedily merged).

    forced_resolution: (h, w), or ((h1, w1), (h2, w2)) per image — pass it
    to get the static-shape crops the batched fine pass needs.
    Returns (cells1 (K, 4), cells2 (K, 4)) int (l, t, r, b) boxes.
    """
    H1, W1 = int(shape1[0]), int(shape1[1])
    H2, W2 = int(shape2[0]), int(shape2[1])
    if forced_resolution is None:
        fr1 = fr2 = None
    elif np.ndim(forced_resolution[0]) == 0:
        fr1 = fr2 = tuple(forced_resolution)
    else:
        fr1, fr2 = tuple(forced_resolution[0]), tuple(forced_resolution[1])

    grid1 = norm_windows(overlapping_grid(H1, W1, maxdim, overlap), H1, W1,
                         forced_resolution=fr1)
    grid2 = norm_windows(overlapping_grid(H2, W2, maxdim, overlap), H2, W2,
                         forced_resolution=fr2)

    c1a, c2a, wa = score_cells(grid1, H2, W2, p1, p2, min_corres, fr2)
    c2b, c1b, wb = score_cells(grid2, H1, W1, p2, p1, min_corres, fr1)
    cells1 = np.concatenate([c1a, c1b], axis=0)
    cells2 = np.concatenate([c2a, c2b], axis=0)
    weights = np.concatenate([wa, wb], axis=0)
    if len(weights) == 0:
        return cells1[:0], cells2[:0]
    order = greedy_cover(weights, max_pairs=max_pairs)
    return cells1[order], cells2[order]
