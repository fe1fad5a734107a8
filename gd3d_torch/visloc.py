"""Visual localization against a globally-aligned scene (counterpart of
gd3d/visloc.py; the dust3r visloc flow, dust3r/visloc.py:73-140).

For a query image, run the pairwise teacher against every map view in one
batched call, match MASt3R descriptors by reciprocal nearest neighbour
(gd3d_torch/distill/keypoints.py, on the device), lift the matched map
pixels to the scene's 3D points, and solve the query pose by EPnP RANSAC on
the host (gd3d_torch/eval/pnp.py, which gives cv2.solvePnPRansac's answers).
The query intrinsic defaults to the median-ratio focal of its pairwise point
map (align._estimate_focal) with a centred principal point.
`fine_match_crops` is the coarse-to-fine second pass: crop windows covering
the coarse matches (gd3d_torch/crops.py), all crop pairs in one teacher call
at one static crop shape.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gd3d_torch.align import _estimate_focal, _host
from gd3d_torch.crops import select_crop_pairs
from gd3d_torch.distill.keypoints import filter_and_match_keypoints
from gd3d_torch.eval.pnp import solve_pose


def _teacher_device(teacher) -> torch.device:
    return next(teacher.parameters()).device


def _match_pairs(feats, H: int, W: int, subsample: int, border: int,
                 min_conf_percent: float):
    """filter_and_match_keypoints over the batch of a teacher call:
    (kp_1 (B, G, 2), kp_2 (B, G, 2), valid (B, G)) on the host."""
    rows = [filter_and_match_keypoints(
        {k: feats[k][b] for k in ("desc_1", "desc_2", "conf_1", "conf_2")}, H, W,
        subsample=subsample, border=border, min_conf_percent=min_conf_percent)
        for b in range(feats["desc_1"].shape[0])]
    return tuple(np.stack([_host(r[i]) for r in rows]) for i in range(3))


def match_query_to_map(
    teacher,
    query: torch.Tensor,
    map_imgs: torch.Tensor,
    subsample: int = 8,
    border: int = 3,
    min_conf_percent: float = 10.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Match one query image (H, W, 3) against every map view (M, H, W, 3)
    in one batched teacher call. Returns (q_pix (M, G, 2), m_pix (M, G, 2),
    valid (M, G), query_pts3d (H, W, 3)) with (x, y) pixel coordinates; G is
    the static match capacity."""
    M = map_imgs.shape[0]
    H, W = query.shape[0], query.shape[1]
    q = query[None].expand((M,) + tuple(query.shape))
    feats = teacher.extract_features(q, map_imgs, 1.0)
    kp_q, kp_m, valid = _match_pairs(feats, H, W, subsample, border, min_conf_percent)
    return kp_q, kp_m, valid, _host(feats["pts3d_1"][0])


def fine_match_crops(
    teacher,
    img_1: np.ndarray,
    img_2: np.ndarray,
    p1: np.ndarray,
    p2: np.ndarray,
    crop_hw: Tuple[int, int] = (384, 512),
    maxdim: int = 512,
    overlap: float = 0.5,
    max_pairs: int = 8,
    subsample: int = 8,
    border: int = 3,
    min_conf_percent: float = 10.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Coarse-to-fine second matching pass (mast3r coarse_to_fine analogue).

    Plans crop-window pairs covering the coarse matches p1 <-> p2 (full-res
    (x, y) pixels in img_1 / img_2), runs all crop pairs as one batched
    teacher forward at the static `crop_hw`, matches per pair, and maps the
    matches back to full-image pixels. The crop batch is zero-padded to
    `max_pairs`, so every call has the same shape.

    Returns (kp_1 (K, G, 2), kp_2 (K, G, 2), valid (K, G)) in full-image
    pixel coordinates, K == max_pairs (padded rows all invalid)."""
    img_1 = _host(img_1)
    img_2 = _host(img_2)
    ch, cw = crop_hw
    cells1, cells2 = select_crop_pairs(
        img_1.shape, img_2.shape, p1, p2, maxdim=maxdim, overlap=overlap,
        forced_resolution=crop_hw, max_pairs=max_pairs)
    K = len(cells1)
    crops1 = np.zeros((max_pairs, ch, cw, img_1.shape[-1]), np.float32)
    crops2 = np.zeros((max_pairs, ch, cw, img_2.shape[-1]), np.float32)
    for i in range(K):
        l, t, r, b = cells1[i]
        crops1[i] = img_1[t:b, l:r]
        l, t, r, b = cells2[i]
        crops2[i] = img_2[t:b, l:r]

    dev = _teacher_device(teacher)
    feats = teacher.extract_features(torch.from_numpy(crops1).to(dev),
                                     torch.from_numpy(crops2).to(dev), 1.0)
    kp_1, kp_2, valid = _match_pairs(feats, ch, cw, subsample, border, min_conf_percent)
    kp_1 = kp_1.astype(np.float32)
    kp_2 = kp_2.astype(np.float32)
    valid = valid.copy()
    valid[K:] = False
    off1 = np.zeros((max_pairs, 2), np.float32)
    off2 = np.zeros((max_pairs, 2), np.float32)
    off1[:K] = cells1[:, 0:2]
    off2[:K] = cells2[:, 0:2]
    return kp_1 + off1[:, None], kp_2 + off2[:, None], valid


def solve_localization(
    q_pix: np.ndarray,
    m_pix: np.ndarray,
    valid: np.ndarray,
    map_indices: Sequence[int],
    scene_pts3d: np.ndarray,
    scene_conf: Optional[np.ndarray] = None,
    K: Optional[np.ndarray] = None,
    query_pts3d: Optional[np.ndarray] = None,
    hw: Optional[Tuple[int, int]] = None,
    min_conf: float = 1.5,
    reproj_px: float = 5.0,
) -> Dict[str, np.ndarray]:
    """2D (query) <-> 3D (scene) correspondences -> query cam2world pose.

    q_pix / m_pix / valid: (M, G, 2) / (M, G) stacked per-map-view matches
    (x, y); scene_pts3d (n_imgs, H, W, 3) world points of the aligned scene;
    scene_conf (n_imgs, H, W) gates map pixels (visloc.py:89
    confidence_threshold). K: the query intrinsic; estimated from
    query_pts3d (median-ratio focal) when absent."""
    pts2d, pts3d = [], []
    for row, mi in enumerate(map_indices):
        v = valid[row].astype(bool)
        if not v.any():
            continue
        qp = q_pix[row][v]
        mp = m_pix[row][v].astype(int)
        p3 = scene_pts3d[mi][mp[:, 1], mp[:, 0]]
        keep = np.ones(len(p3), bool)
        if scene_conf is not None:
            keep = scene_conf[mi][mp[:, 1], mp[:, 0]] > min_conf
        pts2d.append(qp[keep])
        pts3d.append(p3[keep])
    if not pts2d:
        return {"pose": np.eye(4), "n_matches": 0, "K": np.eye(3)}
    pts2d = np.concatenate(pts2d, 0)
    pts3d = np.concatenate(pts3d, 0)

    if K is None:
        assert query_pts3d is not None and hw is not None, (
            "pass K, or query_pts3d + hw to estimate the focal")
        f = _estimate_focal(query_pts3d, hw)
        K = np.asarray([[f, 0, hw[1] / 2], [0, f, hw[0] / 2], [0, 0, 1]], np.float64)

    w2c = solve_pose(pts2d.astype(np.float64), pts3d.astype(np.float64),
                     np.asarray(K, np.float64), reproj_px=reproj_px, pts3d_scale=1.0)
    return {
        "pose": np.linalg.inv(w2c),  # cam2world in scene frame
        "n_matches": int(len(pts2d)),
        "K": np.asarray(K),
    }


def localize_image(
    teacher,
    query: torch.Tensor,
    scene_images: np.ndarray,
    scene_pts3d: np.ndarray,
    scene_conf: Optional[np.ndarray] = None,
    K: Optional[np.ndarray] = None,
    top_k: Optional[int] = None,
    coarse_to_fine: bool = False,
    query_hires: Optional[np.ndarray] = None,
    crop_hw: Optional[Tuple[int, int]] = None,
    fine_max_pairs: int = 8,
    **solve_kw,
) -> Dict[str, np.ndarray]:
    """End to end: a query image (H, W, 3) in [-1, 1] against an aligned
    scene (scene.npz's images / pts3d / confidence). top_k limits the map
    views (all by default).

    coarse_to_fine: after the coarse pass, re-match the best map view
    through crop windows covering the coarse matches (mast3r
    coarse_to_fine); pass `query_hires` (the query at a higher resolution,
    [-1, 1]) so the fine crops see more pixels. Fine matches are mapped back
    to scene-grid coordinates before the PnP."""
    dev = _teacher_device(teacher)
    query = torch.as_tensor(query).to(dev)
    n = scene_images.shape[0]
    idx = list(range(n if top_k is None else min(top_k, n)))
    q_pix, m_pix, valid, qpts = match_query_to_map(
        teacher, query, torch.as_tensor(np.asarray(scene_images)[idx]).to(dev))

    if coarse_to_fine:
        rows_q = [q_pix[r] for r in range(len(idx))]
        rows_m = [m_pix[r] for r in range(len(idx))]
        rows_v = [valid[r] for r in range(len(idx))]
        best = int(np.argmax(valid.sum(axis=1)))
        v = valid[best].astype(bool)
        if v.sum() >= 10:
            qh = _host(query_hires if query_hires is not None else query)
            H, W = query.shape[0], query.shape[1]
            if crop_hw is None:
                # fine windows at the teacher's working (= scene) size: the
                # hires query is cropped, the map view rides along whole
                crop_hw = (H, W)
            sq = np.float32([qh.shape[1] / W, qh.shape[0] / H])
            map_img = np.asarray(scene_images[idx[best]])
            f_q, f_m, f_v = fine_match_crops(
                teacher, qh, map_img, q_pix[best][v] * sq, m_pix[best][v],
                crop_hw=crop_hw, maxdim=max(crop_hw), max_pairs=fine_max_pairs)
            for k in range(f_q.shape[0]):
                rows_q.append(f_q[k] / sq)   # back to scene-grid coords
                rows_m.append(f_m[k])
                rows_v.append(f_v[k])
                idx = idx + [idx[best]]
        q_pix, m_pix, valid = rows_q, rows_m, rows_v

    return solve_localization(
        q_pix, m_pix, valid, idx, scene_pts3d, scene_conf, K=K,
        query_pts3d=qpts, hw=tuple(query.shape[:2]), **solve_kw)
