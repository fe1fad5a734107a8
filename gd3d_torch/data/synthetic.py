"""Procedural pair batches for smoke training (counterpart of
gd3d/data/synthetic.py and of gd3d/cli/train.py::_synthetic_teacher_batch).

numpy only, seeded with np.random.RandomState, so a batch is bit-identical
to gd3d's for the same seed. The ME batch mirrors the Objaverse rendering
setup: random 3D surface points seen by two cameras, projected keypoints,
noise images. The teacher batches carry noise images at the teacher and
student resolutions, a pinhole intrinsic, and on objaverse two depth maps.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _look_at_pose(rng: np.random.RandomState) -> np.ndarray:
    """Random small rotation + translation putting the object ~2 m away."""
    angles = rng.uniform(-0.4, 0.4, size=3)
    cx, cy, cz = np.cos(angles)
    sx, sy, sz = np.sin(angles)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    E = np.eye(4)
    E[:3, :3] = Rz @ Ry @ Rx
    E[:3, 3] = np.array([0.0, 0.0, 2.0]) + rng.uniform(-0.1, 0.1, size=3)
    return E


def synthetic_me_batch(seed: int, batch: int = 1, img: int = 64,
                       n_kps: int = 128) -> Dict[str, np.ndarray]:
    """Two views of one object per pair: rgb_1/2 (B, img, img, 3), pts2d_1/2
    (B, n_kps, 2) projected keypoints, pts3d_1/2 (B, n_kps, 3) the shared
    object points (positives are co-located), valid_1/2 (B, n_kps) in-image."""
    rng = np.random.RandomState(seed)
    f = 1.2 * img
    K = np.array([[f, 0, img / 2], [0, f, img / 2], [0, 0, 1]])
    out = {k: [] for k in ("rgb_1", "rgb_2", "pts2d_1", "pts2d_2",
                           "pts3d_1", "pts3d_2", "valid_1", "valid_2")}
    for _ in range(batch):
        obj = rng.randn(n_kps, 3) * 0.15
        views = []
        for _v in range(2):
            E = _look_at_pose(rng)
            uv = (obj @ E[:3, :3].T + E[:3, 3]) @ K.T
            uv = uv[:, :2] / uv[:, 2:3]
            valid = ((uv[:, 0] >= 1) & (uv[:, 0] < img - 1)
                     & (uv[:, 1] >= 1) & (uv[:, 1] < img - 1))
            views.append((np.clip(uv, 1, img - 2), valid))
        (uv1, v1), (uv2, v2) = views
        out["rgb_1"].append(rng.rand(img, img, 3).astype(np.float32))
        out["rgb_2"].append(rng.rand(img, img, 3).astype(np.float32))
        out["pts2d_1"].append(uv1.astype(np.float32))
        out["pts2d_2"].append(uv2.astype(np.float32))
        out["pts3d_1"].append(obj.astype(np.float32))
        out["pts3d_2"].append(obj.astype(np.float32))
        out["valid_1"].append(v1)
        out["valid_2"].append(v2)
    return {k: np.stack(v) for k, v in out.items()}


def synthetic_teacher_batch(teacher: str, dataset: str, batch: int, seed: int,
                            tiny: bool = False) -> Dict[str, np.ndarray]:
    """A MASt3R or VGGT batch of noise images: student frames 512^2 (128^2
    tiny); VGGT frames 518^2 (28^2); MASt3R frames 336x512 on scannetpp,
    384x512 on objaverse (64x96 tiny), with objaverse's depth maps at the
    student resolution."""
    rng = np.random.RandomState(seed)
    R = 128 if tiny else 512
    if teacher == "vggt":
        V = 28 if tiny else 518
        return {
            "rgb_1": rng.rand(batch, R, R, 3).astype(np.float32),
            "rgb_2": rng.rand(batch, R, R, 3).astype(np.float32),
            "rgb_vggt": rng.rand(batch, 2, V, V, 3).astype(np.float32),
        }
    if tiny:
        H, W = 64, 96
    else:
        H, W = (336, 512) if dataset == "scannetpp" else (384, 512)
    out = {
        "rgb_1": rng.rand(batch, R, R, 3).astype(np.float32),
        "rgb_2": rng.rand(batch, R, R, 3).astype(np.float32),
        "rgb_mast3r_1": (rng.rand(batch, H, W, 3) * 2 - 1).astype(np.float32),
        "rgb_mast3r_2": (rng.rand(batch, H, W, 3) * 2 - 1).astype(np.float32),
        "intrinsic": np.tile(
            np.array([[W / 2.0, 0, W / 2], [0, W / 2.0, H / 2], [0, 0, 1]], np.float32),
            (batch, 1, 1)),
    }
    if dataset == "objaverse":
        out["depth_1"] = rng.rand(batch, R, R).astype(np.float32)
        out["depth_2"] = rng.rand(batch, R, R).astype(np.float32)
    return out
