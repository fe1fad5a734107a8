"""DUSt3R/MASt3R point-matching tracker (counterpart of
gd3d/eval/dust3r_tracker.py, parity target utils/tracking_model.py:336-379).

For a query point in a source frame, run the teacher's two-view inference
on (source, target), take the query's 3D point from the source's map and
place the track at the pixel of the target's pts3d_in_other_view map (both
in the source camera's frame) nearest to it. Element 1 of the symmetrised
batch is the (view1 = source, view2 = target) direction, as in gd3d. The
pair predictions stay on the teacher's device, cached per call; the
distances are float32 sqrt((dx^2 + dy^2) + dz^2), numpy's order, and the
argmin keeps the first of equal minima. The forward runs in full fp32 (no
TF32), through the teacher's fp32 flash attention (K1) and RoPE (K5) on the
card.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from gd3d_torch.teachers.mast3r import Mast3rTeacher, no_tf32

QUERY_CHUNK = 64  # queries whose distances to a 336x512 map are taken at once (44 MB)


class Dust3rTracker:
    def __init__(self, teacher: Mast3rTeacher):
        self.teacher = teacher
        self._cache: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}

    @torch.no_grad()
    def _pair_pts(self, frames_m11: torch.Tensor, src_t: int, tgt_t: int):
        key = (src_t, tgt_t)
        if key not in self._cache:
            with no_tf32():
                out = self.teacher.model(frames_m11[src_t][None], frames_m11[tgt_t][None], 1.0)
            self._cache[key] = (out["res1"]["pts3d"][1], out["res2"]["pts3d_in_other_view"][1])
        return self._cache[key]

    @torch.no_grad()
    def track(self, frames: np.ndarray, query_points: np.ndarray) -> np.ndarray:
        """frames (T, H, W, 3) in [0, 1]; query_points (N, 3) as (x, y, t)
        pixels. Returns (N, T, 2) float32 predicted (x, y) per frame."""
        # the cache is keyed by frame indices: a new call may be a new video
        self._cache.clear()
        device = next(self.teacher.parameters()).device
        frames_m11 = torch.from_numpy(np.ascontiguousarray(frames * 2.0 - 1.0)).to(
            device, torch.float32)  # ImgNorm(0.5, 0.5)
        T, H, W, _ = frames.shape
        out = np.zeros((query_points.shape[0], T, 2), np.float32)
        src = np.array([int(round(t)) for t in query_points[:, 2]])
        for src_t in np.unique(src):
            rows = np.nonzero(src == src_t)[0]
            for tgt_t in range(T):
                pts1, pts2 = self._pair_pts(frames_m11, int(src_t), tgt_t)
                flat = pts2.reshape(-1, 3)
                for lo in range(0, len(rows), QUERY_CHUNK):
                    sel = rows[lo: lo + QUERY_CHUNK]
                    ys = torch.as_tensor([int(query_points[n, 1]) for n in sel], device=device)
                    xs = torch.as_tensor([int(query_points[n, 0]) for n in sel], device=device)
                    d = flat[None] - pts1[ys, xs][:, None]
                    dist = torch.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                                      + d[..., 2] * d[..., 2])
                    best = torch.argmin(dist, dim=1).cpu().numpy()
                    out[sel, tgt_t, 0] = best % W
                    out[sel, tgt_t, 1] = best // W
        return out
