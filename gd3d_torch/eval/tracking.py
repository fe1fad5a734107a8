"""TAP-Vid DAVIS tracking evaluation (counterpart of gd3d/eval/tracking.py).

Frames are read with the port's JPEG decoder and PIL-exact Lanczos resize
(476 x 854 -> 464 x 848, the size cut to a multiple of the patch), in a
process pool when one is given. Dense features at stride patch / 2 with the
position embedding resampled to the strided grid, then the refine conv, in
batches of 4 frames (the tail padded by repetition), uint8 frames
normalized on the device; DINO-Tracker inference on the device
(gd3d_torch/eval/tracker.py); strided TAP-Vid metrics per video. The
feature passes and the tracker run in full fp32 (no TF32).
"""
from __future__ import annotations

import concurrent.futures
import pickle
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from gd3d_torch.eval.images import load_frame, map_images
from gd3d_torch.eval.table import Table
from gd3d_torch.eval.tracker import TrackerConfig, infer_tracks
from gd3d_torch.eval.tracking_metrics import compute_tapvid_metrics_for_video
from gd3d_torch.models.student import Student
from gd3d_torch.teachers.mast3r import no_tf32


def _device(student: Student) -> torch.device:
    return next(student.parameters()).device


@torch.no_grad()
def video_features(student: Student, frames: np.ndarray, refine: bool = True,
                   batch_frames: int = 4) -> torch.Tensor:
    """frames (T, H, W, 3) uint8 (or float in [0, 1]) -> (T, gh, gw, C)
    stride-(patch / 2) features on the student's device, `batch_frames`
    frames a pass, the tail batch padded by repetition and sliced off."""
    device = _device(student)
    stride = student.cfg.patch_size // 2
    T = frames.shape[0]
    feats = []
    with no_tf32():
        for lo in range(0, T, batch_frames):
            chunk = frames[lo: lo + batch_frames]
            if len(chunk) < batch_frames:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], batch_frames - len(chunk), 0)])
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
            x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
            feats.append(student.dense_grid_features(x, stride=stride, refine=refine))
    return torch.cat(feats)[:T]


def load_video_frames(video_dir: str, h: int, w: int,
                      pool: Optional[concurrent.futures.Executor] = None) -> np.ndarray:
    """The video's *.jpg frames in name order, each decoded and resized to
    (w, h): (T, h, w, 3) uint8."""
    paths = [str(p) for p in sorted(Path(video_dir).glob("*.jpg"))]
    if not paths:
        raise FileNotFoundError(f"no *.jpg frames in {video_dir}")
    return np.stack(map_images(load_frame, paths, w, h, pool=pool))


def tracking_single(student: Student, video_id: int, benchmark_config: Dict,
                    video_root: str = "data/davis_480", refine: bool = True,
                    size_hw=(476, 854), pool: Optional[concurrent.futures.Executor] = None,
                    stats: Optional[Dict] = None) -> Dict[str, float]:
    """One video's TAP-Vid metrics (and its video_idx). `stats`, when given,
    accumulates frames, queries, decode_s (frame decode and resize),
    features_s (the feature passes, the device synchronized after them),
    tracker_s and wall_s, and appends the video's own under "videos"."""
    t0 = time.perf_counter()
    ps = student.cfg.patch_size
    h = size_hw[0] // ps * ps
    w = size_hw[1] // ps * ps
    video_config = next((vc for vc in benchmark_config["videos"]
                         if vc["video_idx"] == video_id), None)
    if video_config is None:
        raise KeyError(f"video_idx {video_id} not in the benchmark pkl "
                       f"({len(benchmark_config['videos'])} videos)")
    frames = load_video_frames(f"{video_root}/{video_id}/video", h, w, pool)
    t_decoded = time.perf_counter()
    feats = video_features(student, frames, refine)
    if stats is not None and feats.is_cuda:
        torch.cuda.synchronize(feats.device)
    t_features = time.perf_counter()
    rx = w / video_config["w"]
    ry = h / video_config["h"]
    cfg = TrackerConfig(patch_size=ps, stride=ps // 2, video_h=h, video_w=w)
    tracks = {}
    with no_tf32(), torch.no_grad():
        for frame_idx in sorted(video_config["query_points"].keys()):
            qpts = np.array([[rx * q[0], ry * q[1], frame_idx]
                             for q in video_config["query_points"][frame_idx]], np.float32)
            tracks[frame_idx] = infer_tracks(feats, torch.from_numpy(qpts), cfg)
    trajectories = {k: t.cpu().numpy() for k, (t, _) in tracks.items()}
    occlusions = {k: o.cpu().numpy() for k, (_, o) in tracks.items()}
    t_tracked = time.perf_counter()
    metrics = compute_tapvid_metrics_for_video(trajectories, occlusions, benchmark_config,
                                               video_id, pred_video_sizes=[w, h])
    metrics["video_idx"] = int(video_id)
    if stats is not None:
        video = {"video_idx": int(video_id), "frames": len(frames),
                 "queries": sum(len(t) for t in trajectories.values()),
                 "decode_s": t_decoded - t0, "features_s": t_features - t_decoded,
                 "tracker_s": t_tracked - t_features, "wall_s": time.perf_counter() - t0}
        for k, v in video.items():
            if k != "video_idx":
                stats[k] = stats.get(k, 0) + v
        stats.setdefault("videos", []).append(video)
    return metrics


def tracking(student: Student, num_videos: int = 30,
             benchmark_pkl: str = "data/tapvid_davis_data_strided.pkl",
             video_root: str = "data/davis_480", refine: bool = True, size_hw=(476, 854),
             pool: Optional[concurrent.futures.Executor] = None,
             stats: Optional[Dict] = None) -> Table:
    """One row per video, indexed by video_idx; frames decoded in `pool`
    when one is given."""
    with open(benchmark_pkl, "rb") as f:
        benchmark_config = pickle.load(f)
    rows = [tracking_single(student, vid, benchmark_config, video_root, refine, size_hw,
                            pool, stats)
            for vid in range(num_videos)]
    return Table.from_rows(rows, "video_idx")
