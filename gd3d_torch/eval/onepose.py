"""OnePose-LowTexture object-pose evaluation (counterpart of
gd3d/eval/onepose.py, parity target src/evaluate_timm.py:50-231).

A template bank from each object's sequence-1 frames (LoFTR-annotated 2D
keypoints and their SfM 3D points, student descriptors at the /8 grid with
the x16 upsample), a dense stride-4 keypoint grid on every 10th
sequence-2 frame, chunked mutual nearest neighbours, EPnP RANSAC (8 px,
10 000 iterations) and accuracy at {1, 3, 5} degrees and cm jointly.

Where the work runs: the descriptors (cv2's float64 bilinear resize,
gd3d_torch/data/resample.py::resize_linear_cv, then the student's dense
features, interpolation and normalisation) and the matching (two
chunked products and their argmaxes) on the student's device, in full fp32
(no TF32); the RANSAC on the host, gd3d_torch/eval/pnp.py, which repeats
cv2.solvePnPRansac. PNGs are read with cv2's semantics
(gd3d_torch/data/png.py), in a process pool when one is given. The result
is a Table (gd3d_torch/eval/table.py) indexed by object.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gd3d_torch.data.resample import resize_linear_cv
from gd3d_torch.eval.images import load_png_rgb, map_images
from gd3d_torch.eval.pnp import solve_pose
from gd3d_torch.eval.table import Table
from gd3d_torch.models.student import Student
from gd3d_torch.ops.geometry import query_pose_error
from gd3d_torch.ops.interpolate import interpolate_features
from gd3d_torch.teachers.mast3r import no_tf32

THRESHOLDS = (1, 3, 5)
ROW_CHUNK = 2048  # rows of a similarity product: 0.98 GB of fp32 against a 120 000-row bank


def _device(student: Student) -> torch.device:
    return next(student.parameters()).device


@torch.no_grad()
def frame_descriptors(student: Student, rgb: np.ndarray, kps: np.ndarray,
                      refine: bool = True) -> torch.Tensor:
    """Descriptors (N, C) on the student's device at pixel keypoints kps
    (N, 2) of the original uint8 frame: cv2's bilinear resize of rgb / 255
    to (h // 8 * 16, w // 8 * 16) in float64 on the device (bit for bit
    cv2's), then float32, the dense forward at the patch stride
    (ImageNet normalisation, the refine conv when `refine`), the features
    interpolated at kps / 8 * 16 with 16-px patch centres, L2-normalised
    with + 1e-9."""
    device = _device(student)
    h, w = rgb.shape[:2]
    ps = student.cfg.patch_size
    rh, rw = h // 8 * ps, w // 8 * ps
    rgb64 = torch.from_numpy(np.ascontiguousarray(rgb)).to(device, torch.float64) / 255.0
    x = resize_linear_cv(rgb64, (rw, rh)).to(torch.float32)[None]
    k = torch.from_numpy(np.asarray(kps, np.float32)[None]).to(device)
    with no_tf32():
        grid = student.dense_grid_features(x, refine=refine)
        d = interpolate_features(grid.permute(0, 3, 1, 2), k / 8.0 * ps, h=rh, w=rw,
                                 normalize=False, patch_size=ps, stride=ps)[0].T
        return d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-9)


def _argmax_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """argmax_j (a @ b.T)[i] for each row i, ROW_CHUNK rows a product."""
    return torch.cat([torch.argmax(a[lo: lo + ROW_CHUNK] @ b.T, dim=-1)
                      for lo in range(0, len(a), ROW_CHUNK)])


@torch.no_grad()
def mutual_nn_match(desc_q: torch.Tensor, desc_t: torch.Tensor) -> np.ndarray:
    """Mutual nearest neighbours of query and template descriptors (both on
    one device): the template index of each query row, or -1. Two separate
    chunked products, queries against templates and templates against
    queries, as gd3d computes them; argmax keeps the first index of a tie."""
    with no_tf32():
        nbr1 = _argmax_rows(desc_q, desc_t)
        nbr2 = _argmax_rows(desc_t, desc_q)
    mutual = nbr2[nbr1] == torch.arange(len(nbr1), device=nbr1.device)
    return torch.where(mutual, nbr1, -1).cpu().numpy()


def grid_keypoints(h: int, w: int, stride: int = 4) -> np.ndarray:
    """(x, y) of a stride grid over an h x w frame, row by row, float64."""
    xm, ym = np.meshgrid(np.arange(0, w, stride), np.arange(0, h, stride))
    return np.column_stack([xm.ravel(), ym.ravel()]).astype(float)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_object(student: Student, templates: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                    test_frames: Sequence[Dict], grid_stride: int = 4, template_cap: int = 120_000,
                    refine: bool = True, rng: Optional[np.random.RandomState] = None,
                    stats: Optional[Dict] = None) -> Dict[str, float]:
    """Pose accuracy of one object. templates: (kp2d (N, 2), rgb (H, W, 3)
    uint8, kp3d (N, 3)) of sequence-1 frames; test_frames: dicts with rgb,
    intrinsic (3, 3) and pose_gt (4, 4). A bank above `template_cap` rows is
    sampled by rng.choice(..., replace=False) (RandomState(0) by default),
    and the query grid comes from the first test frame's size, as in gd3d.
    `stats`, when given, accumulates templates, template_rows, frames,
    descriptors_s, nn_s, pnp_s (the device synchronized between them) and
    ransac_iterations, and appends each test frame's under "frames_detail"."""
    device = _device(student)
    rng = rng or np.random.RandomState(0)
    t0 = time.perf_counter()
    desc_t = torch.cat([frame_descriptors(student, rgb, kp2d, refine)
                        for kp2d, rgb, _ in templates])
    pts3d_t = np.concatenate([kp3d for _, _, kp3d in templates], 0)
    if len(desc_t) > template_cap:
        idx = rng.choice(len(desc_t), template_cap, replace=False)
        desc_t = desc_t[torch.from_numpy(idx).to(device)]
        pts3d_t = pts3d_t[idx]
    _sync(device)
    t_bank = time.perf_counter()

    R_errs, t_errs, frames = [], [], []
    kp = None
    for frame in test_frames:
        rgb = frame["rgb"]
        if kp is None:
            kp = grid_keypoints(rgb.shape[0], rgb.shape[1], grid_stride)
        ta = time.perf_counter()
        desc_q = frame_descriptors(student, rgb, kp, refine)
        _sync(device)
        tb = time.perf_counter()
        nn = mutual_nn_match(desc_q, desc_t)
        tc = time.perf_counter()
        m = nn >= 0
        ransac: Dict = {}
        pose = solve_pose(kp[m], pts3d_t[nn[m]], frame["intrinsic"], stats=ransac)
        r, t = query_pose_error(pose, frame["pose_gt"])
        R_errs.append(r)
        t_errs.append(t)
        frames.append({"matches": int(m.sum()), "descriptors_s": tb - ta, "nn_s": tc - tb,
                       "pnp_s": time.perf_counter() - tc,
                       "ransac_iterations": ransac.get("iterations", 0),
                       "inliers": ransac.get("best", 0)})

    R, T = np.array(R_errs), np.array(t_errs)
    if stats is not None:
        stats["templates"] = stats.get("templates", 0) + len(templates)
        stats["template_rows"] = stats.get("template_rows", 0) + len(desc_t)
        stats["frames"] = stats.get("frames", 0) + len(test_frames)
        stats["bank_s"] = stats.get("bank_s", 0.0) + (t_bank - t0)
        for key in ("descriptors_s", "nn_s", "pnp_s", "ransac_iterations"):
            stats[key] = stats.get(key, 0) + sum(f[key] for f in frames)
        stats.setdefault("frames_detail", []).extend(frames)
    with np.errstate(invalid="ignore"):
        return {f"threshold_{th}": float(np.mean((R < th) & (T < th))) for th in THRESHOLDS}


def load_onepose_object(root: str, sfm_dir: str, obj_name: str, test_seq: str = "2",
                        every_nth: int = 10,
                        pool: Optional[concurrent.futures.Executor] = None):
    """Templates and test frames of one object in the OnePose-LowTexture
    layout (evaluate_timm.py:69-138): sequence names from
    obj_name.split("-")[1], the templates from <seq>-1/anno_loftr/*.json and
    color/<idx>.png with the SfM points of anno_3d_average.npz, the test
    frames every `every_nth` of <seq>-<test_seq>/color/*.png sorted, with
    intrin_ba and poses_ba. PNGs are decoded in `pool` when one is given."""
    root = Path(root)
    seq1 = obj_name.split("-")[1] + "-1"
    seq2 = obj_name.split("-")[1] + f"-{test_seq}"
    keypoints3d = np.load(f"{sfm_dir}/{obj_name}/anno/anno_3d_average.npz")["keypoints3d"]

    annos: List[Tuple[np.ndarray, np.ndarray]] = []
    paths = []
    for json_fn in sorted((root / obj_name / seq1 / "anno_loftr").glob("*.json")):
        with open(json_fn) as f:
            anno = json.load(f)
        annos.append((np.array(anno["keypoints2d"]), np.array(anno["assign_matrix"])))
        paths.append(str(root / obj_name / seq1 / "color" / f"{json_fn.stem}.png"))
    fns = sorted((root / obj_name / seq2 / "color").glob("*.png"))[::every_nth]
    rgbs = map_images(load_png_rgb, paths + [str(fn) for fn in fns], pool=pool)

    templates = [(kp2d[assign[0]], rgb, keypoints3d[assign[1]])
                 for (kp2d, assign), rgb in zip(annos, rgbs)]
    test_frames = [{"rgb": rgb,
                    "intrinsic": np.loadtxt(str(root / obj_name / seq2 / "intrin_ba" / f"{fn.stem}.txt")),
                    "pose_gt": np.loadtxt(str(root / obj_name / seq2 / "poses_ba" / f"{fn.stem}.txt"))}
                   for fn, rgb in zip(fns, rgbs[len(paths):])]
    return templates, test_frames


def oneposepp(student: Student, root: str = "data/lowtexture_test_data",
              sfm_dir: str = "data/sfm_output/outputs_softmax_loftr_loftr",
              num_objs: Optional[int] = None, refine: bool = True,
              pool: Optional[concurrent.futures.Executor] = None,
              stats: Optional[Dict] = None) -> Table:
    """One row per object directory under `root` (sorted, the first
    `num_objs`), indexed by objs, with threshold_{1,3,5}. `stats`, when
    given, accumulates evaluate_object's and decode_s and wall_s."""
    t0 = time.perf_counter()
    objs = sorted(n for n in os.listdir(root) if (Path(root) / n).is_dir())
    if num_objs is not None:
        objs = objs[:num_objs]
    rows = []
    for obj in objs:
        td = time.perf_counter()
        templates, test_frames = load_onepose_object(root, sfm_dir, obj, pool=pool)
        if stats is not None:
            stats["decode_s"] = stats.get("decode_s", 0.0) + time.perf_counter() - td
        rows.append({**evaluate_object(student, templates, test_frames, refine=refine,
                                       stats=stats), "objs": obj})
    if stats is not None:
        stats["wall_s"] = stats.get("wall_s", 0.0) + time.perf_counter() - t0
    return Table.from_rows(rows, "objs") if rows else Table("objs", [], {})
