"""PF-PASCAL semantic-transfer PCK (counterpart of gd3d/eval/pck.py).

Square-canvas resize to 640 (the port's PIL-exact Lanczos), padded
keypoints, dense student features (ImageNet normalization, refine conv),
source keypoint descriptors sampled with gd3d's 14-px interpolation quirk,
the keypoint similarity taken on the patch grid, bilinearly upsampled
(align_corners) to the patch-centre span and edge-padded to 640^2, argmax;
PCK@{0.05, 0.10, 0.15} * 640 per category and the weighted mean. The pair
CSVs are read with the csv module (gd3d's pandas columns by position), and
the result is a Table (gd3d_torch/eval/table.py), not a DataFrame. The
feature passes run in full fp32 (no TF32).
"""
from __future__ import annotations

import concurrent.futures
import csv
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gd3d_torch.data.jpeg import jpeg_size
from gd3d_torch.eval.images import load_canvas, map_images, resize_to_canvas
from gd3d_torch.eval.table import Table
from gd3d_torch.models.dpt import resize_bilinear_ac
from gd3d_torch.models.student import Student
from gd3d_torch.ops.interpolate import interpolate_features
from gd3d_torch.teachers.mast3r import no_tf32

__all__ = ["PASCAL_CATEGORIES", "CATEGORY_WEIGHTS", "preprocess_kps_pad", "resize_to_canvas",
           "resolve_pascal_csv", "load_pascal_pairs", "make_match_fn", "semantic_transfer"]

PASCAL_CATEGORIES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow",
    "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]
CATEGORY_WEIGHTS = [15, 30, 10, 6, 8, 32, 19, 27, 13, 3,
                    8, 24, 9, 27, 12, 7, 1, 13, 20, 15]
REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")


def preprocess_kps_pad(kps: np.ndarray, w: int, h: int, size: int) -> np.ndarray:
    """Keypoints (N, 3) as (x, y, visible) rescaled to the size^2 canvas and
    offset by its padding; invisible ones zeroed."""
    kps = kps.copy()
    scale = size / max(w, h)
    kps[:, :2] *= scale
    if h < w:
        new_h = int(np.around(size * h / w))
        kps[:, 1] += (size - new_h) // 2
    elif w < h:
        new_w = int(np.around(size * w / h))
        kps[:, 0] += (size - new_w) // 2
    kps *= kps[:, 2:3].copy()
    return kps


def resolve_pascal_csv(path: str, same_view: bool) -> str:
    """The pair CSV in the PF-PASCAL dir, or the repo's vendored copy under
    data/ when the dir has none."""
    name = f"test_pairs_pf_{'same' if same_view else 'different'}_views.csv"
    local = os.path.join(path, name)
    if not os.path.isfile(local):
        vendored = os.path.join(REPO_DATA, name)
        if os.path.isfile(vendored):
            return vendored
    return local


def load_pascal_pairs(path: str, size: int, category: str,
                      same_view: bool) -> Tuple[List[str], np.ndarray]:
    """The category's pairs: image paths (source, target alternating) and
    their padded keypoints (2 * pairs, K, 3), K the keypoint slots any image
    uses. Columns by position, as gd3d's iloc: 0 and 1 the images, 2 the
    1-based class, 3-4 the source's x and y lists, 5-6 the target's."""
    with open(resolve_pascal_csv(path, same_view), newline="") as f:
        rows = list(csv.reader(f))[1:]
    cat_id = PASCAL_CATEGORIES.index(category)
    subset = [r for r in rows if int(r[2]) - 1 == cat_id]

    def get_points(xs: str, ys: str) -> np.ndarray:
        X = np.fromstring(xs, sep=";")
        Y = np.fromstring(ys, sep=";")
        pts = np.stack([-np.ones(20), -np.ones(20), np.zeros(20)], axis=1)
        pts[: len(X), 0] = X
        pts[: len(X), 1] = Y
        pts[: len(X), 2] = 1
        return pts.astype(np.float32)

    files, kps = [], []
    for r in subset:
        for name, pts in ((r[0], get_points(r[3], r[4])), (r[1], get_points(r[5], r[6]))):
            fn = f"{path}/../{name}"
            w, h = jpeg_size(fn)
            files.append(fn)
            kps.append(preprocess_kps_pad(pts, w, h, size))
    if not kps:
        return files, np.zeros((0, 0, 3), np.float32)
    kps = np.stack(kps)
    used = np.where(kps[:, :, 2].any(axis=0))[0]
    return files, kps[:, used, :]


def make_match_fn(student: Student, img_size: int = 640, refine: bool = True,
                  max_kps: int = 20, batch_pairs: int = 8):
    """The pair matcher: `match(pairs)` for a list of (img1_u8, img2_u8,
    kps1), in batches of `batch_pairs` (the tail padded by repetition),
    each batch two feature passes of the student on the device. Keypoints
    are padded to max_kps. Returns (n, 2) predicted (x, y) pixels of img2
    per pair."""
    ps = student.cfg.patch_size
    device = next(student.parameters()).device
    ds_size = ((img_size - ps) // ps) * ps + 1
    pad_l = ps // 2
    pad_r = img_size - ds_size - pad_l

    @torch.no_grad()
    def fn(img1: np.ndarray, img2: np.ndarray, kps1: np.ndarray) -> np.ndarray:
        with no_tf32():
            x1 = torch.from_numpy(img1).to(device).float() / 255.0
            x2 = torch.from_numpy(img2).to(device).float() / 255.0
            d1 = student.dense_grid_features(x1, refine=refine)
            d2 = student.dense_grid_features(x2, refine=refine)
            # gd3d's quirk: the reference samples the descriptors with
            # interpolate_features' default 14-px patch and stride
            kp_desc = interpolate_features(d1.permute(0, 3, 1, 2), torch.from_numpy(kps1).to(device),
                                           h=img_size, w=img_size, normalize=True,
                                           patch_size=14, stride=14)  # (B, C, N)
            # the dot commutes with the (linear) upsample and pad: take it on
            # the patch grid, then upsample the N-channel similarity map
            sim = torch.einsum("bcn,bhwc->bnhw", kp_desc, d2)
            sim = resize_bilinear_ac(sim, (ds_size, ds_size))
            sim = F.pad(sim, (pad_l, pad_r, pad_l, pad_r), mode="replicate")
            nn_idx = torch.argmax(sim.reshape(sim.shape[0], sim.shape[1], -1), dim=-1)
            out = torch.stack([nn_idx % img_size, nn_idx // img_size], dim=-1)
        return out.cpu().numpy()

    def _pad_kps(kps1: np.ndarray) -> np.ndarray:
        pad = max(0, max_kps - kps1.shape[0])
        return np.pad(kps1[:, :2].astype(np.float32), ((0, pad), (0, 0)))[:max_kps]

    def match(pairs):
        preds = []
        for lo in range(0, len(pairs), batch_pairs):
            chunk = pairs[lo: lo + batch_pairs]
            padded = chunk + [chunk[-1]] * (batch_pairs - len(chunk))
            out = fn(np.stack([p[0] for p in padded]).astype(np.uint8),
                     np.stack([p[1] for p in padded]).astype(np.uint8),
                     np.stack([_pad_kps(p[2]) for p in padded]))
            preds.extend(out[i, : chunk[i][2].shape[0]] for i in range(len(chunk)))
        return preds

    return match


def semantic_transfer(student: Student, data_path: str,
                      categories: Optional[Sequence[str]] = None, same_view: bool = False,
                      img_size: int = 640, refine: bool = True,
                      alphas: Sequence[float] = (0.1, 0.05, 0.15),
                      pool: Optional[concurrent.futures.Executor] = None,
                      stats: Optional[Dict[str, float]] = None) -> Table:
    """The PCK table: one row per category present in the pair CSV (index
    "categories"), columns PCK<a> for the sorted alphas, then the weighted
    means over the categories. Images are decoded in `pool` when one is
    given. `stats`, when given, accumulates decode_s, pairs and wall_s."""
    t0 = time.perf_counter()
    categories = list(categories or PASCAL_CATEGORIES)
    results: Dict[float, List[float]] = {a: [] for a in alphas}
    kept: List[str] = []
    match = make_match_fn(student, img_size, refine, max_kps=20)
    decode_s, n_pairs = 0.0, 0
    for cat in categories:
        files, kps = load_pascal_pairs(data_path, img_size, cat, same_view)
        if len(files) < 2:
            continue
        kept.append(cat)
        t_dec = time.perf_counter()
        canvases = map_images(load_canvas, files, img_size, pool=pool)
        decode_s += time.perf_counter() - t_dec
        pairs, vis_all, gt_all = [], [], []
        for i in range(len(files) // 2):
            k1, k2 = kps[2 * i], kps[2 * i + 1]
            vis = k1[:, 2] * k2[:, 2] > 0
            pairs.append((canvases[2 * i], canvases[2 * i + 1], k1))
            vis_all.append(vis)
            gt_all.append(k2[vis][:, [1, 0]])
        n_pairs += len(pairs)
        preds = match(pairs)
        pred = np.concatenate([p[v][:, [1, 0]] for p, v in zip(preds, vis_all)], 0)
        err = np.linalg.norm(pred - np.concatenate(gt_all, 0), axis=-1)
        for a in alphas:
            results[a].append(float((err < a * img_size).mean()))
    cols = {f"PCK{a:.2f}": results[a] for a in sorted(alphas)}
    weights = [CATEGORY_WEIGHTS[PASCAL_CATEGORIES.index(c)] for c in kept]
    for col in list(cols):
        mean = float(np.average(cols[col], weights=weights)) if kept else float("nan")
        cols[f"Weighted {col}"] = [mean] * len(kept)
    if stats is not None:
        stats["decode_s"] = stats.get("decode_s", 0.0) + decode_s
        stats["pairs"] = stats.get("pairs", 0) + n_pairs
        stats["wall_s"] = stats.get("wall_s", 0.0) + time.perf_counter() - t0
    return Table("categories", kept, cols)
