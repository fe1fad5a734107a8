"""Two-view pretraining pairs with dense ground truth (counterpart of
gd3d/data/pretrain_pairs.py): world pointmaps, valid and sky masks,
cam2world poses and padded pixel correspondences for the MASt3R
pretraining loss.

- `synthetic_pretrain_batch`: procedural meshes rendered in process
  (data/render_synthetic.py, gd3d's native rasteriser's arithmetic), the
  background as sky, shared mesh vertices visible in both z-buffers as
  correspondences;
- `rendered_pretrain_batch`: an on-disk render tree (color_/depth_/
  mask_%06d.png per object, depth uint16 millimetres, obj_poses.npy
  world2cam), correspondences by reprojecting view-1 pixels into view 2.

`_load_view` reads the PNGs with data/png.py and resizes as gd3d's PIL
calls do: the colour with Pillow's bilinear filter, the depth and the mask
with Pillow's nearest rule (data/resample.py). Colour must be 8-bit RGB:
another kind (RGBA, which Pillow would premultiply before resizing, grey,
a palette) raises naming the file.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from gd3d_torch.data import png
from gd3d_torch.data.render_synthetic import (
    DEFAULT_INTRINSIC,
    fixed_poses,
    procedural_object,
    render_mesh,
)
from gd3d_torch.data.resample import resize_bilinear, resize_nearest_pil


def _unproject_world(depth: np.ndarray, K: np.ndarray,
                     E: np.ndarray) -> np.ndarray:
    """depth (H, W) + world2cam E -> world-frame pointmap (H, W, 3)."""
    H, W = depth.shape
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    rays = np.stack([u, v, np.ones_like(u)], -1) @ np.linalg.inv(K).T
    cam = rays * depth[..., None]
    R, t = E[:3, :3], E[:3, 3]
    return (cam - t) @ R  # R^-1 = R^T applied row-wise


def synthetic_pretrain_batch(
    seed: int,
    batch: int = 1,
    img: int = 64,
    n_corres: int = 64,
) -> Dict[str, np.ndarray]:
    """Batch for build_mast3r_pretrain_step: img1/img2 in [-1, 1] plus
    gt1/gt2 dicts (camera_pose cam2world, world pts3d, valid/sky masks,
    padded pixel correspondences with a validity mask)."""
    rng = np.random.RandomState(seed)
    K = DEFAULT_INTRINSIC * (img / 512.0)
    K[2, 2] = 1.0
    poses_all = fixed_poses(42)

    out = {"img1": [], "img2": []}
    gts: Dict[int, Dict[str, list]] = {
        1: {k: [] for k in ("camera_pose", "pts3d", "valid_mask",
                            "sky_mask", "corres")},
        2: {k: [] for k in ("camera_pose", "pts3d", "valid_mask",
                            "sky_mask", "corres")},
    }
    valid_corres = []
    for b in range(batch):
        verts, faces, colors = procedural_object(
            np.random.RandomState(seed * 1000 + b))
        i, j = rng.choice(len(poses_all), 2, replace=False)
        views = []
        for vi, E in enumerate((poses_all[i], poses_all[j])):
            rgb, depth, mask = render_mesh(verts, faces, colors, E, K, img)
            pts3d = _unproject_world(depth, K, E)
            views.append((E, rgb, depth, mask, pts3d))
            out[f"img{vi + 1}"].append(
                rgb.astype(np.float32) / 255.0 * 2.0 - 1.0)
            g = gts[vi + 1]
            g["camera_pose"].append(np.linalg.inv(E).astype(np.float32))
            g["pts3d"].append(pts3d.astype(np.float32))
            g["valid_mask"].append(mask)
            g["sky_mask"].append(~mask)  # background plays the sky role

        # correspondences: mesh vertices visible (z-buffer) in BOTH views
        sel = rng.choice(len(verts), min(4 * n_corres, len(verts)),
                         replace=False)
        uvs, vis = [], []
        for E, _rgb, depth, mask, _p in views:
            cam = verts[sel] @ E[:3, :3].T + E[:3, 3]
            uv = cam @ K.T
            uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-8)
            ui = np.clip(uv.astype(np.int64), 0, img - 1)
            inb = ((uv[:, 0] >= 0) & (uv[:, 0] < img)
                   & (uv[:, 1] >= 0) & (uv[:, 1] < img))
            zbuf = depth[ui[:, 1], ui[:, 0]]
            ok = inb & (np.abs(cam[:, 2] - zbuf) < 0.02) & (zbuf > 0)
            uvs.append(ui)
            vis.append(ok)
        both = vis[0] & vis[1]
        order = np.argsort(~both)  # visible-in-both first
        take = order[:n_corres]
        vc = both[take]
        if len(take) < n_corres:  # pad (marked invalid)
            pad = n_corres - len(take)
            take = np.concatenate([take, np.zeros(pad, np.int64)])
            vc = np.concatenate([vc, np.zeros(pad, bool)])
        gts[1]["corres"].append(uvs[0][take])
        gts[2]["corres"].append(uvs[1][take])
        valid_corres.append(vc)

    batch_out: Dict[str, np.ndarray] = {
        "img1": np.stack(out["img1"]),
        "img2": np.stack(out["img2"]),
    }
    for vi in (1, 2):
        batch_out[f"gt{vi}"] = {
            k: np.stack(v) for k, v in gts[vi].items()}
    batch_out["gt1"]["valid_corres"] = np.stack(valid_corres)
    batch_out["gt1"]["is_metric_scale"] = np.zeros((batch,), bool)
    return batch_out


def _grey(path) -> np.ndarray:
    p = png.decode_png(path)
    if p.color_type != 0:
        raise ValueError(f"{path}: expected a grey PNG, got colour type {p.color_type}")
    return p.samples[..., 0]


def _load_view(obj_dir, view: int, img: int):
    """One rendered view -> (rgb [-1,1], depth meters, valid mask), all at
    (img, img). Depth/mask resample NEAREST (mixing depths across the
    silhouette would fabricate geometry); rgb resamples bilinear."""
    path = obj_dir / f"color_{view:06d}.png"
    c = png.decode_png(path)
    if c.color_type != 2 or c.bit_depth != 8:
        raise ValueError(f"{path}: the colour views must be 8-bit RGB PNGs, got colour type "
                         f"{c.color_type} at {c.bit_depth} bits")
    rgb = resize_bilinear(c.samples, (img, img)).astype(np.float32)
    depth = resize_nearest_pil(_grey(obj_dir / f"depth_{view:06d}.png"),
                               (img, img)).astype(np.float32)
    mask = resize_nearest_pil(_grey(obj_dir / f"mask_{view:06d}.png"), (img, img)) > 0
    depth = depth / 1000.0  # uint16 millimetres (blenderproc.py layout)
    return rgb[..., :3] / 255.0 * 2.0 - 1.0, depth, mask & (depth > 0)


def rendered_pretrain_batch(
    root,
    seed: int,
    batch: int = 1,
    img: int = 224,
    n_corres: int = 256,
    depth_eps: float = 0.02,
) -> Dict[str, np.ndarray]:
    """Batch for build_mast3r_pretrain_step from an on-disk render tree
    (gd3d-render output or real Objaverse renderings in the same
    blenderproc.py layout). Correspondences: sample valid view-1 pixels,
    unproject with the stored depth, reproject into view 2 and keep hits
    whose depth agrees within `depth_eps` (nearest-pixel convention)."""
    from pathlib import Path

    root = Path(root)
    poses_all = np.load(root / "obj_poses.npy")  # (V, 4, 4) world2cam
    dirs = sorted(p for p in root.iterdir()
                  if p.is_dir() and (p / "color_000000.png").exists())
    assert dirs, f"no rendered objects under {root}"
    K = DEFAULT_INTRINSIC * (img / 512.0)
    K[2, 2] = 1.0

    rng = np.random.RandomState(seed)
    out = {"img1": [], "img2": []}
    gts: Dict[int, Dict[str, list]] = {
        v: {k: [] for k in ("camera_pose", "pts3d", "valid_mask",
                            "sky_mask", "corres")} for v in (1, 2)}
    valid_corres = []
    for _ in range(batch):
        d = dirs[rng.randint(len(dirs))]
        i, j = rng.choice(len(poses_all), 2, replace=False)
        views = []
        for vi, E in enumerate((poses_all[i], poses_all[j])):
            rgb, depth, mask = _load_view(d, (i, j)[vi], img)
            pts3d = _unproject_world(depth, K, E)
            views.append((E, depth, mask, pts3d))
            out[f"img{vi + 1}"].append(rgb.astype(np.float32))
            g = gts[vi + 1]
            g["camera_pose"].append(np.linalg.inv(E).astype(np.float32))
            g["pts3d"].append(pts3d.astype(np.float32))
            g["valid_mask"].append(mask)
            g["sky_mask"].append(~mask)

        # correspondences: reproject valid view-1 pixels into view 2
        E1, depth1, mask1, pts1 = views[0]
        E2, depth2, mask2, _ = views[1]
        ys, xs = np.nonzero(mask1)
        take = rng.permutation(len(ys))[: 4 * n_corres]
        ys, xs = ys[take], xs[take]
        world = pts1[ys, xs]                                  # (M, 3)
        cam2 = world @ E2[:3, :3].T + E2[:3, 3]
        uv = cam2 @ K.T
        uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-8)
        ui = np.clip(np.floor(uv).astype(np.int64), 0, img - 1)
        inb = ((uv[:, 0] >= 0) & (uv[:, 0] < img)
               & (uv[:, 1] >= 0) & (uv[:, 1] < img) & (cam2[:, 2] > 0))
        zbuf = depth2[ui[:, 1], ui[:, 0]]
        ok = inb & (np.abs(cam2[:, 2] - zbuf) < depth_eps) & (zbuf > 0)
        order = np.argsort(~ok)                # visible-in-both first
        sel = order[:n_corres]
        vc = ok[sel]
        c1 = np.stack([xs[sel], ys[sel]], -1)
        c2 = ui[sel]
        if len(sel) < n_corres:                # pad (marked invalid)
            pad = n_corres - len(sel)
            c1 = np.concatenate([c1, np.zeros((pad, 2), np.int64)])
            c2 = np.concatenate([c2, np.zeros((pad, 2), np.int64)])
            vc = np.concatenate([vc, np.zeros(pad, bool)])
        gts[1]["corres"].append(c1)
        gts[2]["corres"].append(c2)
        valid_corres.append(vc)

    batch_out: Dict[str, np.ndarray] = {
        "img1": np.stack(out["img1"]),
        "img2": np.stack(out["img2"]),
    }
    for vi in (1, 2):
        batch_out[f"gt{vi}"] = {
            k: np.stack(v) for k, v in gts[vi].items()}
    batch_out["gt1"]["valid_corres"] = np.stack(valid_corres)
    batch_out["gt1"]["is_metric_scale"] = np.zeros((batch,), bool)
    return batch_out
