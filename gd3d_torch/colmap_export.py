"""COLMAP text-model export for aligned scenes (counterpart of
gd3d/colmap_export.py, copied: numpy only; the same bytes for equal inputs).

Writes cameras.txt / images.txt / points3D.txt, which COLMAP and the
nerf-family tools import directly: the aligned scene is already a full
reconstruction (posed cameras + dense points).

Conventions: COLMAP stores world->cam with scalar-first quaternions
(qw qx qy qz); the aligner returns cam2world with scalar-last, and both
conversions happen here. Tensors are taken as arrays.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np


def _rot_to_colmap_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qw, qx, qy, qz)."""
    from gd3d_torch.align import mat_to_quat  # scalar-last (x, y, z, w)

    x, y, z, w = mat_to_quat(R)
    return np.asarray([w, x, y, z], np.float64)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def export_colmap_text(
    out: Dict[str, np.ndarray],
    outdir: str,
    images: Optional[np.ndarray] = None,
    confidence: Optional[np.ndarray] = None,
    min_conf: float = 1.5,
    max_points: int = 200_000,
    image_names: Optional[list] = None,
    seed: int = 0,
) -> None:
    """Write cameras.txt / images.txt / points3D.txt from a global_align
    result (poses/focals/principal_points/pts3d; DENSE scenes).

    images (n, H, W, 3) in [-1, 1] color the points; confidence (n, H*W)
    gates them (min_conf, same default as the .ply export)."""
    out = {k: _host(v) for k, v in out.items()}
    poses = np.asarray(out["poses"], np.float64)        # cam2world
    focals = np.asarray(out["focals"], np.float64)
    pp = np.asarray(out["principal_points"], np.float64)
    pts3d = np.asarray(out["pts3d"], np.float64)
    assert pts3d.ndim == 4, "COLMAP export needs a dense scene"
    n, H, W, _ = pts3d.shape

    d = Path(outdir)
    d.mkdir(parents=True, exist_ok=True)

    with open(d / "cameras.txt", "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for i in range(n):
            f.write(f"{i + 1} PINHOLE {W} {H} {focals[i]:.6f} "
                    f"{focals[i]:.6f} {pp[i, 0]:.6f} {pp[i, 1]:.6f}\n")

    with open(d / "images.txt", "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, "
                "NAME\n#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for i in range(n):
            c2w = np.eye(4)
            c2w[:3] = poses[i][:3]
            w2c = np.linalg.inv(c2w)
            q = _rot_to_colmap_quat(w2c[:3, :3])
            t = w2c[:3, 3]
            name = (image_names[i] if image_names is not None
                    else f"image_{i:04d}.png")
            f.write(f"{i + 1} {q[0]:.8f} {q[1]:.8f} {q[2]:.8f} {q[3]:.8f} "
                    f"{t[0]:.6f} {t[1]:.6f} {t[2]:.6f} {i + 1} {name}\n\n")

    # confident, subsampled, colored points; empty tracks (the text reader
    # accepts zero-length tracks)
    pts = pts3d.reshape(-1, 3)
    if confidence is not None:
        keep = _host(confidence).reshape(-1) > min_conf
    else:
        keep = np.ones(len(pts), bool)
    if images is not None:
        cols = ((_host(images) + 1) * 127.5).clip(0, 255).astype(
            np.uint8).reshape(-1, 3)
    else:
        cols = np.full((len(pts), 3), 128, np.uint8)
    idx = np.nonzero(keep)[0]
    if len(idx) > max_points:
        idx = np.random.RandomState(seed).choice(
            idx, max_points, replace=False)
    with open(d / "points3D.txt", "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for pid, j in enumerate(idx):
            p = pts[j]
            c = cols[j]
            f.write(f"{pid + 1} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{c[0]} {c[1]} {c[2]} 1.0\n")
