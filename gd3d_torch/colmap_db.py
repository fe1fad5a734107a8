"""COLMAP sqlite database export (counterpart of gd3d/colmap_db.py, copied:
numpy and stdlib sqlite3; the same rows and blobs for equal inputs).

Turns per-pair reciprocal correspondences into a COLMAP `database.db`
(mast3r/colmap/database.py's export_images + export_matches flow):
per-image keypoints, pairwise matches, prior poses and intrinsics, with
multi-view tracks built by union-find and short tracks dropped
(min_len_track), so that COLMAP's point_triangulator / bundle_adjuster can
run on the port's reconstructions. The schema is COLMAP's standard one
(colmap/scripts/python/database.py, BSD): PINHOLE cameras,
keypoints/matches/two_view_geometries blobs,
pair_id = image_id1 * 2147483647 + image_id2.
"""
from __future__ import annotations

import sqlite3
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAX_IMAGE_ID = 2147483647
_PINHOLE = 1  # COLMAP camera model id (fx, fy, cx, cy)

_SCHEMA = """
CREATE TABLE cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL);
CREATE TABLE keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


def pair_id_of(image_id1: int, image_id2: int) -> int:
    """COLMAP pair key; ids are 1-based, smaller id first."""
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def _blob(a: np.ndarray, dtype) -> bytes:
    return np.ascontiguousarray(a, dtype).tobytes()


def _rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) from a rotation matrix (COLMAP convention)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)


class _DSU:
    """Union-find over (image, keypoint) nodes — the reference uses
    scipy DisjointSet for the same track merge (database.py:271-330)."""

    def __init__(self):
        self.parent: Dict = {}

    def find(self, x):
        p = self.parent.setdefault(x, x)
        while p != x:
            self.parent[x] = self.parent.setdefault(p, p)
            x, p = self.parent[x], self.parent[self.parent[x]]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def write_colmap_database(
    path: str,
    image_names: Sequence[str],
    hw: Tuple[int, int],
    matches: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]],
    focals: Optional[np.ndarray] = None,
    principal_points: Optional[np.ndarray] = None,
    poses_c2w: Optional[np.ndarray] = None,
    min_len_track: int = 2,
    skip_geometric_verification: bool = True,
) -> Dict[str, int]:
    """Write a COLMAP database.

    matches: {(i, j): (xy_i, xy_j)} 0-based image indices i < j with
      (M, 2) float pixel coords per side (row m of xy_i corresponds to
      row m of xy_j).
    focals/principal_points/poses_c2w: optional priors from gd3d-align
      output (PINHOLE camera + prior world->cam pose per image).
    min_len_track: drop correspondences whose union-find track spans
      fewer than this many distinct (image, keypoint) observations
      (export_matches's min_len_track semantics).

    Returns counts {images, keypoints, matches} for logging/tests.
    """
    n = len(image_names)
    H, W = hw

    # 1) dedupe keypoints per image; map pixel -> kp index
    kp_index: List[Dict[Tuple[float, float], int]] = [dict() for _ in range(n)]
    kps: List[List[Tuple[float, float]]] = [[] for _ in range(n)]

    def kp_id(img: int, xy) -> int:
        key = (float(xy[0]), float(xy[1]))
        idx = kp_index[img].get(key)
        if idx is None:
            idx = len(kps[img])
            kp_index[img][key] = idx
            kps[img].append(key)
        return idx

    pair_matches: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    dsu = _DSU()
    for (i, j), (xy_i, xy_j) in matches.items():
        assert i < j, "pass unordered pairs with i < j"
        rows = []
        for a, b in zip(np.asarray(xy_i), np.asarray(xy_j)):
            ka, kb = kp_id(i, a), kp_id(j, b)
            rows.append((ka, kb))
            dsu.union((i, ka), (j, kb))
        pair_matches[(i, j)] = rows

    # 2) track filter: observations per union-find root
    track_len: Dict = {}
    for img in range(n):
        for k in range(len(kps[img])):
            r = dsu.find((img, k))
            track_len[r] = track_len.get(r, 0) + 1

    def keep(img, k) -> bool:
        return track_len[dsu.find((img, k))] >= min_len_track

    import os

    if os.path.exists(path):  # re-runs must replace, not trip CREATE TABLE
        os.unlink(path)
    db = sqlite3.connect(path)
    try:
        db.executescript(_SCHEMA)
        for img in range(n):
            f = float(focals[img]) if focals is not None else 1.2 * max(H, W)
            if principal_points is not None:
                cx, cy = map(float, principal_points[img])
            else:
                cx, cy = W / 2.0, H / 2.0
            db.execute(
                "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
                (img + 1, _PINHOLE, W, H,
                 _blob(np.array([f, f, cx, cy]), np.float64),
                 int(focals is not None)),
            )
            prior = (None,) * 7
            if poses_c2w is not None:
                w2c = np.linalg.inv(np.asarray(poses_c2w[img], np.float64))
                q = _rotmat_to_qvec(w2c[:3, :3])
                prior = (*q.tolist(), *w2c[:3, 3].tolist())
            db.execute(
                "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (img + 1, str(image_names[img]), img + 1, *prior),
            )
            arr = np.asarray(kps[img], np.float32).reshape(-1, 2)
            db.execute(
                "INSERT INTO keypoints VALUES (?, ?, ?, ?)",
                (img + 1, arr.shape[0], 2, _blob(arr, np.float32)),
            )

        n_matches = 0
        for (i, j), rows in pair_matches.items():
            rows = [(a, b) for a, b in rows if keep(i, a) and keep(j, b)]
            if not rows:
                continue
            arr = np.asarray(rows, np.uint32).reshape(-1, 2)
            pid = pair_id_of(i + 1, j + 1)
            db.execute(
                "INSERT INTO matches VALUES (?, ?, ?, ?)",
                (pid, arr.shape[0], 2, _blob(arr, np.uint32)),
            )
            if skip_geometric_verification:
                # config 2 = calibrated: COLMAP treats the matches as
                # already verified (the reference's
                # skip_geometric_verification path)
                db.execute(
                    "INSERT INTO two_view_geometries VALUES "
                    "(?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                    (pid, arr.shape[0], 2, _blob(arr, np.uint32), 2,
                     _blob(np.eye(3), np.float64),
                     _blob(np.eye(3), np.float64),
                     _blob(np.eye(3), np.float64),
                     _blob(np.array([1.0, 0, 0, 0]), np.float64),
                     _blob(np.zeros(3), np.float64)),
                )
            n_matches += arr.shape[0]
        db.commit()
    finally:
        db.close()
    return {
        "images": n,
        "keypoints": int(sum(len(k) for k in kps)),
        "matches": int(n_matches),
    }
