"""The port's COLMAP writers against gd3d's on the same inputs: the text
model (gd3d_torch/colmap_export.py) byte for byte, the sqlite database
(gd3d_torch/colmap_db.py) row for row and blob for blob, and the HTML
viewer (gd3d_torch/utils/html_viewer.py) byte for byte. Tensors are taken
as the arrays they hold."""
import sqlite3

import numpy as np
import pytest
import torch

from gd3d.colmap_db import write_colmap_database as jwrite_db
from gd3d.colmap_export import export_colmap_text as jexport
from gd3d.utils.html_viewer import write_html_viewer as jhtml
from gd3d_torch.colmap_db import MAX_IMAGE_ID, pair_id_of, write_colmap_database
from gd3d_torch.colmap_export import export_colmap_text
from gd3d_torch.utils.html_viewer import write_html_viewer

TABLES = ("cameras", "images", "keypoints", "descriptors", "matches", "two_view_geometries")


def _aligned(seed=0, n=3, H=6, W=8):
    rng = np.random.RandomState(seed)
    poses = np.tile(np.eye(4), (n, 1, 1))
    for k in range(n):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        poses[k, :3, :3] = q * np.sign(np.linalg.det(q))
        poses[k, :3, 3] = rng.randn(3)
    return {"poses": poses.astype(np.float32),
            "focals": (10 + rng.rand(n)).astype(np.float32),
            "principal_points": (np.asarray([W / 2, H / 2]) + rng.randn(n, 2)).astype(np.float32),
            "pts3d": rng.randn(n, H, W, 3).astype(np.float32)}


def _rows(path):
    db = sqlite3.connect(path)
    try:
        return {t: db.execute(f"SELECT * FROM {t}").fetchall() for t in TABLES}
    finally:
        db.close()


@pytest.mark.parametrize("case", ["plain", "colored", "subsampled", "tensors"])
def test_colmap_text_model_equals_gd3d(tmp_path, case):
    out = _aligned()
    n, H, W = out["pts3d"].shape[:3]
    rng = np.random.RandomState(1)
    kw = {}
    if case != "plain":
        kw = dict(images=(rng.rand(n, H, W, 3) * 2 - 1).astype(np.float32),
                  confidence=(1 + rng.rand(n, H * W)).astype(np.float32), min_conf=1.3,
                  image_names=["a.jpg", "b.png", "c.jpg"])
    if case == "subsampled":
        kw.update(max_points=40, seed=3)
    jexport(out, str(tmp_path / "gd3d"), **kw)
    if case == "tensors":
        out = {k: torch.from_numpy(v) for k, v in out.items()}
        kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    export_colmap_text(out, str(tmp_path / "port"), **kw)
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "gd3d" / name).read_bytes()


def _matches(rng, n=3, count=12):
    out = {}
    for i in range(n):
        for j in range(i + 1, n):
            a = np.floor(rng.rand(count, 2) * 8) + 0.5  # repeats: deduped keypoints
            b = np.floor(rng.rand(count, 2) * 8) + 0.5
            out[(i, j)] = (a.astype(np.float32), b.astype(np.float32))
    return out


@pytest.mark.parametrize("priors,min_len", [(True, 2), (False, 2), (True, 3), (True, 5)])
def test_colmap_database_equals_gd3d(tmp_path, priors, min_len):
    out = _aligned(seed=2)
    matches = _matches(np.random.RandomState(4))
    kw = dict(focals=out["focals"], principal_points=out["principal_points"],
              poses_c2w=out["poses"]) if priors else {}
    names = ["a.png", "b.png", "c.png"]
    want = jwrite_db(str(tmp_path / "gd3d.db"), names, (6, 8), matches, min_len_track=min_len,
                     **kw)
    got = write_colmap_database(str(tmp_path / "port.db"), names, (6, 8), matches,
                                min_len_track=min_len, **kw)
    assert got == want
    assert _rows(tmp_path / "port.db") == _rows(tmp_path / "gd3d.db")
    # a rerun replaces the file
    assert write_colmap_database(str(tmp_path / "port.db"), names, (6, 8), matches,
                                 min_len_track=min_len, **kw) == want


def test_pair_id_of():
    assert pair_id_of(2, 3) == 2 * MAX_IMAGE_ID + 3 == pair_id_of(3, 2)


def test_html_viewer_equals_gd3d(tmp_path):
    out = _aligned(seed=5)
    rng = np.random.RandomState(6)
    cols = rng.randint(0, 256, (out["pts3d"].size // 3, 3)).astype(np.uint8)
    for kw in (dict(hw=(6, 8)), dict(max_points=50, seed=2)):
        jhtml(str(tmp_path / "gd3d.html"), out["pts3d"], cols, out["poses"], out["focals"], **kw)
        write_html_viewer(str(tmp_path / "port.html"), out["pts3d"], cols, out["poses"],
                          out["focals"], **kw)
        assert (tmp_path / "port.html").read_bytes() == (tmp_path / "gd3d.html").read_bytes()
