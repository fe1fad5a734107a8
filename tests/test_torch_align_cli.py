"""The port's align CLI (gd3d_torch/cli/align.py) against gd3d's on the
CPU, and the port's demo server (gd3d_torch/cli/demo.py).

Both CLIs run at `--tiny --size 224 --niter 5` on three PNG views cut from
one seeded texture, with one tiny upstream-layout MASt3R state dict as
--teacher-ckpt. gd3d's CLI cannot load such a file as it stands: it imports
`load_torch_state` from gd3d.teachers.convert, which does not define it,
and converts with the full MASt3R config whatever --tiny says. The test
hands it gd3d.cli.train's `load_torch_state` and the tiny config (and jits
its teacher call, which its CLI runs eagerly); nothing in gd3d changes.

Tolerances: scene.npz's images equal; confidence 1e-4 (the teacher on
shared weights, as tests/test_torch_models.py); losses, poses, focals,
principal points, depth maps and points 1e-3 of their largest value (five
Adam steps from an init that fp32 teacher differences of ~1e-6 move);
.ply: the same header and vertex count, values 1e-3 of the largest.
"""
import functools
import http.client
import uuid

import jax
import numpy as np
import pytest
import torch

import gd3d.teachers.convert as jconvert
import gd3d.teachers.mast3r as jmast3r
from gd3d.cli.align import main as jalign_main
from gd3d.cli.demo import _parse_multipart as j_parse_multipart
from gd3d.cli.train import load_torch_state as jload_torch_state
from gd3d.models.croco import CrocoConfig as JCrocoConfig
from gd3d.models.mast3r import Mast3rConfig as JMast3rConfig
from gd3d_torch.cli import align, demo
from gd3d_torch.data.fixtures import texture
from gd3d_torch.data.png import encode_png_rgb
from gd3d_torch.teachers.mast3r import Mast3rTeacher

TOL = 1e-3


def write_views(root, n=3, h=96, w=128, step=16, seed=0):
    """n PNG views, overlapping windows of one seeded texture."""
    big = texture(np.random.RandomState(seed), h, w + step * (n - 1))
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for k in range(n):
        p = root / f"view_{k}.png"
        p.write_bytes(encode_png_rgb(np.ascontiguousarray(big[:, k * step:k * step + w])))
        paths.append(str(p))
    return paths


def write_teacher_ckpt(path, seed=0):
    teacher = Mast3rTeacher(align.teacher_config(tiny=True))
    teacher.init_params(torch.Generator().manual_seed(seed))
    torch.save(teacher.model.state_dict(), path)
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("align_cli")
    return root, write_views(root / "views"), write_teacher_ckpt(root / "mast3r_tiny.pth")


@pytest.fixture
def gd3d_cli(monkeypatch):
    """gd3d's align CLI, able to read the tiny state dict (see above)."""
    jcfg = JMast3rConfig(croco=JCrocoConfig(
        patch_size=16, enc_embed_dim=32, enc_depth=2, enc_num_heads=2, dec_embed_dim=16,
        dec_depth=2, dec_num_heads=2), local_feat_dim=6, dpt_feature_dim=16, dpt_last_dim=8)
    monkeypatch.setattr(jconvert, "load_torch_state", jload_torch_state, raising=False)
    monkeypatch.setattr(jmast3r, "convert_mast3r",
                        functools.partial(jmast3r.convert_mast3r, cfg=jcfg))
    jitted = jax.jit(jmast3r.Mast3rTeacher.extract_features, static_argnums=0,
                     static_argnames="dtype")
    monkeypatch.setattr(jmast3r.Mast3rTeacher, "extract_features",
                        lambda self, params, a, b, temperature=1.0, dtype=None:
                        jitted(self, params, a, b, temperature, dtype=dtype))
    return jalign_main


def close(got, want, tol=TOL):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= tol, err


def read_ply(path):
    lines = path.read_text().splitlines()
    end = lines.index("end_header")
    return lines[:end + 1], np.loadtxt(lines[end + 1:], ndmin=2)


@pytest.mark.parametrize("flags,dense", [
    (["--pairs", "sliding"], True),
    (["--pairs", "swin-2", "--pair-filter", "seq1", "--sparse", "64"], False)])
def test_align_cli_scene_matches_gd3d(inputs, gd3d_cli, flags, dense):
    root, views, ckpt = inputs
    tag = "dense" if dense else "sparse"
    argv = ["--images", *views, "--tiny", "--size", "224", "--niter", "5", "--teacher-ckpt",
            ckpt, "--ply", "--min-conf", "0.0", *flags]
    gd3d_cli(argv + ["--output", str(root / f"gd3d_{tag}")])
    res = align.main(argv + ["--output", str(root / f"port_{tag}"), "--device", "cpu"])
    want = np.load(root / f"gd3d_{tag}" / "scene.npz")
    got = np.load(root / f"port_{tag}" / "scene.npz")
    assert sorted(got.files) == sorted(want.files)
    np.testing.assert_array_equal(got["images"], want["images"])
    np.testing.assert_allclose(got["confidence"], want["confidence"], rtol=1e-4, atol=1e-4)
    for k in ("losses", "poses", "focals", "principal_points", "depthmaps", "pts3d"):
        close(got[k], want[k])
    n = len(views)
    assert got["depthmaps"].shape == ((n, 224, 224) if dense else (n, 64))
    head, pts = read_ply(root / f"port_{tag}" / "pointcloud.ply")
    whead, wpts = read_ply(root / f"gd3d_{tag}" / "pointcloud.ply")
    assert head == whead and head[0] == "ply"
    close(pts, wpts)
    assert res["stats"]["pairs"] == (6 if dense else 4)


def test_align_cli_exports(inputs):
    """The port's --tsdf, --colmap, --colmap-db and --html on a dense run:
    every file written, gd3d's keys and shapes, finite values, and the
    database read back through sqlite3."""
    import sqlite3

    root, views, ckpt = inputs
    out = root / "port_exports"
    res = align.main(["--images", str(root / "views"), "--output", str(out), "--tiny", "--size",
                      "224", "--niter", "3", "--teacher-ckpt", ckpt, "--sparse", "0", "--tsdf",
                      "0.3", "--tsdf-samples", "8", "--colmap", "--colmap-db", "--html",
                      "--device", "cpu"])
    z = np.load(out / "scene.npz")
    assert z["pts3d"].shape == (3, 224, 224, 3) and z["confidence"].shape == (3, 224 * 224)
    assert all(np.isfinite(z[k]).all() for k in z.files)
    assert {"teacher_s", "align_s", "tsdf_s", "pairs"} <= set(res["stats"])
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (out / "colmap" / name).stat().st_size > 0
    assert b"<html" in (out / "scene.html").read_bytes()[:200].lower()
    db = sqlite3.connect(out / "database.db")
    try:
        assert [r[1] for r in db.execute("SELECT * FROM images")] == [
            "view_0.png", "view_1.png", "view_2.png"]
        assert db.execute("SELECT COUNT(*) FROM keypoints").fetchone()[0] == 3
    finally:
        db.close()


def test_align_cli_refusals(inputs, tmp_path):
    root, views, _ = inputs
    bmp = tmp_path / "view.bmp"
    bmp.write_bytes(b"BM")
    with pytest.raises(ValueError, match="view.bmp"):
        align.main(["--images", views[0], str(bmp), "--output", str(tmp_path), "--tiny",
                    "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            align.main(["--images", *views, "--output", str(tmp_path), "--tiny"])


def multipart(files, fields):
    boundary = f"----gd3d{uuid.uuid4().hex}"
    out = bytearray()
    for name, value in fields.items():
        out += (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="{name}"\r\n\r\n{value}\r\n').encode()
    for fname, payload in files:
        out += (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="images"; filename="{fname}"\r\n'
                f"Content-Type: image/png\r\n\r\n").encode()
        out += payload + b"\r\n"
    out += f"--{boundary}--\r\n".encode()
    return bytes(out), f"multipart/form-data; boundary={boundary}"


def test_parse_multipart_matches_gd3d():
    body, ctype = multipart([("a.png", b"\x89PNG123"), ("../b.png", b"x" * 10)],
                            {"niter": "7", "pairs": "sliding"})
    got = demo._parse_multipart(body, ctype)
    assert got == j_parse_multipart(body, ctype)
    assert got == ({"niter": "7", "pairs": "sliding"},
                   [("a.png", b"\x89PNG123"), ("b.png", b"x" * 10)])


def test_demo_server_reconstructs_uploads(inputs, tmp_path):
    root, views, ckpt = inputs
    args = demo.parse_args(["--output", str(tmp_path / "scenes"), "--tiny", "--port", "0",
                            "--size", "224", "--niter", "3", "--min-conf", "0.0",
                            "--teacher-ckpt", ckpt, "--device", "cpu"])
    srv, port = demo.serve_background(args)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("GET", "/")
        r = conn.getresponse()
        assert r.status == 200 and b"reconstruct" in r.read()
        body, ctype = multipart([(f"v{k}.png", open(p, "rb").read()) for k, p in
                                 enumerate(views[:2])], {"niter": "3", "pairs": "complete"})
        conn.request("POST", "/reconstruct", body=body, headers={"Content-Type": ctype})
        r = conn.getresponse()
        r.read()
        assert r.status == 303, r.status
        loc = r.getheader("Location")
        conn.request("GET", loc)
        r = conn.getresponse()
        assert r.status == 200 and b"<html" in r.read().lower()
        session = loc.split("/")[2]
        z = np.load(tmp_path / "scenes" / session / "scene.npz")
        assert z["poses"].shape == (2, 4, 4) and np.isfinite(z["poses"]).all()
        conn.request("GET", "/")
        assert session.encode() in conn.getresponse().read()
        conn.request("GET", "/scenes/../../etc/passwd")
        r = conn.getresponse()
        r.read()
        assert r.status == 404
    finally:
        srv.shutdown()
        srv.server_close()
