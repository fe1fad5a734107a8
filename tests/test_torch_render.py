"""The port's renderer and render CLI (gd3d_torch/data/render_synthetic.py,
gd3d_torch/cli/render.py) against gd3d's, which rasterises through its
native library (native/libgd3d_native.so, built here).

Bit for bit: the rasteriser on (h, w) frames, in one chunk and in many
(a small CHUNK), with and without colour; render_mesh with Lambert
shading, with and without shadows (GD3D_RENDER_SHADOWS); the trees of
render_object_tree and of the CLI (procedural, .glb, --workers, --poses,
--objects with nested names): the same files, PNGs that decode to the
same pixels, the same obj_poses.npy. The trees of chip_smoke.py's datagen
phase (fixtures.RENDER_RUNS) match gd3d_torch/data/testdata/
datagen_digests.json."""
import numpy as np
import pytest

import gd3d.data.render_synthetic as JRS
import gd3d_torch.data.render_synthetic as TRS
from gd3d import native_runtime
from gd3d.cli.render import main as gd3d_render
from gd3d_torch.cli.render import main as port_render
from gd3d_torch.data import fixtures
from tests.torch_datagen import assert_trees_equal, committed, quiet


@pytest.fixture(autouse=True, scope="module")
def native():
    assert native_runtime.available(), "gd3d's render_mesh must run its native library here"


def _scene(seed=0):
    verts, faces, colors = TRS.procedural_object(np.random.RandomState(seed))
    E = TRS.fixed_poses(6)[seed % 6]
    return verts @ E[:3, :3].T + E[:3, 3], faces, colors.astype(np.float32)


@pytest.mark.parametrize("hw", [(60, 100), (128, 96), (33, 47)])
@pytest.mark.parametrize("chunk", [1 << 20, 257])
def test_rasterize_hw_equals_native(hw, chunk, monkeypatch):
    monkeypatch.setattr(TRS, "CHUNK", chunk)
    cam, faces, colors = _scene(hw[0])
    h, w = hw
    K = np.array([[90.0, 0.3, w / 2 + 3], [0, 85.0, h / 2 - 2], [0, 0, 1]])
    want = native_runtime.rasterize_mesh(cam, faces, colors, K, h, w)
    got = TRS.rasterize_mesh(cam, faces, colors, K, h, w)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)
    rgb, depth = TRS.rasterize_mesh(cam, faces, None, K, h, w)
    np.testing.assert_array_equal(depth, want[1])
    assert not rgb.any()


@pytest.mark.parametrize("shadows", ["1", "0"])
@pytest.mark.parametrize("size", [64, 128])
def test_shaded_render_equals_gd3d(shadows, size, monkeypatch):
    monkeypatch.setenv("GD3D_RENDER_SHADOWS", shadows)
    from gd3d_torch.data.glb import vertex_normals

    verts, faces, colors = TRS.procedural_object(np.random.RandomState(size))
    normals = vertex_normals(verts, faces)
    K = TRS.DEFAULT_INTRINSIC * (size / 512.0)
    K[2, 2] = 1.0
    for E in TRS.fixed_poses(4)[:2]:
        got = TRS.render_mesh(verts, faces, colors, E, K, size, normals=normals)
        want = JRS.render_mesh(verts, faces, colors, E, K, size, normals=normals)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_object_tree_equals_gd3d(tmp_path):
    fixtures.write_glb(tmp_path / "glb" / fixtures.GLB_NAME)
    for kw in ({"seed": 3}, {"glb_root": str(tmp_path / "glb")}):
        names = ["000-000/obj0", "obj1"] if "seed" in kw else [fixtures.GLB_NAME]
        pw = JRS.render_object_tree(str(tmp_path / "g"), names, n_views=3, size=96, **kw)
        pt = TRS.render_object_tree(str(tmp_path / "p"), names, n_views=3, size=96, **kw)
        np.testing.assert_array_equal(pt, pw)
    assert_trees_equal(tmp_path / "g", tmp_path / "p")


@pytest.mark.parametrize("run", list(fixtures.RENDER_RUNS))
def test_cli_runs_equal_gd3d_and_committed_digests(run, tmp_path):
    """The datagen phase's render runs, at its 512^2: the port's tree
    equals gd3d's, and both the committed digests."""
    glb_root = tmp_path / "glb"
    fixtures.write_glb(glb_root / fixtures.GLB_NAME)
    quiet(gd3d_render, fixtures.render_argv(run, glb_root, tmp_path / "g"))
    poses = quiet(port_render, fixtures.render_argv(run, glb_root, tmp_path / "p"))
    assert poses.shape[1:] == (4, 4)
    digests = assert_trees_equal(tmp_path / "g", tmp_path / "p")
    assert digests == committed()["render"][run]


def test_cli_workers_poses_and_object_list(tmp_path):
    names = tmp_path / "names.txt"
    names.write_text("000-001/a\n\n000-002/b\nc\n")
    argv = ["--objects", str(names), "--views", "3", "--size", "64", "--seed", "5",
            "--poses", "data/obj_poses.npy"]
    quiet(gd3d_render, argv + ["--output", str(tmp_path / "g")])
    quiet(port_render, argv + ["--workers", "2", "--output", str(tmp_path / "p")])
    quiet(port_render, argv + ["--workers", "3", "--output", str(tmp_path / "p3")])
    assert_trees_equal(tmp_path / "g", tmp_path / "p")
    assert_trees_equal(tmp_path / "g", tmp_path / "p3")
    np.testing.assert_array_equal(np.load(tmp_path / "p" / "obj_poses.npy"),
                                  np.load("data/obj_poses.npy")[:3])
