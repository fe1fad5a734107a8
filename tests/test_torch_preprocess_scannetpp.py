"""The port's ScanNet++ preprocessing (gd3d_torch/data/
preprocess_scannetpp.py) against gd3d's on the fabricated raw scene of
gd3d_torch/data/fixtures.py (a fisheye DSLR with k1..k4 and an iPhone
with radial-tangential distortion over a PLY plane): the same tree, the
committed digests, the readers' views; the PLY and COLMAP readers and the
(H, W) depth render (the port's rasteriser, in many chunks, against gd3d's
native library) bit for bit; the metadata merge's pair offsets."""
import numpy as np
import pytest

import gd3d.data.preprocess_scannetpp as J
import gd3d_torch.data.preprocess_scannetpp as T
from gd3d import native_runtime
from gd3d_torch.data import fixtures
from tests.torch_datagen import (assert_trees_equal, assert_views_equal, committed,
                                 preprocess_both)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return ("scannetpp",) + preprocess_both("scannetpp", tmp_path_factory.mktemp("t"))


def test_tree_equals_gd3d_and_committed_digests(trees):
    dataset, gd3d_tree, port_tree = trees
    assert native_runtime.available()
    assert assert_trees_equal(gd3d_tree, port_tree) == committed()["preprocess"][dataset]
    depth = np.load(port_tree / "all_metadata.npz")
    assert depth["pairs"].shape == (3, 3)


def test_views_equal_gd3d(trees):
    assert_views_equal(*trees)


def test_readers_equal_gd3d(tmp_path):
    fixtures.write_raw_scannetpp(tmp_path)
    scene = tmp_path / "data" / "0a1b2c3d4e"
    ply = str(scene / "scans" / "mesh_aligned_0.05.ply")
    for g, w in zip(T.read_ply_mesh(ply), J.read_ply_mesh(ply)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for cam in ("dslr", "iphone"):
        got, want = (m.load_sfm(str(scene / cam / "colmap"), cam) for m in (T, J))
        assert got[0] == want[0]
        for k in want[1]:
            assert got[1][k]["intrinsics"] == want[1][k]["intrinsics"]
            np.testing.assert_array_equal(got[1][k]["cam_to_world"], want[1][k]["cam_to_world"])


@pytest.mark.parametrize("hw", [(90, 120), (75, 100)])
def test_render_depth_equals_gd3d(hw, monkeypatch):
    import gd3d_torch.data.render_synthetic as TRS

    monkeypatch.setattr(TRS, "CHUNK", 997)  # many chunks
    verts, faces = fixtures._grid_mesh(24, 4.0, 2.0)
    verts = verts + np.random.RandomState(0).rand(*verts.shape) * 0.1
    c2w = np.eye(4)
    c2w[:3, 3] = [0.1, -0.05, 0.2]
    h, w = hw
    K = np.array([[80.0, 0, w / 2 + 0.5], [0, 80.0, h / 2 + 0.5], [0, 0, 1]])
    got, want = (m.render_depth(verts, faces.astype(np.int32), c2w, K, h, w) for m in (T, J))
    assert got.dtype == want.dtype and (got > 0).mean() > 0.9
    np.testing.assert_array_equal(got, want)


def test_merge_offsets_equal_gd3d(tmp_path):
    for root in ("g", "t"):
        for scene in ("sA", "sB"):
            d = tmp_path / root / scene
            d.mkdir(parents=True)
            np.savez(d / "scene_metadata.npz", trajectories=np.tile(np.eye(4), (3, 1, 1)),
                     intrinsics=np.tile(np.eye(3), (3, 1, 1)),
                     images=np.array([f"{scene}_{j}" for j in range(3)]),
                     pairs=np.array([[0, 1, 0.5], [1, 2, 0.5]]))
    J.merge_scene_metadata(str(tmp_path / "g"), ["sA", "sB"])
    T.merge_scene_metadata(str(tmp_path / "t"), ["sA", "sB"])
    assert fixtures.tree_digests(tmp_path / "t") == fixtures.tree_digests(tmp_path / "g")
