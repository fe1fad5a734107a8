"""The port's visual localization (gd3d_torch/visloc.py, cli/localize.py)
on the CPU.

- solve_localization on exact synthetic 2D-3D correspondences recovers the
  query's known pose (1e-3, gd3d's bound) and gives gd3d's answer on the
  same inputs (1e-6: the port's EPnP RANSAC returns cv2's); the focal from
  the query's point map likewise.
- fine_match_crops: static (max_pairs, G) shapes, padded rows invalid,
  matches inside their planned crop windows (gd3d's test).
- the localize CLI at --tiny against a dense scene of the align CLI; with
  --coarse-to-fine also against gd3d's localize CLI on the same scene.npz
  and teacher state dict: the same keys and names, match counts
  within 1% per query (measured: equal), finite poses. The poses are not
  compared: with random weights the matches are noise, the RANSAC's inlier
  sets hang on reprojection errors at its threshold, and a 1e-6 difference
  of the teacher's focal estimate picks another pose.
"""
import numpy as np
import pytest
import torch

from gd3d.cli.localize import main as jlocalize_main
from gd3d.visloc import solve_localization as jsolve
from gd3d_torch.cli import align, localize
from gd3d_torch.crops import select_crop_pairs
from gd3d_torch.teachers.mast3r import Mast3rTeacher
from gd3d_torch.visloc import fine_match_crops, solve_localization
from tests.test_torch_align_cli import gd3d_cli, inputs  # noqa: F401 (fixtures)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _rotmat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


@pytest.mark.parametrize("seed,angle", [(0, 0.3), (1, 0.1), (2, 0.5)])
def test_solve_localization_recovers_known_pose(seed, angle):
    H = W = 32
    f = 40.0
    K = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float64)
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:H, 0:W]
    world = np.stack([(xs - W / 2) / 8.0, (ys - H / 2) / 8.0,
                      3.0 + 0.3 * np.sin(xs / 3.0) * np.cos(ys / 2.0)], -1)
    R = _rotmat([0.2, 1.0, 0.1], angle)
    t = np.asarray([0.3, -0.2, 0.5])
    sel = rng.choice(H * W, 200, replace=False)
    p3 = world.reshape(-1, 3)[sel]
    cam = p3 @ R.T + t
    uv = (cam[:, :2] / cam[:, 2:]) * f + np.asarray([W / 2, H / 2])
    inside = (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H) & (cam[:, 2] > 0)
    assert inside.sum() > 50
    uv, sel = uv[inside], sel[inside]
    mp = np.stack([sel % W, sel // W], -1).astype(np.float32)
    args = (uv[None].astype(np.float32), mp[None], np.ones((1, len(uv)), bool), [0], world[None],
            None)
    res = solve_localization(*args, K=K, reproj_px=2.0)
    want = jsolve(*args, K=K, reproj_px=2.0)
    assert res["n_matches"] == want["n_matches"] == len(uv)
    w2c = np.eye(4)
    w2c[:3, :3], w2c[:3, 3] = R, t
    np.testing.assert_allclose(res["pose"], np.linalg.inv(w2c), atol=1e-3)
    np.testing.assert_allclose(res["pose"], want["pose"], atol=1e-6)


def test_solve_localization_focal_estimation_path():
    H = W = 16
    f = 25.0
    ys, xs = np.mgrid[0:H, 0:W]
    depth = 2.0 + 0.1 * np.sin(xs / 2.0)
    qpts = np.stack([(xs - W / 2) / f * depth, (ys - H / 2) / f * depth, depth], -1)
    sel = np.arange(H * W)
    mp = np.stack([sel % W, sel // W], -1).astype(np.float32)
    args = (mp[None].copy(), mp[None], np.ones((1, H * W), bool), [0], qpts[None], None)
    res = solve_localization(*args, K=None, query_pts3d=qpts, hw=(H, W), reproj_px=2.0)
    want = jsolve(*args, K=None, query_pts3d=qpts, hw=(H, W), reproj_px=2.0)
    np.testing.assert_allclose(res["K"][0, 0], f, rtol=1e-3)
    np.testing.assert_array_equal(res["K"], want["K"])
    np.testing.assert_allclose(res["pose"], np.eye(4), atol=1e-3)
    np.testing.assert_allclose(res["pose"], want["pose"], atol=1e-6)


def test_solve_localization_without_matches():
    res = solve_localization(np.zeros((1, 4, 2)), np.zeros((1, 4, 2)), np.zeros((1, 4), bool),
                             [0], np.zeros((1, 4, 4, 3)))
    assert res["n_matches"] == 0 and np.array_equal(res["pose"], np.eye(4))


def test_fine_match_crops_batched_static_shape():
    rng = np.random.RandomState(0)
    H1, W1, H2, W2 = 192, 256, 160, 224
    img1 = rng.rand(H1, W1, 3).astype(np.float32) * 2 - 1
    img2 = rng.rand(H2, W2, 3).astype(np.float32) * 2 - 1
    n = 80
    p1 = np.c_[rng.rand(n) * (W1 - 1), rng.rand(n) * (H1 - 1)]
    p2 = np.c_[p1[:, 0] * (W2 / W1), p1[:, 1] * (H2 / H1)]
    crop_hw, max_pairs = (96, 128), 16
    teacher = Mast3rTeacher(align.teacher_config(tiny=True))
    teacher.init_params(torch.Generator().manual_seed(0))
    kp_1, kp_2, valid = fine_match_crops(teacher.eval(), img1, img2, p1, p2, crop_hw=crop_hw,
                                         maxdim=128, max_pairs=max_pairs, min_conf_percent=0.0)
    assert kp_1.shape[0] == max_pairs and kp_1.shape == kp_2.shape
    assert valid.shape == kp_1.shape[:2]
    cells1, cells2 = select_crop_pairs((H1, W1), (H2, W2), p1, p2, maxdim=128,
                                       forced_resolution=crop_hw, max_pairs=max_pairs)
    K = len(cells1)
    assert 0 < K < max_pairs and not valid[K:].any() and valid[:K].any()
    for i in range(K):
        v = valid[i]
        for kp, (l, t, r, b) in ((kp_1[i][v], cells1[i]), (kp_2[i][v], cells2[i])):
            assert (kp[:, 0] >= l).all() and (kp[:, 0] < r).all()
            assert (kp[:, 1] >= t).all() and (kp[:, 1] < b).all()


def _loc_scene(root, views, ckpt):
    scene = root / "loc_scene"
    if not (scene / "scene.npz").exists():
        align.main(["--images", *views, "--output", str(scene), "--tiny", "--size", "224",
                    "--niter", "5", "--pairs", "sliding", "--sparse", "0", "--teacher-ckpt",
                    ckpt, "--device", "cpu"])
    return scene / "scene.npz"


def test_localize_cli(inputs, tmp_path):  # noqa: F811
    root, views, ckpt = inputs
    res = localize.main(["--scene", str(_loc_scene(root, views, ckpt)), "--images", views[0],
                         "--tiny", "--size", "224", "--min-conf", "0.0", "--teacher-ckpt", ckpt,
                         "--output", str(tmp_path), "--device", "cpu"])
    z = np.load(tmp_path / "query_poses.npz")
    assert sorted(z.files) == ["n_matches", "names", "poses"]
    assert z["poses"].shape == (1, 4, 4) and np.isfinite(z["poses"]).all()
    assert z["names"].tolist() == [views[0]] and z["n_matches"][0] > 0
    assert np.array_equal(res["poses"], z["poses"]) and len(res["stats"]["seconds"]) == 1


def test_localize_cli_coarse_to_fine_matches_gd3d(inputs, gd3d_cli, tmp_path):  # noqa: F811
    root, views, ckpt = inputs
    argv = ["--scene", str(_loc_scene(root, views, ckpt)), "--images", views[2], "--tiny",
            "--size", "224", "--min-conf", "0.0", "--teacher-ckpt", ckpt, "--coarse-to-fine",
            "--fine-size", "448"]
    localize.main(argv + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    jlocalize_main(argv + ["--output", str(tmp_path / "gd3d")])
    got = np.load(tmp_path / "port" / "query_poses.npz")
    want = np.load(tmp_path / "gd3d" / "query_poses.npz")
    assert sorted(got.files) == sorted(want.files) == ["n_matches", "names", "poses"]
    assert got["poses"].shape == (1, 4, 4) and np.isfinite(got["poses"]).all()
    np.testing.assert_array_equal(got["names"], want["names"])
    # a near tie of a descriptor argmax (fp32 sums in another order) may flip a match
    assert (got["n_matches"] > 0).all()
    assert (np.abs(got["n_matches"] - want["n_matches"]) <= 0.01 * want["n_matches"]).all()
