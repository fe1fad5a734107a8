"""The port's two-stage sparse global alignment (gd3d_torch/sparse_ga.py)
against gd3d's (gd3d/sparse_ga.py) on the CPU, on the synthetic sphere
scenes of tests/test_sparse_ga.py (`_make_synthetic`: 3 views of 48x48),
fed to both packages as the same fp32 arrays.

Tolerances:
- l1_dist, gamma_loss, canonical_view: 1e-6 of the largest value (fp32
  sums in another order); the schedules, anchor_depth_offsets and the MST
  (numpy and scipy in both): equal.
- build_scene: equal arrays, but the relative-depth maps and the offsets
  read from them, 1e-6 (canonical_view's float32 arctan and tan).
- 20 steps of each stage on a noisy scene (0.3 px on the correspondences,
  one pair under the matching gate so the DUSt3R fallback is live): 1e-4
  of the largest value (measured <= 1.1e-5), after the gauge is fixed. The
  root camera's pose is trainable and the losses do not see a global rigid
  motion, so its gradient is fp32 noise that Adam scales into full steps:
  two correct runs float apart along that motion from step 1, while every
  relative quantity agrees. Both results are expressed in the MST root's
  frame before they are compared.
- the full 300 + 300 run: tests/test_sparse_ga.py's recovery bounds.
- build_scene_from_mast3r: a tiny MASt3R on shared weights; the same
  correspondences, the confidences and fallback points within 1e-4 (as
  tests/test_torch_models.py), and build_scene of the port's own teacher
  outputs as above, but the relative-depth maps and offsets 1e-4 (measured
  4.3e-5: a random teacher's points of a block nearly coincide, and
  canonical_view's arctan amplifies fp32 rounding there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gd3d.sparse_ga as J
import gd3d_torch.sparse_ga as T
from tests.test_sparse_ga import _gauge_align, _make_synthetic, _mean_reproj_err, _rot_err_deg
from tests.test_torch_align import tiny_teachers

HELPER_TOL = 1e-6
STEP_TOL = 1e-4
# build_scene's relative-depth maps on a random teacher's outputs: the arctan
# of nearly coincident points' depth differences over their radii amplifies
# fp32 rounding (measured 4.3e-5 of the largest value)
RANDOM_TEACHER_DEPTH_TOL = 1e-4


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def test_losses_and_schedules_match_gd3d():
    rng = np.random.RandomState(0)
    x = rng.randn(7, 3).astype(np.float32)
    y = rng.randn(7, 3).astype(np.float32)
    y[0] = x[0]  # a coincident pair: value and gradient 0, no NaN
    for g in (1.1, 0.4, 1.0):
        want = np.asarray(J.gamma_loss(g)(jnp.asarray(x), jnp.asarray(y)))
        xt = torch.from_numpy(x).requires_grad_(True)
        got = T.gamma_loss(g)(xt, torch.from_numpy(y))
        assert rel_err(got.detach(), want) <= HELPER_TOL
        got.sum().backward()
        jgrad = jax.grad(lambda a: J.gamma_loss(g)(a, jnp.asarray(y)).sum())(jnp.asarray(x))
        assert torch.isfinite(xt.grad).all()
        assert rel_err(xt.grad, jgrad) <= HELPER_TOL
    assert rel_err(T.l1_dist(torch.from_numpy(x), torch.from_numpy(y)),
                   J.l1_dist(jnp.asarray(x), jnp.asarray(y))) <= HELPER_TOL
    for a in (0.0, 0.3, 1.0):
        assert T.cosine_schedule(a, 0.2) == J.cosine_schedule(a, 0.2)
        assert T.linear_schedule(a, 0.2, 0.01) == J.linear_schedule(a, 0.2, 0.01)


@pytest.mark.parametrize("mode", ["avg-angle", "avg-reldepth"])
def test_canonical_view_and_anchors_match_gd3d(mode):
    rng = np.random.RandomState(1)
    n, H, W, sub = 3, 32, 48, 8
    pt = (rng.rand(n, H, W, 3) + [0.1, 0.1, 1.5]).astype(np.float32)
    cf = (1.0 + rng.rand(n, H, W)).astype(np.float32)
    want = J.canonical_view(jnp.asarray(pt), jnp.asarray(cf), sub, mode=mode)
    got = T.canonical_view(torch.from_numpy(pt), torch.from_numpy(cf), sub, mode=mode)
    for g, w in zip(got, want):
        assert rel_err(g, w) <= HELPER_TOL
    canon2 = got[1].numpy()
    pix = np.stack([rng.randint(0, W, 25), rng.randint(0, H, 25)], -1)
    for g, w in zip(T.anchor_depth_offsets(canon2, pix, sub),
                    J.anchor_depth_offsets(canon2, pix, sub)):
        np.testing.assert_array_equal(g, w)


def test_min_spanning_tree_matches_gd3d():
    rng = np.random.RandomState(3)
    for case in range(60):
        n = int(rng.randint(3, 9))
        scores = rng.rand(n, n).astype(np.float32)
        scores = (scores + scores.T) / 2
        np.fill_diagonal(scores, 0.0)
        if case % 3 == 0:  # non-complete pair graphs too (disconnected ones skipped)
            mask = rng.rand(n, n) < 0.4
            mask = mask | mask.T
            np.fill_diagonal(mask, False)
            scores = scores * (~mask)
            from scipy import sparse as sp
            if sp.csgraph.connected_components(sp.csr_array(scores != 0),
                                               directed=False)[0] > 1:
                continue
        assert T.compute_min_spanning_tree(scores) == J.compute_min_spanning_tree(scores)


def noisy_kwargs(seed=3, px=0.3, crush=(0, 2)):
    """_make_synthetic's scene with `px` of noise on image j's
    correspondence pixels and the pair `crush` under the matching gate."""
    kw, gt = _make_synthetic()
    rng = np.random.RandomState(seed)
    for key, (xy_i, xy_j, cf) in kw["corres"].items():
        xy_j = (xy_j + px * rng.randn(*xy_j.shape)).astype(np.float32)
        kw["corres"][key] = (xy_i, xy_j, np.full_like(cf, 0.5) if key == crush else cf)
    return kw, gt


def assert_scenes_equal(got: T.SparseScene, want, depth_tol=HELPER_TOL):
    assert got.hw == tuple(want.hw) and got.n_imgs == want.n_imgs
    assert got.subsample == want.subsample
    assert (got.mst_root, got.mst_edges) == (want.mst_root, tuple(want.mst_edges))
    for f in ("pps", "base_focals", "core_depth0", "e_i", "e_j", "pix_i", "pix_j", "conf",
              "valid", "aidx_i", "aidx_j", "d_pts", "d_conf", "matching_ok"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for f in ("canon2", "off_i", "off_j"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and rel_err(g, w) <= depth_tol, (f, rel_err(g, w))


def test_build_scene_matches_gd3d():
    for kw in (_make_synthetic()[0], noisy_kwargs()[0]):
        want = J.build_scene(subsample=8, **kw)
        assert_scenes_equal(T.build_scene(subsample=8, **kw), want)
    assert not want.matching_ok.all()


def in_root_frame(res, root):
    """The snapshot with every pose and point in the MST root camera's
    frame (the gauge both packages leave free)."""
    g = np.linalg.inv(np.asarray(res["cam2w"][root], np.float64))
    out = dict(res)
    out["cam2w"] = np.einsum("ab,nbc->nac", g, res["cam2w"])
    for k in ("pts3d_i", "pts3d_j"):
        out[k] = res[k] @ g[:3, :3].T + g[:3, 3]
    return out


def test_twenty_steps_of_each_stage_match_gd3d():
    kw, _ = noisy_kwargs()
    scene = J.build_scene(subsample=8, **kw)
    want = J.sparse_scene_optimizer(scene, niter1=20, niter2=20)
    got = T.sparse_scene_optimizer(scene, niter1=20, niter2=20, device="cpu")
    assert set(got) >= {"coarse", "fine"} and len(got["losses"]["fine"]) == 20
    for stage in ("coarse", "fine"):
        assert sorted(got[stage]) == sorted(want[stage])
        g, w = in_root_frame(got[stage], scene.mst_root), in_root_frame(want[stage],
                                                                        scene.mst_root)
        for k in w:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            assert rel_err(g[k], w[k]) <= STEP_TOL, (stage, k, rel_err(g[k], w[k]))
    assert np.isfinite(got["losses"]["coarse"]).all()
    assert got["losses"]["coarse"][-1] < got["losses"]["coarse"][0]


def test_two_stage_recovers_synthetic_geometry():
    """tests/test_sparse_ga.py's recovery test, on the port: the coarse
    stage's poses and baselines, both stages' reprojection error."""
    kwargs, gt_cam2w = _make_synthetic()
    scene = T.build_scene(subsample=8, **kwargs)
    assert scene.matching_ok.all() and len(scene.mst_edges) == scene.n_imgs - 1
    res = T.sparse_scene_optimizer(scene, niter1=300, niter2=300, device="cpu")
    fine, coarse = res["fine"], res["coarse"]
    est_c = _gauge_align(coarse["cam2w"], gt_cam2w)
    est_f = _gauge_align(fine["cam2w"], gt_cam2w)
    for a in range(scene.n_imgs):
        for b in range(a + 1, scene.n_imgs):
            gt_rel = gt_cam2w[a, :3, :3].T @ gt_cam2w[b, :3, :3]
            assert _rot_err_deg(gt_rel, est_c[a, :3, :3].T @ est_c[b, :3, :3]) < 0.3
            assert _rot_err_deg(gt_rel, est_f[a, :3, :3].T @ est_f[b, :3, :3]) < 6.0
    gt_base = gt_cam2w[1:, :3, 3] - gt_cam2w[0, :3, 3]
    est_base = est_c[1:, :3, 3] - est_c[0, :3, 3]
    for g, e in zip(gt_base, est_base):
        assert g @ e / (np.linalg.norm(g) * np.linalg.norm(e) + 1e-12) > 0.99
    assert _mean_reproj_err(scene, coarse) < 0.5
    assert _mean_reproj_err(scene, fine) < 0.5
    pts, depths = T.dense_pts3d(scene, fine)
    assert pts[0].shape == (48 * 48, 3) and all((d > 0).all() for d in depths)
    want_pts, want_depths = J.dense_pts3d(scene, fine)
    for g, w in zip(pts + depths, want_pts + want_depths):
        np.testing.assert_array_equal(g, w)


def test_build_scene_from_mast3r_matches_gd3d(monkeypatch):
    """The frozen-teacher entry on a tiny MASt3R with shared weights (gd3d
    pads its last chunk of pairs to pair_chunk, the port does not): the same
    pairs, correspondences and anchors as gd3d's, the fallback data and
    confidences within 1e-4; and the scene it builds from its own teacher
    outputs equal to gd3d's build_scene of those outputs. The relative-depth
    maps of the two teacher runs are not compared: a random teacher's points
    of a block nearly coincide, and the arctan of two rounding-noise
    differences is any angle."""
    jteacher, params, teacher = tiny_teachers()
    images = (np.random.RandomState(5).rand(3, 64, 64, 3) * 2 - 1).astype(np.float32)
    want = J.build_scene_from_mast3r(jteacher, params, jnp.asarray(images), subsample=8,
                                     matching_conf_thr=0.0, pair_chunk=2)
    seen = []
    build = T.build_scene
    monkeypatch.setattr(T, "build_scene", lambda *a: seen.append(a) or build(*a))
    got = T.build_scene_from_mast3r(teacher, torch.from_numpy(images), subsample=8,
                                    matching_conf_thr=0.0, pair_chunk=2)
    assert (got.mst_root, got.mst_edges) == (want.mst_root, tuple(want.mst_edges))
    for f in ("e_i", "e_j", "pix_i", "pix_j", "valid", "aidx_i", "aidx_j", "matching_ok"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in ("conf", "d_pts", "d_conf"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-4, atol=1e-4,
                                   err_msg=f)
    assert_scenes_equal(got, J.build_scene(*seen[0]), depth_tol=RANDOM_TEACHER_DEPTH_TOL)
    res = T.sparse_scene_optimizer(got, niter1=5, niter2=5, device="cpu")
    assert res["fine"]["cam2w"].shape == (3, 4, 4) and np.isfinite(res["fine"]["cam2w"]).all()
