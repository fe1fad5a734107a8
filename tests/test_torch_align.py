"""The port's global alignment (gd3d_torch/align.py) against gd3d's
(gd3d/align.py) on the CPU, on the synthetic scenes of
tests/test_global_align.py (gd3d's `_make_scene`: 4 views of 8x8, edges
up to 2 frames apart), fed to both packages as the same fp32 arrays.

Tolerances:
- init_from_tree, align_pair and sparse_from_scene: equal bits (both are
  the same float64 / fp32 numpy; anchors tie in numpy's argsort order).
- _scene_loss and its gradient: 1e-5 of the largest value (fp32 sums in
  another order).
- global_align's loss trajectory over 20 steps and its outputs after them:
  1e-5 of the largest value (measured: <= 1e-6). After 150 steps the losses
  1e-3 (measured: <= 6.2e-4, the linear schedule's) and the outputs 1e-2
  (measured: <= 4.6e-4, except the free poses of the two-poses-pinned case,
  4.5e-3: with the scale fixed from outside, Adam walks a flat valley where
  fp32 rounding moves the poses while the loss stays within 1.4e-4). The
  parity scenes are
  noisy (0.03 fp32 noise on every point): on a noiseless scene the
  tree init is exact, the safe L1's gradient there is fp32 rounding noise
  that Adam scales to full steps, and two correct implementations part at
  step 1 (the port is held to gd3d's recovery bounds there instead).
- init=None: gd3d's jax.random draws fed to the port's `normal_draw`.
- scene_from_mast3r: a tiny MASt3R on shared weights, 1e-4 (as
  tests/test_torch_models.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gd3d.align as J
import gd3d_torch.align as T
from gd3d.models.croco import CrocoConfig as JCrocoConfig
from gd3d.models.mast3r import Mast3rConfig as JMast3rConfig
from gd3d.teachers.mast3r import Mast3rTeacher as JMast3rTeacher
from gd3d.teachers.mast3r import convert_mast3r
from gd3d_torch.models.croco import CrocoConfig
from gd3d_torch.models.mast3r import Mast3rConfig
from gd3d_torch.teachers.mast3r import Mast3rTeacher
from tests.test_global_align import FOCAL, H, W, _make_scene, _rel_pose_errors

STEP_TOL = 1e-5
LONG_LOSS_TOL = 1e-3
LONG_TOL = 1e-2


def port_scene(js) -> T.Scene:
    """gd3d's Scene as the port's, the same fp32 values."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32).copy())  # noqa: E731
    return T.Scene(edges=np.asarray(js.edges), pred_i=t(js.pred_i), pred_j=t(js.pred_j),
                   conf_i=t(js.conf_i), conf_j=t(js.conf_j), hw=js.hw, n_imgs=js.n_imgs,
                   pix=None if js.pix is None else np.asarray(js.pix))


def noisy_scenes(seed=7, scale=0.03, conf_seed=None):
    """gd3d's _make_scene with fp32 noise on every point (and, with
    conf_seed, random confidences): (gd3d Scene, port Scene, gt poses, gt
    depths)."""
    scene, gt_poses, gt_depths = _make_scene()
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    pi = f32(f32(scene.pred_i) + f32(scale * rng.randn(*scene.pred_i.shape)))
    pj = f32(f32(scene.pred_j) + f32(scale * rng.randn(*scene.pred_j.shape)))
    ci, cj = f32(scene.conf_i), f32(scene.conf_j)
    if conf_seed is not None:
        r = np.random.RandomState(conf_seed)
        ci, cj = f32(1 + 4 * r.rand(*ci.shape)), f32(1 + 4 * r.rand(*cj.shape))
    js = J.Scene(edges=scene.edges, pred_i=jnp.asarray(pi), pred_j=jnp.asarray(pj),
                 conf_i=jnp.asarray(ci), conf_j=jnp.asarray(cj), hw=scene.hw,
                 n_imgs=scene.n_imgs)
    return js, port_scene(js), gt_poses, gt_depths


def rel_err(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def assert_outputs_close(got, want, tol, loss_tol=None):
    for k in ("losses", "poses", "focals", "principal_points", "depthmaps", "pts3d"):
        err = rel_err(got[k], want[k])
        tol_k = loss_tol if k == "losses" and loss_tol is not None else tol
        assert np.isfinite(err) and err <= tol_k, (k, err)


@pytest.mark.parametrize("kind", ["exact", "noisy", "noisy_conf"])
def test_init_from_tree_matches_gd3d(kind):
    if kind == "exact":
        js = _make_scene()[0]
        ts = port_scene(js)
    else:
        js, ts, _, _ = noisy_scenes(conf_seed=3 if kind == "noisy_conf" else None)
    want, got = J.init_from_tree(js), T.init_from_tree(ts)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("dist,norm_pw", [("l1", True), ("l2", True), ("l1", False)])
def test_scene_loss_and_gradient_match_gd3d(dist, norm_pw):
    js, ts, _, _ = noisy_scenes()
    jparams = J._init_params(js, J.init_from_tree(js), jax.random.key(0), norm_pw=norm_pw)
    rng = np.random.RandomState(2)  # live principal points and adaptors too
    jparams = dict(jparams, im_pp=jnp.asarray(rng.randn(4, 2).astype(np.float32) * 0.1),
                   pw_adaptors=jnp.asarray(rng.randn(len(js.edges), 2).astype(np.float32)))
    n = js.n_imgs
    grid = jnp.broadcast_to(J._pixel_grid(js.hw)[None], (n, H * W, 2))
    pp_base = jnp.tile(jnp.asarray([[W / 2, H / 2]], jnp.float32), (n, 1))
    ei, ej = jnp.asarray(js.edges[:, 0]), jnp.asarray(js.edges[:, 1])
    wi = jnp.log(jnp.maximum(js.conf_i, 1.0 + 1e-6))
    wj = jnp.log(jnp.maximum(js.conf_j, 1.0 + 1e-6))
    want, wgrads = jax.jit(jax.value_and_grad(lambda p: J._scene_loss(
        p, js, grid, pp_base, ei, ej, wi, wj, dist, norm_pw)))(jparams)

    params = {k: torch.from_numpy(np.asarray(v).copy()).requires_grad_(True)
              for k, v in jparams.items()}
    loss = T._scene_loss(
        params, ts, T._pixel_grid(ts.hw)[None].expand(n, H * W, 2),
        torch.tensor([[W / 2, H / 2]]).repeat(n, 1), torch.from_numpy(ts.edges[:, 0].astype(np.int64)),
        torch.from_numpy(ts.edges[:, 1].astype(np.int64)),
        torch.log(torch.clamp(ts.conf_i, min=1.0 + 1e-6)),
        torch.log(torch.clamp(ts.conf_j, min=1.0 + 1e-6)), dist, norm_pw)
    loss.backward()
    assert rel_err(loss, want) <= STEP_TOL
    for k in jparams:
        assert rel_err(params[k].grad, wgrads[k]) <= STEP_TOL, k


PRESETS = {
    "default": {},
    "l2": dict(dist="l2"),
    "linear": dict(schedule="linear"),
    "pp_and_adaptors": dict(optimize_pp=True, allow_pw_adaptors=True),
    "known_poses_mask": "poses",
    "known_focal_index": dict(known_focals=np.asarray([12.0]), focal_mask=np.asarray([0])),
    "known_pp_index": dict(known_pp=np.asarray([[W / 2 + 1.0, H / 2 - 1.0]]),
                           pp_mask=np.asarray([0]), optimize_pp=True),
    "known_depths_mask": "depths",
    "known_poses_all": "poses_all",
}


def preset_kwargs(name, gt_poses, gt_depths):
    kw = PRESETS[name]
    if kw == "poses":
        return dict(known_poses=gt_poses, pose_mask=np.asarray([True, True, False, False]))
    if kw == "poses_all":
        return dict(known_poses=gt_poses)
    if kw == "depths":
        return dict(known_poses=gt_poses, known_depths=gt_depths,
                    depth_mask=np.asarray([True, False, False, False]))
    return kw


@pytest.mark.parametrize("preset", list(PRESETS))
def test_global_align_20_steps_match_gd3d(preset):
    js, ts, gt_poses, gt_depths = noisy_scenes()
    kw = preset_kwargs(preset, gt_poses, gt_depths)
    want = J.global_align(js, niter=20, **kw)
    got = T.global_align(ts, niter=20, **kw)
    assert_outputs_close(got, want, STEP_TOL)


@pytest.mark.parametrize("preset", ["default", "l2", "linear", "known_poses_mask"])
def test_global_align_150_steps_match_gd3d(preset):
    js, ts, gt_poses, gt_depths = noisy_scenes()
    kw = preset_kwargs(preset, gt_poses, gt_depths)
    assert_outputs_close(T.global_align(ts, niter=150, **kw),
                         J.global_align(js, niter=150, **kw), LONG_TOL, LONG_LOSS_TOL)


@pytest.mark.parametrize("preset", ["known_poses_mask", "known_depths_mask", "known_focal_index",
                                    "known_pp_index"])
def test_pinned_rows_stay_bit_exact(preset):
    """A pinned row takes a zero gradient, so its Adam moments and updates
    are exactly 0: the outputs of its image after 20 steps equal those of
    the init (0 steps) bit for bit, while the free images move."""
    _, ts, gt_poses, gt_depths = noisy_scenes()
    kw = preset_kwargs(preset, gt_poses, gt_depths)
    key, mask = {"known_poses_mask": ("poses", "pose_mask"),
                 "known_depths_mask": ("depthmaps", "depth_mask"),
                 "known_focal_index": ("focals", "focal_mask"),
                 "known_pp_index": ("principal_points", "pp_mask")}[preset]
    rows = np.zeros(4, bool)
    rows[kw[mask]] = True
    start, end = T.global_align(ts, niter=0, **kw), T.global_align(ts, niter=20, **kw)
    assert torch.equal(start[key][rows], end[key][rows])
    assert not torch.equal(start[key][~rows], end[key][~rows])
    if preset == "known_depths_mask":
        np.testing.assert_allclose(end["depthmaps"][0].numpy(), gt_depths[0], rtol=1e-6)


def test_global_align_random_init_matches_gd3d(monkeypatch):
    """init=None: gd3d's jax.random log-depth draws fed to the port."""
    js, ts, _, _ = noisy_scenes()
    monkeypatch.setattr(T, "normal_draw", lambda shape, seed, device: torch.from_numpy(
        np.array(jax.random.normal(jax.random.key(seed), shape))).to(device))
    assert_outputs_close(T.global_align(ts, niter=20, init=None, seed=3),
                         J.global_align(js, niter=20, init=None, seed=3), STEP_TOL)


def test_global_align_random_init_runs():
    """The port's own draws: the optimizer runs finite from scratch, and the
    draws are standard normal by their statistics."""
    scene = port_scene(_make_scene(n=3)[0])
    out = T.global_align(scene, niter=20, init=None)
    assert torch.isfinite(out["losses"]).all() and torch.isfinite(out["poses"]).all()
    x = T.normal_draw((200_000,), 0, "cpu")
    assert abs(float(x.mean())) < 0.01 and abs(float(x.std()) - 1) < 0.01
    assert not torch.equal(x, T.normal_draw((200_000,), 1, "cpu"))


def test_global_align_recovers_known_scene():
    """gd3d's known-answer bounds on the noiseless scene (the port's own
    trajectory): relative rotation and translation direction < 2 degrees,
    focal within 10%, depth up to one global scale."""
    scene, gt_poses, gt_depths = _make_scene()
    out = T.global_align(port_scene(scene), niter=150)
    assert float(out["losses"][-1]) < 0.02
    rot, direc, _ = _rel_pose_errors(out["poses"].numpy(), gt_poses)
    assert rot < 2.0 and direc < 2.0, (rot, direc)
    np.testing.assert_allclose(out["focals"].numpy(), FOCAL, rtol=0.1)
    ratio = out["depthmaps"].numpy() / gt_depths
    assert ratio.std() / ratio.mean() < 0.05


def _random_scene(hw, n=3, seed=0):
    rng = np.random.RandomState(seed)
    edges = [(i, j) for i in range(n) for j in range(n) if i != j]
    maps = [rng.randn(len(edges), *hw, 3).astype(np.float32) for _ in range(2)]
    confs = [(1 + rng.randint(0, 4, (len(edges),) + hw)).astype(np.float32) for _ in range(2)]
    js = J.Scene.from_pairs(edges, list(maps[0]), list(maps[1]), list(confs[0]), list(confs[1]))
    return js, T.Scene.from_pairs(edges, list(maps[0]), list(maps[1]), list(confs[0]),
                                  list(confs[1]))


@pytest.mark.parametrize("case", ["constant_conf_k24", "constant_conf_k16", "random_conf_k40",
                                  "fill_k36", "all_k64"])
def test_sparse_from_scene_matches_gd3d(case):
    """The anchors (ties in numpy's argsort order) and the gathered maps,
    equal; the fill case has fewer non-empty cells than k."""
    if case.startswith("constant"):
        js = _make_scene()[0]
        ts = port_scene(js)
    elif case == "fill_k36":
        js, ts = _random_scene((4, 16))
    else:
        js, ts = _random_scene((8, 8), seed=1)
    k = int(case.split("_k")[1])
    want, got = J.sparse_from_scene(js, k=k), T.sparse_from_scene(ts, k=k)
    np.testing.assert_array_equal(got.pix, want.pix)
    for name in ("pred_i", "pred_j", "conf_i", "conf_j"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert got.hw == want.hw and got.n_imgs == want.n_imgs


def test_sparse_global_align_matches_gd3d():
    js, ts, _, _ = noisy_scenes()
    want = J.global_align(J.sparse_from_scene(js, k=24), niter=20)
    got = T.global_align(T.sparse_from_scene(ts, k=24), niter=20)
    assert got["depthmaps"].shape == (4, 24) and got["pts3d"].shape == (4, 24, 3)
    assert_outputs_close(got, want, STEP_TOL)


def test_sparse_alignment_recovers_poses():
    scene, gt_poses, _ = _make_scene()
    out = T.global_align(T.sparse_from_scene(port_scene(scene), k=24), niter=150)
    rot, direc, _ = _rel_pose_errors(out["poses"].numpy(), gt_poses)
    assert rot < 2.0 and direc < 2.0, (rot, direc)


def test_align_pair_matches_gd3d():
    scene = _make_scene(n=2)[0]
    want, got = J.align_pair(scene), T.align_pair(port_scene(scene))
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_scene_rejects_mixed_shapes():
    a, b, c = np.zeros((H, W, 3)), np.zeros((H + 2, W, 3)), np.zeros((H, W))
    with pytest.raises(AssertionError):
        T.Scene.from_pairs([(0, 1)], [a], [b], [c], [c])


CROCO_KW = dict(patch_size=16, enc_embed_dim=32, enc_depth=2, enc_num_heads=2,
                dec_embed_dim=16, dec_depth=2, dec_num_heads=2)
MAST3R_KW = dict(local_feat_dim=6, dpt_feature_dim=16, dpt_last_dim=8)


def tiny_teachers(seed=0):
    """The align CLI's tiny MASt3R in both packages on one seeded port init
    (upstream key layout, carried into gd3d by its convert_mast3r); gd3d's
    teacher call jitted, as a first call of its CLI compiles it."""
    cfg = Mast3rConfig(croco=CrocoConfig(**CROCO_KW), **MAST3R_KW)
    teacher = Mast3rTeacher(cfg)
    teacher.init_params(torch.Generator().manual_seed(seed))
    params = convert_mast3r({k: v.numpy() for k, v in teacher.model.state_dict().items()},
                            JMast3rConfig(croco=JCrocoConfig(**CROCO_KW), **MAST3R_KW))
    jteacher = JMast3rTeacher(JMast3rConfig(croco=JCrocoConfig(**CROCO_KW), **MAST3R_KW))
    jteacher.extract_features = jax.jit(jteacher.extract_features, static_argnames="dtype")
    return jteacher, params, teacher.eval()


def test_scene_from_mast3r_matches_gd3d():
    """One batched teacher call over all ordered pairs, on shared weights:
    the edges, the point, confidence and descriptor maps within 1e-4."""
    jteacher, params, teacher = tiny_teachers()
    images = (np.random.RandomState(0).rand(3, 32, 64, 3) * 2 - 1).astype(np.float32)
    want, wdi, wdj = J.scene_from_mast3r(jteacher, params, jnp.asarray(images),
                                         return_desc=True)
    got, di, dj = T.scene_from_mast3r(teacher, torch.from_numpy(images), return_desc=True)
    np.testing.assert_array_equal(got.edges, want.edges)
    assert got.hw == want.hw == (32, 64) and got.n_imgs == want.n_imgs == 3
    for g, w in ((got.pred_i, want.pred_i), (got.pred_j, want.pred_j), (got.conf_i, want.conf_i),
                 (got.conf_j, want.conf_j), (di, wdi), (dj, wdj)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
