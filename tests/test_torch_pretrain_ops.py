"""The port's pretraining criteria (gd3d_torch/ops/regr3d.py,
gd3d_torch/ops/matching_loss.py) against gd3d's on the CPU, on the same
seeded numpy inputs.

Tolerance: 1e-5 of the largest value of each output (fp32 sums and norms
in another order), for values and for gradients against jax.grad.
Medians, ranks, scores and masks are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gd3d.ops.matching_loss as JM
import gd3d.ops.regr3d as JR
import gd3d_torch.ops.matching_loss as TM
import gd3d_torch.ops.regr3d as TR
from gd3d_torch.models.croco_pretrain import masked_mse
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
B, H, W = 2, 6, 7


def rel(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max()
                 / max(np.abs(want.astype(np.float64)).max(), 1e-12))


def t(x):
    return torch.from_numpy(np.asarray(x))


def tree_t(d):
    return {k: t(v) for k, v in d.items()}


def rigid(rng):
    q, _ = np.linalg.qr(rng.randn(3, 3))
    q *= np.sign(np.linalg.det(q))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = q
    pose[:3, 3] = rng.randn(3)
    return pose


def scene(seed=0, valid_frac=0.7, metric=(True, False)):
    """gt1, gt2, pred1, pred2 as numpy dicts."""
    rng = np.random.RandomState(seed)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    gt1 = {"camera_pose": np.stack([rigid(rng) for _ in range(B)]),
           "pts3d": f32(rng.randn(B, H, W, 3) * 2 + [0, 0, 4]),
           "valid_mask": rng.rand(B, H, W) < valid_frac,
           "sky_mask": rng.rand(B, H, W) < 0.3,
           "is_metric_scale": np.asarray(metric, bool)}
    gt2 = {"camera_pose": np.stack([rigid(rng) for _ in range(B)]),
           "pts3d": f32(rng.randn(B, H, W, 3) * 2 + [0, 0, 4]),
           "valid_mask": rng.rand(B, H, W) < valid_frac,
           "sky_mask": rng.rand(B, H, W) < 0.3}
    pred1 = {"pts3d": f32(rng.randn(B, H, W, 3) + [0, 0, 3]),
             "conf": f32(1 + np.exp(rng.randn(B, H, W)))}
    pred2 = {"pts3d_in_other_view": f32(rng.randn(B, H, W, 3) + [0, 0, 3]),
             "conf": f32(1 + np.exp(rng.randn(B, H, W)))}
    return gt1, gt2, pred1, pred2


def both(fn_j, fn_t, *args, **kw):
    """fn_j on numpy args, fn_t on their tensors."""
    conv = lambda a: (tree_t(a) if isinstance(a, dict)  # noqa: E731
                      else t(a) if isinstance(a, np.ndarray) else a)
    return fn_j(*args, **kw), fn_t(*[conv(a) for a in args], **kw)


def assert_tree(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_tree(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree(g, w)
    elif want is None:
        assert got is None
    elif np.asarray(want).dtype == bool:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert rel(got, want) <= TOL


# ------------------------------------------------------------- regr3d
def test_geotrf_and_inv_pose():
    gt1, _, _, _ = scene()
    assert_tree(*reversed(both(JR.geotrf, TR.geotrf, gt1["camera_pose"], gt1["pts3d"])))
    assert_tree(*reversed(both(JR.inv_pose, TR.inv_pose, gt1["camera_pose"])))


@pytest.mark.parametrize("n_valid", [0, 1, 2, 5, 6, 42])
def test_masked_median_takes_the_lower_middle(n_valid):
    rng = np.random.RandomState(n_valid)
    x = rng.randn(3, 42).astype(np.float32)
    mask = np.zeros((3, 42), bool)
    for r in range(3):
        mask[r, rng.permutation(42)[:n_valid]] = True
    want = JR.masked_median(x, mask)
    got = TR.masked_median(t(x), t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if n_valid:  # torch.nanmedian's choice
        ref = torch.nanmedian(torch.where(t(mask), t(x), torch.nan), dim=-1).values
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("mode", ["avg_dis", "median_dis"])
@pytest.mark.parametrize("two", [True, False])
def test_normalize_pointcloud(mode, two):
    gt1, gt2, _, _ = scene(1)
    args = (gt1["pts3d"], gt2["pts3d"] if two else None, mode, gt1["valid_mask"],
            gt2["valid_mask"] if two else None)
    want, got = both(JR.normalize_pointcloud, TR.normalize_pointcloud, *args)
    assert_tree(got, want)


def test_normalize_pointcloud_rejects_unknown_modes():
    gt1, _, _, _ = scene()
    for mode in ("avg_foo", "max_dis"):
        with pytest.raises(ValueError):
            TR.normalize_pointcloud(t(gt1["pts3d"]), None, mode, t(gt1["valid_mask"]), None)


def test_joint_depth_and_center_scale():
    gt1, gt2, _, _ = scene(2)
    z1, z2 = gt1["pts3d"][..., 2], gt2["pts3d"][..., 2]
    m1, m2 = gt1["valid_mask"], gt2["valid_mask"]
    assert_tree(*reversed(both(JR.joint_pointcloud_depth, TR.joint_pointcloud_depth, z1, z2, m1, m2)))
    assert_tree(*reversed(both(JR.joint_pointcloud_center_scale, TR.joint_pointcloud_center_scale,
                               gt1["pts3d"], gt2["pts3d"], m1, m2)))


def test_get_pred_pts3d_routes():
    gt1, _, pred1, pred2 = scene(3)
    assert_tree(TR.get_pred_pts3d(tree_t(pred1), False), JR.get_pred_pts3d(pred1, False))
    assert_tree(TR.get_pred_pts3d(tree_t(pred2), True), JR.get_pred_pts3d(pred2, True))
    posed = {"pts3d": pred1["pts3d"], "camera_pose": gt1["camera_pose"]}
    assert_tree(TR.get_pred_pts3d(tree_t(posed), True), JR.get_pred_pts3d(posed, True))
    with pytest.raises(ValueError):
        TR.get_pred_pts3d(tree_t(pred2), False)


REGR_CASES = [
    dict(),
    dict(norm_mode="median_dis"),
    dict(norm_mode=None),
    dict(gt_scale=True),
    dict(shift_inv=True),
    dict(scale_inv=True),
    dict(shift_inv=True, scale_inv=True),
    dict(scale_inv=True, gt_scale=True),
    dict(dist_clip=5.0),
]


@pytest.mark.parametrize("kw", REGR_CASES, ids=lambda kw: ",".join(kw) or "default")
def test_regr3d_criteria(kw):
    gt1, gt2, pred1, pred2 = scene(4)
    for fj, ft in ((JR.regr3d_pointmaps, TR.regr3d_pointmaps), (JR.regr3d_loss, TR.regr3d_loss)):
        want, got = both(fj, ft, gt1, gt2, pred1, pred2, **kw)
        assert_tree(got, want)
    want, got = both(JR.conf_regr3d_loss, TR.conf_regr3d_loss, gt1, gt2, pred1, pred2,
                     alpha=0.2, **kw)
    assert_tree(got, want)


@pytest.mark.parametrize("fit_mode", ["avg", "median", "weiszfeld", "avg_stop_grad",
                                      "median_stop_grad", "weiszfeld_stop_grad"])
@pytest.mark.parametrize("two", [True, False])
def test_find_opt_scaling(fit_mode, two):
    gt1, gt2, pred1, pred2 = scene(5)
    args = (gt1["pts3d"], gt2["pts3d"] if two else None, pred1["pts3d"],
            pred2["pts3d_in_other_view"] if two else None)
    kw = dict(fit_mode=fit_mode, valid1=gt1["valid_mask"],
              valid2=gt2["valid_mask"] if two else None)
    want = JR.find_opt_scaling(*args, **kw)
    got = TR.find_opt_scaling(*[None if a is None else t(a) for a in args], fit_mode=fit_mode,
                              valid1=t(kw["valid1"]),
                              valid2=None if kw["valid2"] is None else t(kw["valid2"]))
    assert_tree(got, want)
    with pytest.raises(ValueError):
        TR.find_opt_scaling(t(gt1["pts3d"]), None, t(pred1["pts3d"]), fit_mode="nope")


def test_apply_log_to_norm():
    gt1, _, _, _ = scene(6)
    assert_tree(TR.apply_log_to_norm(t(gt1["pts3d"])), JR.apply_log_to_norm(gt1["pts3d"]))


MAST3R_CASES = [
    dict(),
    dict(norm_mode="avg_dis"),
    dict(norm_mode="?median_dis"),
    dict(max_metric_scale=3.0),
    dict(gt_scale=True),
    dict(sky_loss_value=0.0),
    dict(loss_in_log="before"),
    dict(loss_in_log=True),
    dict(dist_clip=6.0),
]


@pytest.mark.parametrize("kw", MAST3R_CASES, ids=lambda kw: ",".join(kw) or "default")
def test_mast3r_regr3d(kw):
    gt1, gt2, pred1, pred2 = scene(7)
    want, got = both(JR.mast3r_regr3d_maps, TR.mast3r_regr3d_maps, gt1, gt2, pred1, pred2, **kw)
    assert_tree(got, want)
    want, got = both(JR.mast3r_conf_regr3d_loss, TR.mast3r_conf_regr3d_loss, gt1, gt2,
                     pred1, pred2, **kw)
    assert_tree(got, want)


def test_zero_valid_pixels_give_zero():
    gt1, gt2, pred1, pred2 = scene(8, valid_frac=0.0)
    gt1["sky_mask"][:] = False
    gt2["sky_mask"][:] = False
    for fj, ft in ((JR.conf_regr3d_loss, TR.conf_regr3d_loss),
                   (JR.mast3r_conf_regr3d_loss, TR.mast3r_conf_regr3d_loss)):
        want, got = both(fj, ft, gt1, gt2, pred1, pred2)
        assert float(got[0]) == float(want[0]) == 0.0
        assert_tree(got, want)


def grads_match(loss_j, loss_t, inputs):
    """jax.grad and autograd of a scalar loss wrt every array of `inputs`."""
    gj = jax.grad(lambda xs: loss_j(xs))({k: jnp.asarray(v) for k, v in inputs.items()})
    xs = {k: t(v).clone().requires_grad_(True) for k, v in inputs.items()}
    loss_t(xs).backward()
    for k in inputs:
        assert rel(xs[k].grad, gj[k]) <= TOL, k


@pytest.mark.parametrize("norm_mode", ["?avg_dis", "?median_dis"])
def test_mast3r_conf_regr3d_gradient(norm_mode):
    gt1, gt2, pred1, pred2 = scene(9)
    inputs = {"p1": pred1["pts3d"], "p2": pred2["pts3d_in_other_view"],
              "c1": pred1["conf"], "c2": pred2["conf"]}

    def call(mod, xs, conv):
        p1 = {"pts3d": xs["p1"], "conf": xs["c1"]}
        p2 = {"pts3d_in_other_view": xs["p2"], "conf": xs["c2"]}
        return mod.mast3r_conf_regr3d_loss(conv(gt1), conv(gt2), p1, p2, norm_mode=norm_mode)[0]

    grads_match(lambda xs: call(JR, xs, lambda d: d), lambda xs: call(TR, xs, tree_t), inputs)


def test_conf_regr3d_gradient_shift_scale_inv():
    gt1, gt2, pred1, pred2 = scene(10)
    inputs = {"p1": pred1["pts3d"], "p2": pred2["pts3d_in_other_view"]}

    def call(mod, xs, conv):
        p1 = {"pts3d": xs["p1"], "conf": conv(pred1)["conf"]}
        p2 = {"pts3d_in_other_view": xs["p2"], "conf": conv(pred2)["conf"]}
        return mod.conf_regr3d_loss(conv(gt1), conv(gt2), p1, p2, shift_inv=True,
                                    scale_inv=True)[0]

    grads_match(lambda xs: call(JR, xs, lambda d: d), lambda xs: call(TR, xs, tree_t), inputs)


# ------------------------------------------------------- matching_loss
def descs(seed, n=12, m=12, d=8):
    rng = np.random.RandomState(seed)
    d1 = rng.randn(B, n, d).astype(np.float32)
    d2 = (d1[:, :min(n, m)].repeat(1, 0) if m <= n else
          np.concatenate([d1, rng.randn(B, m - n, d)], 1)).astype(np.float32)
    d2 = (d2 + 0.5 * rng.randn(*d2.shape)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    valid = rng.rand(B, n) < 0.8
    return d1, d2, valid


@pytest.mark.parametrize("euc", [False, True])
def test_get_similarities(euc):
    d1, d2, _ = descs(0, m=15)
    assert_tree(TM.get_similarities(t(d1), t(d2), euc), JM.get_similarities(d1, d2, euc))


@pytest.mark.parametrize("mode", ["all", "proper", "dual"])
@pytest.mark.parametrize("euc", [False, True])
@pytest.mark.parametrize("m", [12, 15])
def test_infonce_loss(mode, euc, m):
    d1, d2, valid = descs(1, m=m)
    for v in (valid, None):
        want = JM.infonce_loss(d1, d2, v, mode=mode, euc=euc)
        got = TM.infonce_loss(t(d1), t(d2), None if v is None else t(v), mode=mode, euc=euc)
        assert_tree(got, want)
    with pytest.raises(ValueError):
        TM.infonce_loss(t(d1), t(d2), mode="nope")


def test_ap_scores_are_reciprocal_ranks():
    rng = np.random.RandomState(2)
    scores = rng.randn(B, 9, 13).astype(np.float32)
    scores[0, 3, :] = 0.25  # ties keep the sorted order
    want = JM.ap_scores(scores)
    got = TM.ap_scores(t(scores))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_matching_descs():
    rng = np.random.RandomState(3)
    m1 = rng.randn(B, H, W, 5).astype(np.float32)
    m2 = rng.randn(B, H, W, 5).astype(np.float32)
    c1 = np.stack([rng.randint(0, W, (B, 11)), rng.randint(0, H, (B, 11))], -1)
    c2 = np.stack([rng.randint(0, W, (B, 11)), rng.randint(0, H, (B, 11))], -1)
    want = JM.gather_matching_descs(m1, m2, c1, c2)
    got = TM.gather_matching_descs(t(m1), t(m2), t(c1), t(c2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("blocksize", [4, 12, 16])
@pytest.mark.parametrize("mode", ["all", "proper"])
def test_blockwise_infonce_with_a_fed_permutation(blocksize, mode):
    d1, d2, valid = descs(4)
    perm = np.stack([np.random.RandomState(s).permutation(12) for s in range(B)])
    want = JM.blockwise_infonce(d1, d2, valid, perm, blocksize=blocksize, mode=mode)
    got = TM.blockwise_infonce(t(d1), t(d2), t(valid), t(perm), blocksize=blocksize, mode=mode)
    assert_tree(got, want)
    with pytest.raises(ValueError):
        TM.blockwise_infonce(t(d1), t(d2), t(valid), blocksize=5)


def matching_inputs(seed, n=10, d=6):
    rng = np.random.RandomState(seed)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731

    def dmap():
        x = rng.randn(B, H, W, d)
        return f32(x / np.linalg.norm(x, axis=-1, keepdims=True))

    corres = lambda: np.stack([rng.randint(0, W, (B, n)), rng.randint(0, H, (B, n))], -1)  # noqa: E731
    gt1 = {"corres": corres(), "valid_corres": rng.rand(B, n) < 0.7}
    gt2 = {"corres": corres()}
    pred1 = {"desc": dmap(), "desc_conf": f32(np.exp(rng.randn(B, H, W))),
             "pts3d": f32(rng.randn(B, H, W, 3)), "conf": f32(1 + np.exp(rng.randn(B, H, W)))}
    pred2 = {"desc": dmap(), "desc_conf": f32(np.exp(rng.randn(B, H, W))),
             "pts3d_in_other_view": f32(rng.randn(B, H, W, 3)),
             "conf": f32(1 + np.exp(rng.randn(B, H, W)))}
    return gt1, gt2, pred1, pred2


@pytest.mark.parametrize("confmode", ["prod", "mean"])
@pytest.mark.parametrize("mode", ["all", "proper", "dual"])
@pytest.mark.parametrize("quantile", [0.0, 0.5, 0.9])
def test_conf_matching_loss(confmode, mode, quantile):
    gt1, gt2, pred1, pred2 = matching_inputs(5)
    want, got = both(JM.conf_matching_loss, TM.conf_matching_loss, gt1, gt2, pred1, pred2,
                     alpha=10.0, confmode=confmode, mode=mode,
                     neg_conf_loss_quantile=quantile)
    assert_tree(got, want)


def test_conf_matching_loss_on_points_and_bad_modes():
    gt1, gt2, pred1, pred2 = matching_inputs(6)
    want, got = both(JM.conf_matching_loss, TM.conf_matching_loss, gt1, gt2, pred1, pred2,
                     use_pts3d=True)
    assert_tree(got, want)
    with pytest.raises(ValueError):
        TM.conf_matching_loss(tree_t(gt1), tree_t(gt2), tree_t(pred1), tree_t(pred2),
                              confmode="max")


def test_conf_matching_loss_gradient():
    gt1, gt2, pred1, pred2 = matching_inputs(7)
    inputs = {"d1": pred1["desc"], "d2": pred2["desc"], "c1": pred1["desc_conf"],
              "c2": pred2["desc_conf"]}

    def call(mod, xs, conv):
        p1 = {"desc": xs["d1"], "desc_conf": xs["c1"]}
        p2 = {"desc": xs["d2"], "desc_conf": xs["c2"]}
        return mod.conf_matching_loss(conv(gt1), conv(gt2), p1, p2, alpha=10.0, confmode="mean",
                                      mode="proper", neg_conf_loss_quantile=0.5)[0]

    grads_match(lambda xs: call(JM, xs, lambda d: d), lambda xs: call(TM, xs, tree_t), inputs)


def test_data_parallel_shares_sum_to_the_whole_batch():
    """Each half's share (its sums over the whole batch's counts) adds up
    to the one-batch loss and details, as the ranks' metrics do: the
    MASt3R regression and matching terms and CroCo's masked MSE."""
    gt1, gt2, pred1, pred2 = scene(11)
    g1, g2, p1, p2 = (tree_t(d) for d in (gt1, gt2, pred1, pred2))
    whole = TR.mast3r_conf_regr3d_loss(g1, g2, p1, p2)
    mg1, mg2, mp1, mp2 = (tree_t(d) for d in matching_inputs(12))
    whole_m = TM.conf_matching_loss(mg1, mg2, mp1, mp2, confmode="mean")

    def half(d, i):
        return {k: v[i:i + 1] for k, v in d.items()}

    # the whole batch's counts, recorded in call order, stand in for the
    # ranks' all-reduce
    for d_whole, fn, args in (
            (whole, TR.mast3r_conf_regr3d_loss, (g1, g2, p1, p2)),
            (whole_m, TM.conf_matching_loss, (mg1, mg2, mp1, mp2))):
        totals = []

        def record(n):
            totals.append(n)
            return n

        kw = {} if fn is TR.mast3r_conf_regr3d_loss else {"confmode": "mean"}
        fn(*args, count=record, **kw)
        shares = []
        for i in range(B):
            it = iter(list(totals))
            local = fn(*(half(a, i) for a in args), count=lambda n: next(it), **kw)
            shares.append(local)
        total = shares[0][0] + shares[1][0]
        assert abs(float(total) - float(d_whole[0])) <= TOL * abs(float(d_whole[0]))
        for k in d_whole[1]:
            s = float(shares[0][1][k] + shares[1][1][k])
            assert abs(s - float(d_whole[1][k])) <= TOL * max(abs(float(d_whole[1][k])), 1e-6), k
    # CroCo's masked MSE: each half's sum over the whole batch's masked count
    rng = np.random.RandomState(13)
    pred, target = (t(rng.randn(B, 9, 12).astype(np.float32)) for _ in range(2))
    mask = t(rng.rand(B, 9) < 0.6)
    n = mask.sum()
    whole_mse = masked_mse(pred, mask, target)
    halves = [masked_mse(pred[i:i + 1], mask[i:i + 1], target[i:i + 1], count=lambda _: n)
              for i in range(B)]
    assert abs(float(sum(halves)) - float(whole_mse)) <= TOL * float(whole_mse)
