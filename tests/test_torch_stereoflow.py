"""The port's CroCo-Stereo / CroCo-Flow runtime and model
(gd3d_torch/stereoflow.py, gd3d_torch/models/stereoflow.py) against gd3d's
on the CPU, on the same numpy inputs.

Tolerances:
- criteria, per-batch metrics, tile weights: 1e-6 of the largest value
  (fp32 sums in another order); their gradients 1e-6.
- dataset metrics: equal (both are the same float64 numpy).
- resize_bicubic_torch: F.interpolate against gd3d's A = -0.75 matrices,
  1e-5 of the largest value (fp32 sums in another order).
- tiled_pred on a pixelwise toy model: 1e-5; tile batches of any size
  give the same bits as one batch of all tiles.
- the tiny model's forward on shared weights (gd3d's convert_stereoflow of
  the port's init, and the port's converters back and forth, equal
  arrays): 1e-4 of the largest value, as tests/test_torch_models.py.
- two AdamW steps against gd3d's jitted step (optax): losses 1e-5, the
  parameters after them 1e-4 of each tensor's largest value, the optimizer
  state (moments and count) likewise; the learning rates within 1e-6 of
  optax's (numpy's float32 cos against XLA's: an ulp or two).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

import gd3d.stereoflow as J
import gd3d_torch.stereoflow as T
from gd3d.models.croco import CrocoConfig as JCrocoConfig
from gd3d.models.stereoflow import StereoFlow as JStereoFlow
from gd3d.models.stereoflow import StereoFlowConfig as JStereoFlowConfig
from gd3d.models.stereoflow import convert_stereoflow as jconvert_stereoflow
from gd3d_torch.convert import stereoflow_params, stereoflow_state_dict, unflatten
from gd3d_torch.models.croco import CrocoConfig
from gd3d_torch.models.stereoflow import StereoFlow, StereoFlowConfig, convert_stereoflow
from gd3d_torch.models.vit import init_params_

FN_TOL = 1e-6
RESIZE_TOL = 1e-5
MODEL_TOL = 1e-4
# numpy's float32 cos against XLA's: an ulp or two of the learning rate
LR_TOL = 1e-6
CROCO_KW = dict(patch_size=16, enc_embed_dim=32, enc_depth=2, enc_num_heads=2,
                dec_embed_dim=16, dec_depth=2, dec_num_heads=2)
SF_KW = dict(hooks=(0, 1, 2, 3), dpt_layer_dims=(8, 16, 24, 32), dpt_feature_dim=16,
             dpt_last_dim=8)


def rel_err(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max()
                 / max(np.abs(want.astype(np.float64)).max(), 1e-12))


def pred_gt(task, seed=0, B=2, H=12, W=10, inval=0.3):
    rng = np.random.RandomState(seed)
    C = 1 if task == "stereo" else 2
    gt = (rng.randn(B, H, W, C) * 4).astype(np.float32)
    gt[rng.rand(B, H, W) < inval] = np.inf
    pred = (gt + rng.randn(B, H, W, C).astype(np.float32) * 2)
    pred = np.where(np.isfinite(pred), pred, rng.randn(B, H, W, C)).astype(np.float32)
    conf = rng.randn(B, H, W).astype(np.float32)
    return pred, gt, conf


@pytest.mark.parametrize("task", ["stereo", "flow"])
def test_criteria_and_metrics_match_gd3d(task):
    pred, gt, conf = pred_gt(task)
    for name, crit in T.CRITERIA.items():
        jcrit = J.CRITERIA[name]
        assert crit.with_conf == jcrit.with_conf
        args = (pred, gt, conf) if crit.with_conf else (pred, gt)
        p = torch.from_numpy(pred).requires_grad_(True)
        c = torch.from_numpy(conf).requires_grad_(True)
        got = crit.fn(p, torch.from_numpy(gt), c) if crit.with_conf else crit.fn(
            p, torch.from_numpy(gt))
        want = jcrit.fn(*map(jnp.asarray, args))
        assert rel_err(got, want) <= FN_TOL, name
        got.backward()
        argnums = (0, 2) if crit.with_conf else (0,)
        jg = jax.grad(lambda *a: jcrit.fn(*a), argnums=argnums)(*map(jnp.asarray, args))
        assert rel_err(p.grad, jg[0]) <= FN_TOL, name
        if crit.with_conf:
            assert rel_err(c.grad, jg[1]) <= FN_TOL, name
    assert rel_err(T.l1_loss(torch.from_numpy(pred), torch.from_numpy(gt), max_gtnorm=3.0),
                   J.l1_loss(jnp.asarray(pred), jnp.asarray(gt), max_gtnorm=3.0)) <= FN_TOL
    metrics = T.stereo_metrics if task == "stereo" else T.flow_metrics
    jmetrics = J.stereo_metrics if task == "stereo" else J.flow_metrics
    got = metrics(torch.from_numpy(pred), torch.from_numpy(gt))
    want = jmetrics(jnp.asarray(pred), jnp.asarray(gt))
    assert sorted(got) == sorted(want)
    for k in want:
        assert rel_err(got[k], want[k]) <= FN_TOL, k
    for mode in ("conf_expsigmoid_10_5", "conf_expsigmoid_15_3", "conf_expbeta3"):
        assert rel_err(T.tile_conf_weight(torch.from_numpy(conf), mode),
                       J.tile_conf_weight(jnp.asarray(conf), mode)) <= FN_TOL


@pytest.mark.parametrize("task,spring", [("stereo", False), ("flow", False), ("stereo", True),
                                         ("flow", True)])
def test_dataset_metrics_match_gd3d(task, spring):
    agg = (T.StereoDatasetMetrics if task == "stereo" else T.FlowDatasetMetrics)()
    jagg = (J.StereoDatasetMetrics if task == "stereo" else J.FlowDatasetMetrics)()
    for seed in range(3):
        pred, gt, _ = pred_gt(task, seed, H=8, W=6)
        if spring:
            gt = pred_gt(task, seed + 10, H=16, W=12)[1] * 12
        agg.add_batch(torch.from_numpy(pred), gt)
        jagg.add_batch(pred, gt)
    assert agg.get_results() == jagg.get_results()


def test_bicubic_resize_matches_gd3d():
    x = np.random.RandomState(2).randn(2, 13, 17, 2).astype(np.float32)
    for hw in ((26, 40), (7, 9), (13, 30), (20, 17)):
        got = T.resize_bicubic_torch(torch.from_numpy(x), hw)
        assert rel_err(got, J.resize_bicubic_torch(jnp.asarray(x), hw)) <= RESIZE_TOL
        got = T.resize_stereo_or_flow(torch.from_numpy(x), hw)
        assert rel_err(got, J.resize_stereo_or_flow(jnp.asarray(x), hw)) <= RESIZE_TOL
    for total, window, overlap in ((100, 32, 0.5), (70, 70, 0.7), (375, 352, 0.7),
                                   (1242, 704, 0.7)):
        np.testing.assert_array_equal(T.overlapping_starts(total, window, overlap),
                                      J.overlapping_starts(total, window, overlap))


def toy(lib, C):
    """A pixelwise model in both packages: pred and conf from the inputs."""
    def apply(t1, t2):
        s = t1[..., :C] * 1.5 - t2[..., 1:C + 1] * 0.5
        return s, t1[..., 2] - t2[..., 0]
    return apply


@pytest.mark.parametrize("task,hw,conf_mode", [
    ("stereo", (40, 70), "conf_expsigmoid_15_3"), ("flow", (30, 44), "conf_expsigmoid_10_5"),
    ("stereo", (30, 40), "conf_expbeta3")])
def test_tiled_pred_matches_gd3d(task, hw, conf_mode):
    """Including the up-scale path ((30, 40) and (30, 44) are below the crop)
    and the tiled loss against ground truth, with invalid (+inf) pixels
    where no up-scale resizes it: gd3d's resize is a product with dense
    interpolation matrices, so one inf turns the whole resized map to nan,
    where F.interpolate (and the reference's engine) keeps it to its taps."""
    C = 1 if task == "stereo" else 2
    rng = np.random.RandomState(4)
    img1 = rng.randn(2, *hw, 3).astype(np.float32)
    img2 = rng.randn(2, *hw, 3).astype(np.float32)
    gt = pred_gt(task, 5, B=2, H=hw[0], W=hw[1], inval=0.0 if hw[0] < 32 else 0.3)[1]
    crit_name = J.DEFAULT_CRITERION[task]
    kw = dict(crop=(32, 48), overlap=0.5, conf_mode=conf_mode)
    want = J.tiled_pred(toy(jnp, C), jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(gt),
                        criterion=J.CRITERIA[crit_name], **kw)
    outs = [T.tiled_pred(toy(torch, C), torch.from_numpy(img1), torch.from_numpy(img2),
                         torch.from_numpy(gt), criterion=T.CRITERIA[crit_name],
                         tile_batch=tb, **kw) for tb in (None, 2, 5)]
    for g, w in zip(outs[0], want):
        assert rel_err(g, w) <= RESIZE_TOL
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def tiny_models(task, with_conf=True):
    """The tiny model in both packages on one seeded port init: gd3d's tree
    from gd3d's own converter of the port's state dict."""
    cfg = StereoFlowConfig(croco=CrocoConfig(**CROCO_KW), task=task, with_conf=with_conf,
                           **SF_KW)
    jcfg = JStereoFlowConfig(croco=JCrocoConfig(**CROCO_KW), task=task, with_conf=with_conf,
                             **SF_KW)
    model = StereoFlow(cfg)
    init_params_(model, torch.Generator().manual_seed(3))
    params = jconvert_stereoflow({k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    return model, JStereoFlow(jcfg), jax.tree_util.tree_map(np.asarray, params), cfg


@pytest.mark.parametrize("task", ["stereo", "flow"])
def test_tiny_model_forward_and_converters_match_gd3d(task):
    model, jmodel, params, cfg = tiny_models(task)
    flat = {"/".join(k): v for k, v in flatten_dict(params).items()}
    back = stereoflow_params(model.state_dict())
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    sd = stereoflow_state_dict(unflatten(flat), cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    # an upstream state dict carries refinenet4's dead resConfUnit1
    upstream = dict(model.state_dict())
    upstream["head.dpt.scratch.refinenet4.resConfUnit1.conv1.weight"] = torch.zeros(1)
    assert sorted(convert_stereoflow(upstream, cfg)) == sorted(model.state_dict())
    rng = np.random.RandomState(6)
    x1, x2 = (rng.randn(2, 32, 48, 3).astype(np.float32) for _ in range(2))
    pred, conf = model(torch.from_numpy(x1), torch.from_numpy(x2))
    jpred, jconf = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x1), jnp.asarray(x2))
    assert pred.shape == (2, 32, 48, cfg.task_channels) and conf.shape == (2, 32, 48)
    assert rel_err(pred, jpred) <= MODEL_TOL and rel_err(conf, jconf) <= MODEL_TOL
    assert cfg.resolved_hooks == (0, 1, 2, 3)
    assert StereoFlowConfig().resolved_hooks == (23, 27, 31, 35)
    assert StereoFlowConfig().hook_dims == (1024, 768, 768, 768)


def test_warmup_cosine_lr_matches_optax():
    for lr, total, warmup in ((3e-5, 100, 10), (2e-5, 3, 1), (1e-4, 7, 6)):
        sched = optax.warmup_cosine_decay_schedule(0.0, lr, max(warmup, 1),
                                                   max(total, warmup + 1))
        for count in range(total + 3):
            want = float(np.asarray(sched(jnp.int32(count))))
            got = T.warmup_cosine_lr(count, lr, max(warmup, 1), max(total, warmup + 1))
            assert abs(got - want) <= LR_TOL * abs(want), (lr, total, warmup, count)


def test_two_train_steps_match_gd3d():
    """Two AdamW steps of the tiny stereo model from shared weights on the
    same batches, with every trained tensor's gradient nonzero (the path
    through FlashAttention and RoPE2DQK's backward)."""
    model, jmodel, params, cfg = tiny_models("stereo")
    crit = "LaplacianLossBounded2()"
    opt = T.make_stereoflow_optimizer(model, 3e-5, 2, 1)
    step = T.build_stereoflow_train_step(model, T.CRITERIA[crit], opt)
    tx = J.make_stereoflow_optimizer(3e-5, 2, 1)
    jstate = tx.init(params)
    jstep = J.build_stereoflow_train_step(jmodel, J.CRITERIA[crit], tx)
    rng = np.random.RandomState(7)
    jparams = params
    for s in range(2):
        x1, x2 = (rng.randn(2, 32, 48, 3).astype(np.float32) for _ in range(2))
        gt = pred_gt("stereo", 8 + s, B=2, H=32, W=48)[1]
        loss = step(*(torch.from_numpy(a) for a in (x1, x2, gt)))
        jparams, jstate, jloss = jstep(jparams, jstate, *map(jnp.asarray, (x1, x2, gt)))
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        if s == 0:
            dead = [k for k, p in opt.params.items() if not bool(p.grad.abs().sum() > 0)]
            assert not dead, dead
    want = {"/".join(k): np.asarray(v) for k, v in flatten_dict(jparams).items()}
    got = stereoflow_params(model.state_dict())
    for k in want:
        assert rel_err(got[k], want[k]) <= MODEL_TOL, k
    adam = jstate[0]
    assert opt.count == int(adam.count) == 2
    mu = stereoflow_params(opt.mu)
    nu = stereoflow_params(opt.nu)
    for k, v in flatten_dict(jax.tree_util.tree_map(np.asarray, adam.mu)).items():
        assert rel_err(mu["/".join(k)], v) <= MODEL_TOL, k
    for k, v in flatten_dict(jax.tree_util.tree_map(np.asarray, adam.nu)).items():
        assert rel_err(nu["/".join(k)], v) <= MODEL_TOL, k
