"""The port's CroCo pretraining step and CLI (gd3d_torch/distill/pretrain.py,
gd3d_torch/cli/pretrain.py) against gd3d's on the CPU, at --tiny; the
checks are shared with tests/test_torch_pretrain_mast3r_step.py (the
objectives sit in two files so that each compiles one gd3d step).

Both packages start from one init: the port CLI's own (flax's
initialisers from torch.Generator(--seed), `build_model`), written into
gd3d's tree by gd3d_torch.convert. gd3d's side is its jitted step
(gd3d/distill/pretrain.py) under the optax chain its CLI builds, one
compiled step per objective for the whole module, fed the batches gd3d's
own batch functions make.

Tolerances: losses and their details 1e-5 relative; after two AdamW steps
(warmup schedule) the parameters within 1e-5 of the largest parameter and
AdamW's moments within 1e-5 of the largest moment (fp32 sums in another
order). Not of each tensor's own largest value: a bias that starts at 0
holds only its two updates, and AdamW's eps of 1e-8 turns the fp32
rounding of a near-zero gradient (the key bias's is zero in exact
arithmetic) into a visible share of such an update; the learning rates within 1e-6 relative
(numpy's float32 cos against XLA's). metrics.jsonl holds values rounded to
5 digits, so its entries are held to 2e-5 absolute plus 1e-5 relative.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from gd3d.distill.pretrain import build_croco_pretrain_step as jcroco_step
from gd3d.distill.pretrain import build_mast3r_pretrain_step as jmast3r_step
from gd3d.models.croco import CrocoConfig as JCrocoConfig
from gd3d.models.croco_pretrain import CrocoPretrain as JCrocoPretrain
from gd3d.models.mast3r import Mast3r as JMast3r
from gd3d.models.mast3r import Mast3rConfig as JMast3rConfig
from gd3d_torch.cli import pretrain as P
from gd3d_torch.convert import croco_pretrain_params, mast3r_params, unflatten
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
LR, WARMUP, STEPS, BATCH, CORRES, IMG = 1e-3, 1, 2, 2, 16, 64


def tiny_args(objective, *extra):
    return P.parse_args(["--output", "unused", "--objective", objective, "--tiny", "--cpu",
                         "--batch", str(BATCH), "--corres", str(CORRES), "--lr", str(LR),
                         "--warmup", str(WARMUP), "--steps", str(STEPS), "--img", str(IMG),
                         *extra])


def rel(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max()
                 / max(np.abs(want.astype(np.float64)).max(), 1e-12))


def jax_tx():
    lr = optax.warmup_cosine_decay_schedule(init_value=0.0, peak_value=LR, warmup_steps=WARMUP,
                                            decay_steps=max(STEPS, WARMUP + 1))
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr)), lr


def gd3d_model(objective):
    c = JCrocoConfig(**P.TINY_CROCO)
    if objective == "croco":
        return JCrocoPretrain(c, mask_ratio=0.9)
    return JMast3r(JMast3rConfig(croco=c, local_feat_dim=6, dpt_feature_dim=32,
                                 dpt_last_dim=16))


def to_tree(model, objective):
    flat = (croco_pretrain_params if objective == "croco" else mast3r_params)(model.state_dict())
    return jax.tree_util.tree_map(jnp.asarray, unflatten(flat))


class Gd3dRun:
    """gd3d's jitted step from a port model's weights: one compile a
    module, run again from fresh states."""

    def __init__(self, objective):
        self.objective = objective
        self.model = gd3d_model(objective)
        self.tx, self.lr = jax_tx()
        if objective == "croco":
            self.step = jcroco_step(self.model, self.tx)
        else:
            self.step = jmast3r_step(self.model, self.tx,
                                     loss_kwargs={"matching_weight": 0.075})

    def run(self, torch_model, batches):
        params = to_tree(torch_model, self.objective)
        opt_state = self.tx.init(params)
        metrics = []
        for b in batches:
            params, opt_state, m = self.step(params, opt_state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        return params, opt_state, metrics


@pytest.fixture(scope="module")
def gd3d_croco():
    return Gd3dRun("croco")


def batches_for(objective, seed=0):
    """The CLI's batches for steps 0 .. STEPS-1 (seeds seed + s + 1)."""
    make = P.make_batch_fn(tiny_args(objective), 16)
    return [make(seed + s + 1) for s in range(STEPS)]


def _flat(state, objective):
    return (croco_pretrain_params if objective == "croco" else mast3r_params)(state)


def assert_close_to_max(got: dict, want: dict, what: str):
    """Every tensor within TOL of the largest value over all of them."""
    assert set(got) == set(want)
    top = max(float(np.abs(v).max()) for v in want.values())
    worst = max((float(np.abs(got[k].astype(np.float64) - want[k]).max()), k) for k in want)
    assert worst[0] <= TOL * top, (what, worst, top)


def assert_state_matches(model, opt, params, opt_state, objective):
    assert_close_to_max(_flat(model.state_dict(), objective),
                        {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()},
                        "params")
    adam = opt_state[1][0]
    assert int(adam.count) == opt.adamw.count
    for name, moments in (("mu", opt.adamw.mu), ("nu", opt.adamw.nu)):
        assert_close_to_max(_flat(moments, objective),
                            {"/".join(k): np.asarray(v)
                             for k, v in flatten_dict(getattr(adam, name)).items()}, name)


def check_two_adamw_steps(objective, run: Gd3dRun):
    """Two steps of the port's step builders against gd3d's: losses and
    details each step, then the parameters and AdamW's state."""
    args = tiny_args(objective)
    model = P.build_model(args, torch.device("cpu"))
    batches = batches_for(objective)
    jparams, jstate, jmetrics = run.run(model, batches)

    from gd3d_torch.distill.pretrain import (
        PretrainOptimizer,
        build_croco_pretrain_step,
        build_mast3r_pretrain_step,
    )
    from gd3d_torch.stereoflow import warmup_cosine_lr

    lr = lambda c: warmup_cosine_lr(c, LR, WARMUP, max(STEPS, WARMUP + 1))  # noqa: E731
    opt = PretrainOptimizer(model, lr, 1.0)
    step = (build_croco_pretrain_step(model, opt) if objective == "croco"
            else build_mast3r_pretrain_step(model, opt, {"matching_weight": 0.075}))
    for s, (b, jm) in enumerate(zip(batches, jmetrics)):
        m = step(P.to_device(b, torch.device("cpu")))
        assert set(m) == set(jm)
        for k in jm:
            assert abs(float(m[k]) - jm[k]) <= TOL * max(abs(jm[k]), 1e-6), (s, k, float(m[k]), jm[k])
        assert abs(lr(s) - float(run.lr(s))) <= 1e-6 * LR
    assert_state_matches(model, opt, jparams, jstate, objective)


def read_metrics(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def assert_records_match(records, jmetrics, lr_fn=None):
    assert len(records) == len(jmetrics)
    for s, (rec, jm) in enumerate(zip(records, jmetrics)):
        assert rec["step"] == s
        keys = set(rec) - {"step", "lr"}
        assert keys == set(jm)
        for k in keys:
            assert abs(rec[k] - jm[k]) <= 2e-5 + TOL * abs(jm[k]), (s, k, rec[k], jm[k])
        if lr_fn is not None:
            assert abs(rec["lr"] - float(lr_fn(s))) <= 1e-8 + 1e-6 * LR


def check_cli_and_resume(objective, run: Gd3dRun, tmp_path):
    """metrics.jsonl against gd3d's step values on the same init and
    batches; a run stopped at step 1 and resumed equals the straight run:
    its records, params_final.npz and AdamW's state."""
    base = ["--objective", objective, "--tiny", "--cpu", "--batch", str(BATCH),
            "--corres", str(CORRES), "--lr", str(LR), "--warmup", str(WARMUP), "--img", str(IMG)]
    if objective == "croco":
        base.append("--export-dust3r")
    straight = P.main(["--output", str(tmp_path / "a"), *base, "--steps", str(STEPS)])
    model0 = P.build_model(tiny_args(objective), torch.device("cpu"))
    _, _, jmetrics = run.run(model0, batches_for(objective))
    assert_records_match(read_metrics(tmp_path / "a" / "metrics.jsonl"), jmetrics, run.lr)

    b = str(tmp_path / "b")
    # one step, then the rest (the warmup schedule decays over
    # max(--steps, warmup + 1) = 2 steps in both runs)
    P.main(["--output", b, *base, "--steps", "1", "--ckpt-every", "1"])
    resumed = P.main(["--output", b, *base, "--steps", str(STEPS),
                      "--resume", str(tmp_path / "b" / "state_last.npz")])
    assert read_metrics(tmp_path / "b" / "metrics.jsonl") == read_metrics(tmp_path / "a" / "metrics.jsonl")
    with np.load(tmp_path / "a" / "params_final.npz") as za, \
            np.load(tmp_path / "b" / "params_final.npz") as zb:
        assert set(za.files) == set(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k])
    for k, v in straight["optimizer"].state_dict().items():
        torch.testing.assert_close(resumed["optimizer"].state_dict()[k], v, rtol=0, atol=0)


def test_croco_two_adamw_steps_match_gd3d(gd3d_croco):
    check_two_adamw_steps("croco", gd3d_croco)


def test_croco_cli_metrics_match_gd3d_and_resume_is_exact(gd3d_croco, tmp_path):
    """metrics.jsonl against gd3d's step values on the same init and
    batches; a run stopped at step 1 and resumed equals the straight run."""
    check_cli_and_resume("croco", gd3d_croco, tmp_path)
