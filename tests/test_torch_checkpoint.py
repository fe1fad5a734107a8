"""Gradient accumulation and checkpoints of the port against gd3d, on the
CPU.

- ClippedAdamW with grad_accum = 2 against gd3d's optax chain wrapped in
  optax.MultiSteps: four calls on the same numpy gradients (one leaf with
  no gradient, one call over the clip norm), the parameters after each
  call within rtol 1e-6 / atol 1e-8 (fp32 AdamW; lr 1e-3 so that an update
  is 1e5 times the tolerance), and exactly unchanged, with AdamW's step
  counts, after the calls in between;
- export_reference_layout equals gd3d's element by element, and
  import_reference_layout gives the same parameters in both packages;
- a Lightning-layout checkpoint written by the test loads the same in both
  packages (exact), and the port's own adapter file reads through gd3d's
  loader;
- the restart state restores mid-accumulation: continuing from it equals
  continuing without it, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gd3d.core import checkpoint as jckpt
from gd3d.core.config import StudentConfig as JStudentConfig
from gd3d.core.config import TrainConfig as JTrainConfig
from gd3d.distill import make_optimizer as jmake_optimizer
from gd3d.models.student import Student as JStudent
from gd3d.models.student import split_params as jsplit_params
from gd3d_torch.convert import student_state_dict
from gd3d_torch.core import checkpoint as ckpt
from gd3d_torch.core.config import StudentConfig, TrainConfig
from gd3d_torch.distill.train_state import make_optimizer
from gd3d_torch.models.student import Student, split_params

SHAPES = {"a": (4, 3), "b": (5,), "unused": (2, 2)}
STUDENT_KW = dict(embed_dim=32, depth=4, num_heads=2, patch_size=16, pretrain_img_size=32,
                  lora_start_block=2, use_adapters=True, adapter_bottleneck=8,
                  target_res=64, depth_head_hidden=16)


def _grads(rng, scale):
    return {k: (scale * rng.randn(*s)).astype(np.float32) for k, s in SHAPES.items()
            if k != "unused"}


def test_grad_accum_matches_optax_multisteps():
    rng = np.random.RandomState(0)
    init = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    kw = dict(lr=1e-3, grad_accum=2)
    tx = jmake_optimizer(JTrainConfig(**kw))
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = make_optimizer(TrainConfig(**kw), params.values())
    for call, scale in enumerate((0.1, 3.0, 0.5, 0.2)):  # call 1 is over the clip norm
        g = _grads(rng, scale)
        jg = {k: jnp.asarray(g.get(k, np.zeros(SHAPES[k], np.float32))) for k in SHAPES}
        upd, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        before = {k: p.detach().clone() for k, p in params.items()}
        steps_before = [int(s["step"]) for s in opt.adamw.state.values()] or [0]
        opt.zero_grad()
        for k, p in params.items():
            if k in g:
                p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-8, err_msg=f"call {call} {k}")
        if call % 2 == 0:  # between updates: nothing moves
            assert all(torch.equal(before[k], p) for k, p in params.items())
            assert ([int(s["step"]) for s in opt.adamw.state.values()] or [0]) == steps_before
        else:
            assert not torch.equal(before["a"], params["a"])
            assert all(int(s["step"]) == (call + 1) // 2 for s in opt.adamw.state.values())
        assert opt.calls == call + 1 and opt.mini_step == (call + 1) % 2


def test_restart_state_restores_mid_accumulation(tmp_path):
    rng = np.random.RandomState(1)
    init = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [_grads(rng, 1.0) for _ in range(5)]

    def run(calls, restore_from=None):
        params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
        opt = make_optimizer(TrainConfig(lr=1e-3, grad_accum=2), params.values())
        start = 0
        if restore_from is not None:
            start = ckpt.restore_train_state(restore_from, params, opt)
        for i in range(start, calls):
            opt.zero_grad()
            for k, v in grads[i].items():
                params[k].grad = torch.from_numpy(v)
            opt.step()
        return params, opt

    params, opt = run(3)  # mid-accumulation: one call folded in, not applied
    assert opt.mini_step == 1
    ckpt.save_train_state(str(tmp_path / "last"), params, opt, epoch=2)
    straight, _ = run(5)
    resumed, opt2 = run(5, restore_from=str(tmp_path / "last"))
    assert opt2.calls == 5
    for k in straight:
        assert torch.equal(straight[k], resumed[k]), k


def _students():
    jcfg = JStudentConfig(**STUDENT_KW)
    params = jax.tree_util.tree_map(
        np.array, JStudent(jcfg).init(jax.random.key(0), img_size=32))
    rng = np.random.RandomState(2)
    for name in ("lora_b_q", "lora_b_v"):
        k = params["vit"]["blocks_adapt"]["attn"][name]["kernel"]
        params["vit"]["blocks_adapt"]["attn"][name]["kernel"] = rng.randn(*k.shape).astype(
            np.float32)
    cfg = StudentConfig(**STUDENT_KW)
    st = Student(cfg)
    st.load_state_dict(student_state_dict(params, cfg))
    return jcfg, params, cfg, st


@pytest.mark.parametrize("use_adapters", [True, False])
def test_export_reference_layout_matches_gd3d(use_adapters):
    jcfg, params, cfg, st = _students()
    jcfg = dataclasses.replace(jcfg, use_adapters=use_adapters)
    cfg = dataclasses.replace(cfg, use_adapters=use_adapters)
    trainable, _ = split_params(st)
    want = jckpt.export_reference_layout(jsplit_params(params)[0], jcfg)
    got = ckpt.export_reference_layout(trainable, cfg)
    assert got.keys() == want.keys()
    assert any(k.startswith("adapter_") for k in got) == use_adapters
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_import_reference_layout_matches_gd3d():
    jcfg, params, cfg, st = _students()
    rng = np.random.RandomState(3)
    flat = {k: rng.randn(*v.shape).astype(np.float32)
            for k, v in jckpt.export_reference_layout(jsplit_params(params)[0], jcfg).items()}
    jnew = jckpt.import_reference_layout(jsplit_params(params)[0], flat, jcfg)
    trainable, _ = split_params(st)
    ckpt.import_reference_layout(trainable, flat, cfg)
    merged = jax.tree_util.tree_map(lambda a, b: b if a is None else a, jnew, params,
                                    is_leaf=lambda x: x is None)
    want = student_state_dict(merged, cfg)
    for name, p in trainable.items():
        assert torch.equal(p.detach(), want[name]), name


def test_lightning_checkpoint_loads_the_same_in_both(tmp_path):
    """A file in the reference's Lightning layout (w_a_/w_b_ at the top as
    trainable Parameters, adapter_%03d and depth_diff_head as state dicts,
    refine_conv under state_dict, and keys neither reads) flattens to the
    same dict in both packages; the port's own adapter file reads back
    through gd3d's loader to the port's export."""
    jcfg, params, cfg, st = _students()
    flat = jckpt.export_reference_layout(jsplit_params(params)[0], jcfg)
    lightning = {"epoch": 3, "global_step": 12, "state_dict": {"refine_conv": {}},
                 "depth_diff_head": {}, "optimizer_states": [{}]}
    for k, v in flat.items():
        t = torch.from_numpy(v + 0.5)
        if k.startswith(("w_a_", "w_b_")):
            lightning[k] = torch.nn.Parameter(t)
        elif k.startswith("adapter_"):
            block, leaf = k.split(".", 1)
            lightning.setdefault(block, {})[leaf] = t
        elif k.startswith("refine_conv."):
            lightning["state_dict"]["refine_conv"][k.split(".", 1)[1]] = t
        else:
            lightning["depth_diff_head"][k.split(".", 1)[1]] = t
    path = tmp_path / "ref.ckpt"
    torch.save(lightning, path)
    got, want = ckpt.load_reference_checkpoint(str(path)), jckpt.load_reference_checkpoint(
        str(path))
    assert got.keys() == want.keys() == flat.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]) and np.array_equal(got[k], flat[k] + 0.5), k

    trainable, _ = split_params(st)
    ckpt.restore_checkpoint(str(path), trainable, cfg)
    ckpt.save_checkpoint(str(tmp_path / "ckpt_epoch_0001"), trainable, cfg)
    back = jckpt.load_reference_checkpoint(str(tmp_path / "ckpt_epoch_0001"))
    assert back.keys() == flat.keys()
    for k in flat:
        assert np.array_equal(back[k], flat[k] + 0.5), k
