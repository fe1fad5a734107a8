"""The student's remat and bf16_stream options (StudentConfig) against the
plain student and against gd3d, on the CPU at the tiny configs of
tests/test_torch_step.py, on shared weights (one seeded gd3d init with
non-zero LoRA B, converted).

- remat against no remat in the port: one MASt3R step's losses must be
  equal and every trainable gradient within 1e-6 (remat recomputes the same
  block in the same order; the backward's sums may group otherwise).
- remat in the port against remat in gd3d: two MASt3R steps at the
  composed step lock's tolerance (tests/test_torch_step.py): losses rtol
  1e-4, trainable parameters atol 1e-6 after the second step.
- bf16_stream (compute_dtype bfloat16): the student's step surfaces
  (matching descriptors, intermediate keypoint features, cost features)
  against gd3d's bf16_stream student. Bound: max |diff| <= 5e-2 * max(1,
  max |gd3d|) per output, the bf16 drift bound of the teacher locks: both
  round every matmul's operands and the residual stream to bf16 (2^-8
  relative), in other places, over 8 blocks; and the stream must be bf16
  where gd3d's is (the tapped intermediates).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gd3d.core.config import DistillConfig as JDistillConfig
from gd3d.core.config import KeypointConfig as JKeypointConfig
from gd3d.core.config import StudentConfig as JStudentConfig
from gd3d.distill import make_optimizer as jmake_optimizer
from gd3d.distill.mast3r_step import build_mast3r_train_step as jbuild_step
from gd3d.distill.train_state import init_state
from gd3d.models.student import Student as JStudent
from gd3d.models.student import merge_params
from gd3d.models.student import split_params as jsplit_params
from gd3d_torch.convert import student_state_dict
from gd3d_torch.core.config import DistillConfig, KeypointConfig, StudentConfig
from gd3d_torch.distill.mast3r_step import build_mast3r_train_step, mast3r_distill_loss
from gd3d_torch.distill.train_state import make_optimizer
from gd3d_torch.models.student import Student, split_params
from test_torch_mast3r_bf16 import shared  # noqa: F401  (the fixture)
from test_torch_step import LOSSES, STUDENT_KW, _np
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def student_params():
    params = _np(JStudent(JStudentConfig(**STUDENT_KW)).init(jax.random.key(0), img_size=32))
    rng = np.random.RandomState(1)
    for name in ("lora_b_q", "lora_b_v"):  # non-zero LoRA B: the LoRA path matters
        k = params["vit"]["blocks_adapt"]["attn"][name]["kernel"]
        params["vit"]["blocks_adapt"]["attn"][name]["kernel"] = (
            0.1 * rng.randn(*k.shape)).astype(np.float32)
    return params


def _cfg(**student):
    return DistillConfig(teacher="mast3r", dataset="scannetpp",
                         student=StudentConfig(**{**STUDENT_KW, **student}),
                         keypoints=KeypointConfig(nn_subsample=16))


def _port_student(params, cfg):
    st = Student(cfg.student)
    st.load_state_dict(student_state_dict(params, StudentConfig(**STUDENT_KW)))
    return st


def test_remat_matches_the_plain_step(shared, student_params):
    _, _, te, batch = shared
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for remat in (False, True):
        cfg = _cfg(remat=remat)
        st = _port_student(student_params, cfg)
        tr, _ = split_params(st)
        loss, metrics = mast3r_distill_loss(st, te, cfg, tbatch, 1.0, has_depth=False)
        loss.backward()
        out[remat] = ({k: float(v.detach()) for k, v in metrics.items()},
                      {k: p.grad.clone() for k, p in tr.items() if p.grad is not None})
    (m0, g0), (m1, g1) = out[False], out[True]
    assert m0 == m1
    assert g0.keys() == g1.keys() and len(g0) > 0
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_remat_step_matches_gd3d(shared, student_params):
    jte, jtp, te, batch = shared
    jcfg = JDistillConfig(teacher="mast3r", dataset="scannetpp",
                          student=JStudentConfig(**STUDENT_KW, remat=True),
                          keypoints=JKeypointConfig(nn_subsample=16))
    jst = JStudent(jcfg.student)
    trainable, frozen = jsplit_params(jax.tree_util.tree_map(jnp.asarray, student_params))
    tx = jmake_optimizer(jcfg.train)
    state = init_state(tx, trainable)
    jstep = jax.jit(jbuild_step(jst, jte, jcfg, tx, has_depth=False))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for _ in range(2):
        state, m = jstep(state, frozen, jtp, jbatch, 1.0)
        want.append({k: float(v) for k, v in m.items()})
    want_params = student_state_dict(_np(merge_params(state.trainable, frozen)),
                                     StudentConfig(**STUDENT_KW))

    cfg = _cfg(remat=True)
    st = _port_student(student_params, cfg)
    tr, _ = split_params(st)
    step = build_mast3r_train_step(st, te, cfg, make_optimizer(cfg.train, tr.values()),
                                   has_depth=False, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = [{k: float(v) for k, v in step(tbatch, 1.0).items()} for _ in range(2)]
    for g, w in zip(got, want):
        assert g["num_kps"] == w["num_kps"] > 0
        for k in LOSSES:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7, err_msg=k)
    for name, p in tr.items():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_bf16_stream_student_matches_gd3d(student_params):
    kw = dict(STUDENT_KW, compute_dtype="bfloat16", bf16_stream=True)
    jst = JStudent(JStudentConfig(**kw))
    jparams = jax.tree_util.tree_map(jnp.asarray, student_params)
    rng = np.random.RandomState(3)
    rgbs = rng.rand(2, 64, 64, 3).astype(np.float32)
    pts = (rng.rand(2, 12, 2) * 60 + 2).astype(np.float32)
    jdesc, jkp = jst.get_feature_and_intermediates(jparams, jnp.asarray(rgbs), jnp.asarray(pts))
    jcost = jst.get_feature_cost(jparams, jnp.asarray(rgbs), normalize=False)
    jinter = jst.forward_tokens(jparams, jnp.asarray(rgbs), take_indices=(5,),
                                final_tokens=False)["intermediates"][0]

    st = _port_student(student_params, dataclasses.replace(_cfg(), student=StudentConfig(**kw)))
    with torch.no_grad():
        desc, kp = st.get_feature_and_intermediates(torch.from_numpy(rgbs),
                                                    torch.from_numpy(pts))
        cost = st.get_feature_cost(torch.from_numpy(rgbs))
        inter = st.forward_tokens(torch.from_numpy(rgbs), take_indices=(5,),
                                  final_tokens=False)["intermediates"][0]
    assert str(jinter.dtype) == "bfloat16" and inter.dtype == torch.bfloat16
    drift = {}
    for name, g, w in (("desc", desc, jdesc), ("kp_feat", kp, jkp), ("cost", cost, jcost),
                       ("intermediate", inter, jinter)):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape, name
        drift[name] = float(np.abs(g.float().numpy() - w).max()) / max(1.0, float(np.abs(w).max()))
    print(f"bf16_stream student drift from gd3d (max |diff| / max(1, max |gd3d|)): {drift}")
    assert max(drift.values()) <= 5e-2, drift
