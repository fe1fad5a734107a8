"""The ME baseline of the port against gd3d on the CPU, fp32: the loss
ap_loss_me (with its positive cap and overflow count), the student's
get_feature (with and without the 14-px ME quirk), and two jitted
build_me_train_step steps on shared weights (one seeded gd3d init,
converted by gd3d_torch/convert.py), at the CLI's --tiny student.

Tolerances: the loss and the features rtol 1e-5 / atol 1e-6 (fp32 sums
in another order over at most 64 x 64 pairs); the overflow count is exact;
the step's losses rtol 1e-4, and the parameters after the second AdamW
update atol 1e-6, a tenth of the learning rate (an element moves by about
lr * sign(grad) a step, so this catches any sign or update-rule
difference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gd3d.core.config import DistillConfig as JDistillConfig
from gd3d.core.config import StudentConfig as JStudentConfig
from gd3d.data.synthetic import synthetic_me_batch as jsynthetic_me_batch
from gd3d.distill import build_me_train_step as jbuild_me_train_step
from gd3d.distill import make_optimizer as jmake_optimizer
from gd3d.distill.train_state import init_state
from gd3d.models.student import Student as JStudent
from gd3d.models.student import merge_params
from gd3d.models.student import split_params as jsplit_params
from gd3d.ops.losses import ap_loss_me as jap_loss_me
from gd3d_torch.convert import student_state_dict
from gd3d_torch.core.config import me_objaverse
from gd3d_torch.cli.train import tiny_config
from gd3d_torch.distill.me import build_me_train_step
from gd3d_torch.distill.train_state import make_optimizer
from gd3d_torch.models.student import Student, split_params
from gd3d_torch.ops.losses import ap_loss_me, first_true_indices


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _loss_inputs(seed, B=2, S=48, T=40, close=0.004):
    """Descriptors on the unit sphere; 3D points on a coarse lattice so that
    many (i, j) pairs are positives (< 5e-3), others negatives (> 0.1)."""
    rng = np.random.RandomState(seed)
    d1 = rng.randn(B, S, 8).astype(np.float32)
    d2 = rng.randn(B, T, 8).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    lattice = rng.randint(0, 4, size=(B, S, 3)).astype(np.float32) * 0.05
    p1 = lattice + rng.uniform(0, close / 4, size=lattice.shape).astype(np.float32)
    p2 = lattice[:, rng.randint(0, S, size=T)] + rng.uniform(
        0, close / 4, size=(B, T, 3)).astype(np.float32)
    v1 = rng.rand(B, S) > 0.2
    v2 = rng.rand(B, T) > 0.2
    return d1, d2, p1, p2, v1, v2


@pytest.mark.parametrize("max_pos,masks", [(8192, True), (8192, False), (37, True)])
def test_ap_loss_me_matches_gd3d(max_pos, masks):
    """With masks, without, and with more positives than max_pos (the
    first max_pos in row-major order are kept; the overflow counts the
    rest)."""
    d1, d2, p1, p2, v1, v2 = _loss_inputs(0)
    kw = dict(max_pos=max_pos, return_overflow=True)
    jv = dict(valid_1=jnp.asarray(v1), valid_2=jnp.asarray(v2)) if masks else {}
    tv = dict(valid_1=_t(v1), valid_2=_t(v2)) if masks else {}
    want, want_over = jap_loss_me(*(jnp.asarray(a) for a in (d1, d2, p1, p2)), **jv, **kw)
    got, got_over = ap_loss_me(*(_t(a) for a in (d1, d2, p1, p2)), **tv, **kw)
    assert float(want) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    assert float(got_over) == float(want_over)
    if max_pos == 37:
        assert float(want_over) > 0  # the cap binds in this case
    else:
        assert float(want_over) == 0


def test_ap_loss_me_gradients_match_gd3d():
    d1, d2, p1, p2, v1, v2 = _loss_inputs(1)
    jg = jax.grad(lambda a, b: jap_loss_me(a, b, jnp.asarray(p1), jnp.asarray(p2),
                                           jnp.asarray(v1), jnp.asarray(v2), max_pos=50),
                  argnums=(0, 1))(jnp.asarray(d1), jnp.asarray(d2))
    a, b = _t(d1).requires_grad_(True), _t(d2).requires_grad_(True)
    ap_loss_me(a, b, _t(p1), _t(p2), _t(v1), _t(v2), max_pos=50).backward()
    for got, want in zip((a.grad, b.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_first_true_indices_is_row_major_and_static():
    mask = torch.tensor([0, 1, 1, 0, 1, 0, 1, 1], dtype=torch.bool)
    idx, n = first_true_indices(mask, 3)
    assert idx.tolist() == [1, 2, 4] and int(n) == 3
    idx, n = first_true_indices(mask, 7)
    assert idx.tolist() == [1, 2, 4, 6, 7, 0, 0] and int(n) == 5


def _shared_student(quirk, seed=0):
    jcfg = JDistillConfig(teacher="me", dataset="objaverse",
                          student=JStudentConfig(**_tiny_student_kw()))
    jst = JStudent(jcfg.student, me_interp_quirk=quirk)
    params = jax.tree_util.tree_map(np.array, jst.init(jax.random.key(seed), img_size=64))
    rng = np.random.RandomState(seed + 1)
    for name in ("lora_b_q", "lora_b_v"):  # non-zero LoRA B: the LoRA path matters
        k = params["vit"]["blocks_adapt"]["attn"][name]["kernel"]
        params["vit"]["blocks_adapt"]["attn"][name]["kernel"] = (
            0.1 * rng.randn(*k.shape)).astype(np.float32)
    cfg = tiny_config(me_objaverse())
    st = Student(cfg.student, me_interp_quirk=quirk)
    st.load_state_dict(student_state_dict(params, cfg.student))
    return jcfg, jst, params, cfg, st


def _tiny_student_kw():
    s = tiny_config(me_objaverse()).student
    return {f: getattr(s, f) for f in ("embed_dim", "depth", "num_heads", "patch_size",
                                       "pretrain_img_size", "lora_start_block",
                                       "use_adapters", "target_res", "depth_head_hidden")}


@pytest.mark.parametrize("quirk", [True, False])
def test_get_feature_matches_gd3d(quirk):
    _, jst, params, _, st = _shared_student(quirk)
    b = jsynthetic_me_batch(3, batch=2, img=64, n_kps=32)
    want, want_g = jst.get_feature(params, jnp.asarray(b["rgb_1"]), jnp.asarray(b["pts2d_1"]),
                                   normalize=False, global_feature=True)
    got, got_g = st.get_feature(_t(b["rgb_1"]), _t(b["pts2d_1"]), normalize=False,
                                global_feature=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_g.detach().numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-5)


def test_two_me_steps_match_gd3d():
    """Two build_me_train_step steps with me_interp_quirk, on two synthetic
    batches: the loss and the overflow per step, every trainable parameter
    after the second update."""
    jcfg, jst, params, cfg, st = _shared_student(True)
    batches = [jsynthetic_me_batch(42 + i, batch=1, img=64, n_kps=64) for i in range(2)]

    trainable, frozen = jsplit_params(jax.tree_util.tree_map(jnp.asarray, params))
    tx = jmake_optimizer(jcfg.train)
    state = init_state(tx, trainable)
    jstep = jax.jit(jbuild_me_train_step(jst, jcfg, tx))
    want = []
    for b in batches:
        state, m = jstep(state, frozen, {k: jnp.asarray(v) for k, v in b.items()})
        want.append({k: float(v) for k, v in m.items()})
    want_params = student_state_dict(
        jax.tree_util.tree_map(np.array, merge_params(state.trainable, frozen)), cfg.student)

    tr, _ = split_params(st)
    step = build_me_train_step(st, cfg, make_optimizer(cfg.train, tr.values()), device="cpu")
    got = [{k: float(v) for k, v in step({k: _t(v) for k, v in b.items()}).items()}
           for b in batches]
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"loss", "ap_pos_overflow"}
        assert w["loss"] > 0 and g["ap_pos_overflow"] == w["ap_pos_overflow"] == 0
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4, atol=1e-7)
    for name, p in tr.items():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_me_builder_defaults_to_the_card():
    """build_me_train_step puts the student on the device it is given; the
    default is the card, which raises without one."""
    cfg = tiny_config(me_objaverse())
    st = Student(cfg.student, me_interp_quirk=True)
    opt = make_optimizer(cfg.train, split_params(st)[0].values())
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            build_me_train_step(st, cfg, opt)
    build_me_train_step(st, cfg, opt, device="meta")
    assert {p.device.type for p in st.parameters()} == {"meta"}
