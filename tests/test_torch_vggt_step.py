"""The composed lock of the VGGT slice: the gd3d_torch VGGT distillation
train step against gd3d's jitted build_vggt_train_step, at the TINY VGGT
config and the tiny student of tests/test_vggt.py, on shared weights (one
seeded gd3d init per model, the teacher's leaves perturbed, converted), one
batch, two steps, fp32 on the CPU.

Both teachers are pinned by their bias_params_for_live_keypoints, so that
keypoints survive the co-view, NMS and border filters with random weights;
the depth head's last conv is rescaled on the batch by
VggtTeacher.spread_depth, as chip_smoke.py does (a flat random depth map
leaves the intra-depth loss at 0), and written back into gd3d's tree; and
the port's step is handed gd3d's NMS priority draw
(jax.random.uniform under the step's key), as the two generators give
other numbers.

Asserted per step: the four losses, the total and the keypoint count; after
the second step, every trainable parameter. Tolerance: losses rtol 1e-4
(fp32 sums in another order); parameters atol 1e-6, a tenth of the learning
rate (after AdamW an element moves by about lr * sign(grad)).

The bf16-aggregator teacher (the config's teacher_dtype) is compared with
gd3d's bf16 path on its features, under a looser tolerance: both round the
aggregator's weights and activations to bf16 (8 mantissa bits), in other
places, through 2 + 2 + 2 layers.
"""
import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gd3d.core.config import DistillConfig as JDistillConfig
from gd3d.core.config import KeypointConfig as JKeypointConfig
from gd3d.core.config import LossWeights as JLossWeights
from gd3d.core.config import StudentConfig as JStudentConfig
from gd3d.distill import make_optimizer as jmake_optimizer
from gd3d.distill.train_state import init_state
from gd3d.distill.vggt_step import build_vggt_train_step as jbuild_step
from gd3d.models.student import Student as JStudent
from gd3d.models.student import merge_params
from gd3d.models.student import split_params as jsplit_params
from gd3d.models.vggt.config import VggtConfig as JVggtConfig
from gd3d.teachers.vggt import VggtTeacher as JVggtTeacher
from gd3d.teachers.vggt import bias_params_for_live_keypoints as jbias_params
from gd3d_torch.convert import student_state_dict, vggt_state_dict
from gd3d_torch.core.config import DistillConfig, KeypointConfig, LossWeights, StudentConfig
from gd3d_torch.core.config import vggt_scannetpp
from gd3d_torch.distill.mast3r_step import build_mast3r_train_step
from gd3d_torch.distill.train_state import make_optimizer
from gd3d_torch.distill.vggt_step import build_vggt_train_step
from gd3d_torch.models.mast3r import Mast3rConfig
from gd3d_torch.models.croco import CrocoConfig
from gd3d_torch.models.student import Student, split_params
from gd3d_torch.models.vggt.config import VggtConfig
from gd3d_torch.teachers.mast3r import Mast3rTeacher
from gd3d_torch.teachers.vggt import VggtTeacher, bias_params_for_live_keypoints
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY_KW = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=2,
               num_register_tokens=4, dino_depth=2, dino_num_heads=2, camera_trunk_depth=1,
               camera_iterations=2, dpt_features=8, dpt_out_channels=(8, 8, 8, 8),
               dpt_hooks=(0, 0, 1, 1), track_features=8, track_iters=2, track_stride=2,
               corr_levels=2, corr_radius=1, track_hidden_size=16, track_depth=2,
               num_virtual_tracks=4)
STUDENT_KW = dict(embed_dim=32, depth=8, num_heads=2, patch_size=16, pretrain_img_size=32,
                  lora_start_block=4, use_adapters=True, adapter_bottleneck=8,
                  target_res=64, depth_head_hidden=16)
KP_KW = dict(nms_num=32, nms_min_distance=2)
LOSSES = ("loss", "ap_loss", "depth_loss", "intra_depth_loss", "kl_loss")


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _batch():
    rng = np.random.RandomState(4)
    return {
        "rgb_1": rng.rand(1, 64, 64, 3).astype(np.float32),
        "rgb_2": rng.rand(1, 64, 64, 3).astype(np.float32),
        "rgb_vggt": rng.rand(1, 2, 28, 28, 3).astype(np.float32),
    }


@pytest.fixture(scope="module")
def shared():
    """gd3d student params (non-zero LoRA B) and teacher params (perturbed,
    unpinned), as numpy trees."""
    params = _np(JStudent(JStudentConfig(**STUDENT_KW)).init(jax.random.key(0), img_size=32))
    rng = np.random.RandomState(1)
    for name in ("lora_b_q", "lora_b_v"):
        k = params["vit"]["blocks_adapt"]["attn"][name]["kernel"]
        params["vit"]["blocks_adapt"]["attn"][name]["kernel"] = (
            0.1 * rng.randn(*k.shape)).astype(np.float32)
    tparams = _np(JVggtTeacher(JVggtConfig(**TINY_KW)).init_params(jax.random.key(1),
                                                                   hw=(28, 28)))
    tparams = jax.tree_util.tree_map(
        lambda x: (x + 0.02 * rng.randn(*x.shape)).astype(np.float32), tparams)
    return params, tparams


def _port_teacher(tparams):
    te = VggtTeacher(VggtConfig(**TINY_KW))
    te.model.load_state_dict(vggt_state_dict(tparams, te.cfg))
    bias_params_for_live_keypoints(te)
    return te


def _spread_depth(te, jtp, rgb_vggt):
    """VggtTeacher.spread_depth on this batch, as chip_smoke.py does, and
    the rescaled conv written back into gd3d's tree (OIHW -> HWIO)."""
    te.spread_depth(torch.from_numpy(rgb_vggt))
    conv = te.model.depth_head.scratch.output_conv2[2]
    jtp["depth_head"]["output_conv2_2"] = {
        "kernel": jnp.asarray(conv.weight.detach().permute(2, 3, 1, 0).numpy()),
        "bias": jnp.asarray(conv.bias.detach().numpy())}
    return jtp


def test_two_steps_match_gd3d(shared):
    params, tparams = shared
    jcfg = JDistillConfig(teacher="vggt", dataset="scannetpp",
                          student=JStudentConfig(**STUDENT_KW),
                          loss_weights=JLossWeights(1.0, 1.0, 1.0, 1.0),
                          keypoints=JKeypointConfig(**KP_KW))
    jst, jte = JStudent(jcfg.student), JVggtTeacher(JVggtConfig(**TINY_KW))
    batch = _batch()
    te = _port_teacher(tparams)
    jtp = _spread_depth(te, jbias_params(jax.tree_util.tree_map(jnp.asarray, tparams), jte.cfg),
                        batch["rgb_vggt"])
    trainable, frozen = jsplit_params(jax.tree_util.tree_map(jnp.asarray, params))
    tx = jmake_optimizer(jcfg.train)
    state = init_state(tx, trainable)
    jstep = jax.jit(jbuild_step(jst, jte, jcfg, tx))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(2)
    want = []
    for _ in range(2):
        state, m = jstep(state, frozen, jtp, jbatch, 0.9, key)
        want.append({k: float(v) for k, v in m.items()})
    want_params = student_state_dict(_np(merge_params(state.trainable, frozen)),
                                     StudentConfig(**STUDENT_KW))
    # the NMS priority gd3d drew: sample_keypoints splits the step's key per pair
    priority = torch.from_numpy(np.stack([
        np.array(jax.random.uniform(k, (28 * 28,), jnp.float32))
        for k in jax.random.split(key, 1)]))

    cfg = DistillConfig(teacher="vggt", dataset="scannetpp",
                        student=StudentConfig(**STUDENT_KW),
                        loss_weights=LossWeights(1.0, 1.0, 1.0, 1.0),
                        keypoints=KeypointConfig(**KP_KW))
    st = Student(cfg.student)
    st.load_state_dict(student_state_dict(params, cfg.student))
    tr, _ = split_params(st)
    step = build_vggt_train_step(st, te, cfg,
                                 make_optimizer(cfg.train, tr.values()), device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = [{k: float(v) for k, v in step(tbatch, 0.9, priority=priority).items()}
           for _ in range(2)]

    for g, w in zip(got, want):
        assert g["num_kps"] == w["num_kps"] > 0
        assert w["depth_loss"] > 0.0 and w["intra_depth_loss"] > 0.0
        for k in LOSSES:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7, err_msg=k)
    assert abs(got[1]["loss"] - got[0]["loss"]) > 0  # the update changed the loss
    for name, p in tr.items():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("hw", [(28, 28), (28, 42)], ids=["square", "non_square"])
def test_bf16_aggregator_drift_from_gd3d(shared, hw):
    """Features of the bf16-aggregator teacher against gd3d's bf16 path, on
    square frames (the pos-embed is not resized) and on non-square ones
    (finetune_timm_vggt_scannetpp's 350x518 is one), where gd3d's resized
    fp32 pos-embed promotes the DINOv2 tokens to fp32 and the rest of the
    aggregator runs in fp32 on the bf16-rounded weights: the port's patch
    tokens must take gd3d's dtype. Tolerance: max |diff| <= 5e-2 *
    max(1, max |gd3d|) per feature (a few bf16 roundings of 2^-8 relative
    each, compounded over the layers)."""
    _, tparams = shared
    assert vggt_scannetpp().teacher_dtype == "bfloat16"
    jte = JVggtTeacher(JVggtConfig(**TINY_KW))
    jtp = jbias_params(jax.tree_util.tree_map(jnp.asarray, tparams), jte.cfg)
    rgb = np.random.RandomState(4).rand(1, 2, *hw, 3).astype(np.float32)
    seen = {}

    def catch_dino(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if type(context.module).__name__ == "DinoV2" and context.method_name == "__call__":
            seen["gd3d"] = str(out.dtype)
        return out

    with flax.linen.intercept_methods(catch_dino):
        want = jte.extract_features(jtp, jnp.asarray(rgb), 0.9, dtype="bfloat16")
    te = _port_teacher(tparams)
    hook = te.model.aggregator.patch_embed.register_forward_hook(
        lambda m, i, o: seen.__setitem__("port", str(o.dtype).split(".")[-1]))
    try:
        got = te.extract_features(torch.from_numpy(rgb), 0.9, dtype="bfloat16")
    finally:
        hook.remove()
    assert seen["port"] == seen["gd3d"] == ("bfloat16" if hw[0] == hw[1] else "float32"), seen
    drift = {}
    for k in ("depth_pred_1", "depth_pred_2", "point_map_view_1", "point_conf_view_1",
              "extrinsic_1", "intrinsic_1", "cost_1", "cost_2"):
        w = np.asarray(want[k])
        err = float(np.abs(got[k].numpy() - w).max())
        drift[k] = err / max(1.0, float(np.abs(w).max()))
    print(f"bf16 aggregator drift from gd3d at {hw} (max |diff| / max(1, max |gd3d|)): {drift}")
    assert max(drift.values()) <= 5e-2, drift


@pytest.mark.parametrize("which", ["mast3r", "vggt"])
def test_builders_put_modules_on_their_device(which):
    """The step builders move the student and the teacher to the device
    they are given; the default is the card, which raises without one."""
    scfg = StudentConfig(**STUDENT_KW)
    if which == "mast3r":
        teacher = Mast3rTeacher(Mast3rConfig(
            croco=CrocoConfig(enc_embed_dim=32, enc_depth=1, enc_num_heads=2,
                              dec_embed_dim=16, dec_depth=1, dec_num_heads=2),
            local_feat_dim=6, dpt_feature_dim=32, dpt_last_dim=16))
        cfg = DistillConfig(student=scfg)

        def build(st, te, opt, **kw):
            return build_mast3r_train_step(st, te, cfg, opt, has_depth=False, **kw)
    else:
        teacher = VggtTeacher(VggtConfig(**TINY_KW))
        cfg = dataclasses.replace(vggt_scannetpp(), student=scfg)

        def build(st, te, opt, **kw):
            return build_vggt_train_step(st, te, cfg, opt, **kw)
    student = Student(scfg)
    opt = make_optimizer(cfg.train, split_params(student)[0].values())
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            build(student, teacher, opt)
    build(student, teacher, opt, device="meta")
    devices = {p.device.type for m in (student, teacher) for p in m.parameters()}
    assert devices == {"meta"}
