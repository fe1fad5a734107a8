"""The composed lock: the gd3d_torch MASt3R distillation train step against
gd3d's jitted step, at the tiny configs of tests/test_mast3r_train.py, on
shared weights (one seeded gd3d init, converted), one batch, two steps,
fp32 on the CPU.

Asserted per step: the four loss scalars, the weighted total and the
keypoint count; after the second step, every trainable parameter.
Tolerance: losses rtol 1e-4 (a full model's fp32 sums in another order);
parameters atol 1e-6, a tenth of the learning rate: after AdamW each
element moves by about lr * sign(grad), so this bound catches any
gradient-sign or update-rule difference.

The teacher's DPT xyz output is rescaled on this batch by
Mast3rTeacher.face_forward, as chip_smoke.py does at full width, and the
rescaled conv is written back into gd3d's tree: with raw random weights
almost no point rasterizes into the image, the depth maps are empty, and
the intra-depth loss is 0 with no gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from gd3d.core.config import DistillConfig as JDistillConfig
from gd3d.core.config import KeypointConfig as JKeypointConfig
from gd3d.core.config import StudentConfig as JStudentConfig
from gd3d.distill import make_optimizer as jmake_optimizer
from gd3d.distill.mast3r_step import build_mast3r_train_step as jbuild_step
from gd3d.distill.mast3r_step import temperature_schedule as jtemperature_schedule
from gd3d.distill.train_state import init_state
from gd3d.models.croco import CrocoConfig as JCrocoConfig
from gd3d.models.mast3r import Mast3rConfig as JMast3rConfig
from gd3d.models.student import Student as JStudent
from gd3d.models.student import merge_params
from gd3d.models.student import split_params as jsplit_params
from gd3d.teachers.mast3r import Mast3rTeacher as JMast3rTeacher
from gd3d_torch.convert import mast3r_state_dict, student_state_dict
from gd3d_torch.core.config import DistillConfig, KeypointConfig, StudentConfig
from gd3d_torch.distill.mast3r_step import build_mast3r_train_step, temperature_schedule
from gd3d_torch.distill.train_state import make_optimizer
from gd3d_torch.models.croco import CrocoConfig
from gd3d_torch.models.mast3r import Mast3rConfig
from gd3d_torch.models.student import Student, split_params
from gd3d_torch.teachers.mast3r import Mast3rTeacher

STUDENT_KW = dict(embed_dim=32, depth=8, num_heads=2, patch_size=16, pretrain_img_size=32,
                  lora_start_block=4, use_adapters=True, adapter_bottleneck=8,
                  target_res=64, downsample_factor=8, depth_head_hidden=16)
CROCO_KW = dict(patch_size=16, enc_embed_dim=32, enc_depth=2, enc_num_heads=2,
                dec_embed_dim=16, dec_depth=2, dec_num_heads=2)
MAST3R_KW = dict(local_feat_dim=6, dpt_feature_dim=32, dpt_last_dim=16)
LOSSES = ("loss", "ap_loss", "depth_loss", "intra_depth_loss", "kl_loss")


def _batch(B=1, H=64, W=96):
    rng = np.random.RandomState(0)
    return {
        "rgb_1": rng.rand(B, 128, 128, 3).astype(np.float32),
        "rgb_2": rng.rand(B, 128, 128, 3).astype(np.float32),
        "rgb_mast3r_1": (rng.rand(B, H, W, 3) * 2 - 1).astype(np.float32),
        "rgb_mast3r_2": (rng.rand(B, H, W, 3) * 2 - 1).astype(np.float32),
        "intrinsic": np.tile(np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]],
                                      np.float32), (B, 1, 1)),
    }


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def test_two_steps_match_gd3d():
    # ---- gd3d side
    jcfg = JDistillConfig(teacher="mast3r", dataset="scannetpp",
                          student=JStudentConfig(**STUDENT_KW),
                          keypoints=JKeypointConfig(nn_subsample=16))
    jst = JStudent(jcfg.student)
    params = _np(jst.init(jax.random.key(0), img_size=32))
    rng = np.random.RandomState(1)
    for name in ("lora_b_q", "lora_b_v"):  # non-zero LoRA B: the LoRA path matters
        k = params["vit"]["blocks_adapt"]["attn"][name]["kernel"]
        params["vit"]["blocks_adapt"]["attn"][name]["kernel"] = (
            0.1 * rng.randn(*k.shape)).astype(np.float32)
    jte = JMast3rTeacher(JMast3rConfig(croco=JCrocoConfig(**CROCO_KW), **MAST3R_KW))
    tparams = _np(jte.init_params(jax.random.key(1), hw=(64, 96)))
    batch = _batch()
    tcfg = Mast3rConfig(croco=CrocoConfig(**CROCO_KW), **MAST3R_KW)
    te = Mast3rTeacher(tcfg)
    te.model.load_state_dict(mast3r_state_dict(tparams, tcfg))
    te.face_forward(torch.from_numpy(batch["rgb_mast3r_1"]),
                    torch.from_numpy(batch["rgb_mast3r_2"]))
    for head, mod in (("head1", te.model.downstream_head1),
                      ("head2", te.model.downstream_head2)):
        conv = mod.dpt.head[4]  # OIHW -> HWIO
        tparams[head]["dpt"]["head_4"]["kernel"] = conv.weight.detach().permute(2, 3, 1, 0).numpy()
        tparams[head]["dpt"]["head_4"]["bias"] = conv.bias.detach().numpy().copy()

    trainable, frozen = jsplit_params(jax.tree_util.tree_map(jnp.asarray, params))
    tx = jmake_optimizer(jcfg.train)
    state = init_state(tx, trainable)
    jstep = jax.jit(jbuild_step(jst, jte, jcfg, tx, has_depth=False))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jtp = jax.tree_util.tree_map(jnp.asarray, tparams)
    want = []
    for _ in range(2):
        state, m = jstep(state, frozen, jtp, jbatch, 1.0)
        want.append({k: float(v) for k, v in m.items()})
    want_params = student_state_dict(_np(merge_params(state.trainable, frozen)),
                                      StudentConfig(**STUDENT_KW))

    # ---- gd3d_torch side, same weights
    cfg = DistillConfig(teacher="mast3r", dataset="scannetpp",
                        student=StudentConfig(**STUDENT_KW),
                        keypoints=KeypointConfig(nn_subsample=16))
    st = Student(cfg.student)
    st.load_state_dict(student_state_dict(params, cfg.student))
    tr, _ = split_params(st)
    step = build_mast3r_train_step(st, te, cfg, make_optimizer(cfg.train, tr.values()),
                                   has_depth=False, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = [{k: float(v) for k, v in step(tbatch, 1.0).items()} for _ in range(2)]

    for g, w in zip(got, want):
        assert g["num_kps"] == w["num_kps"] > 0
        assert w["depth_loss"] > 0.0 and w["intra_depth_loss"] > 0.0
        for k in LOSSES:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7, err_msg=k)
    assert abs(got[1]["loss"] - got[0]["loss"]) > 0  # the update changed the loss
    for name, p in tr.items():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_temperature_schedule():
    jcfg, cfg = JDistillConfig(), DistillConfig()
    for epoch in (0, 1, 125, 250, 499, 500, 800):
        assert temperature_schedule(cfg, epoch) == jtemperature_schedule(jcfg, epoch)
