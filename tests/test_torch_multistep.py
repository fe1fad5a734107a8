"""The objaverse MASt3R path (batch depth maps, has_depth=True) and the
K-step groups of the port against gd3d, fp32 on the CPU, at the tiny
configs of tests/test_torch_step.py on shared weights.

- gd3d's jitted build_mast3r_train_multistep (lax.scan) over a K = 2 stack
  of two objaverse batches (depth maps at the student's 128^2, resized to
  the teacher's 64x96 frame) against the port's K = 2 group: the stacked
  losses and keypoint counts per step, rtol 1e-4 (a full model's fp32 sums
  in another order), and every trainable parameter after the group, atol
  1e-6 (a tenth of the learning rate);
- gd3d's jitted build_vggt_train_multistep over two VGGT batches against
  the port's group handed gd3d's NMS priority draws (the two generators
  give other numbers), at the TINY VGGT of tests/test_torch_vggt_step.py,
  with the same tolerances but for at most 0.1% of a tensor's elements,
  which may differ by up to 4e-5 (see _assert_group_matches);
- the port's group equals two single steps on fresh copies bit for bit
  (the same operations in the same order), for MASt3R and for VGGT, whose
  NMS draws come from one generator in the order two single steps draw.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gd3d.core.config import DistillConfig as JDistillConfig
from gd3d.core.config import KeypointConfig as JKeypointConfig
from gd3d.core.config import StudentConfig as JStudentConfig
from gd3d.distill import make_optimizer as jmake_optimizer
from gd3d.core.config import LossWeights as JLossWeights
from gd3d.distill.mast3r_step import build_mast3r_train_multistep as jbuild_multistep
from gd3d.distill.vggt_step import build_vggt_train_multistep as jbuild_vggt_multistep
from gd3d.distill.train_state import init_state
from gd3d.models.croco import CrocoConfig as JCrocoConfig
from gd3d.models.mast3r import Mast3rConfig as JMast3rConfig
from gd3d.models.student import Student as JStudent
from gd3d.models.student import merge_params
from gd3d.models.student import split_params as jsplit_params
from gd3d.models.vggt.config import VggtConfig as JVggtConfig
from gd3d.teachers.mast3r import Mast3rTeacher as JMast3rTeacher
from gd3d.teachers.vggt import VggtTeacher as JVggtTeacher
from gd3d.teachers.vggt import bias_params_for_live_keypoints as jbias_params
from gd3d_torch.convert import mast3r_state_dict, student_state_dict, vggt_state_dict
from gd3d_torch.core.config import DistillConfig, KeypointConfig, LossWeights, StudentConfig
from gd3d_torch.core.config import vggt_scannetpp
from gd3d_torch.data.synthetic import synthetic_teacher_batch
from gd3d_torch.distill.mast3r_step import (build_mast3r_train_multistep,
                                            build_mast3r_train_step)
from gd3d_torch.distill.train_state import make_optimizer
from gd3d_torch.distill.vggt_step import build_vggt_train_multistep, build_vggt_train_step
from gd3d_torch.models.croco import CrocoConfig
from gd3d_torch.models.mast3r import Mast3rConfig
from gd3d_torch.models.student import Student, split_params
from gd3d_torch.models.vggt.config import VggtConfig
from gd3d_torch.models.vit import init_params_
from gd3d_torch.teachers.mast3r import Mast3rTeacher
from gd3d_torch.teachers.vggt import VggtTeacher, bias_params_for_live_keypoints
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

STUDENT_KW = dict(embed_dim=32, depth=8, num_heads=2, patch_size=16, pretrain_img_size=32,
                  lora_start_block=4, use_adapters=True, adapter_bottleneck=8,
                  target_res=64, downsample_factor=8, depth_head_hidden=16)
CROCO_KW = dict(patch_size=16, enc_embed_dim=32, enc_depth=2, enc_num_heads=2,
                dec_embed_dim=16, dec_depth=2, dec_num_heads=2)
MAST3R_KW = dict(local_feat_dim=6, dpt_feature_dim=32, dpt_last_dim=16)
LOSSES = ("loss", "ap_loss", "depth_loss", "intra_depth_loss", "kl_loss")
VGGT_KW = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=2,
               num_register_tokens=4, dino_depth=2, dino_num_heads=2, camera_trunk_depth=1,
               camera_iterations=2, dpt_features=8, dpt_out_channels=(8, 8, 8, 8),
               dpt_hooks=(0, 0, 1, 1), track_features=8, track_iters=2, track_stride=2,
               corr_levels=2, corr_radius=1, track_hidden_size=16, track_depth=2,
               num_virtual_tracks=4)
KP_KW = dict(nms_num=32, nms_min_distance=2)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _shared_student(seed=0):
    params = _np(JStudent(JStudentConfig(**STUDENT_KW)).init(jax.random.key(seed), img_size=32))
    rng = np.random.RandomState(seed + 1)
    for name in ("lora_b_q", "lora_b_v"):  # non-zero LoRA B: the LoRA path matters
        k = params["vit"]["blocks_adapt"]["attn"][name]["kernel"]
        params["vit"]["blocks_adapt"]["attn"][name]["kernel"] = (
            0.1 * rng.randn(*k.shape)).astype(np.float32)
    return params


def test_objaverse_group_matches_gd3d_multistep():
    jcfg = JDistillConfig(teacher="mast3r", dataset="objaverse",
                          student=JStudentConfig(**STUDENT_KW),
                          keypoints=JKeypointConfig(nn_subsample=16))
    jst = JStudent(jcfg.student)
    params = _shared_student()
    jte = JMast3rTeacher(JMast3rConfig(croco=JCrocoConfig(**CROCO_KW), **MAST3R_KW))
    tparams = _np(jte.init_params(jax.random.key(1), hw=(64, 96)))
    batches = [synthetic_teacher_batch("mast3r", "objaverse", 1, s, tiny=True) for s in (3, 4)]
    assert batches[0]["depth_1"].shape == (1, 128, 128)  # resized to the 64x96 frame
    tcfg = Mast3rConfig(croco=CrocoConfig(**CROCO_KW), **MAST3R_KW)
    te = Mast3rTeacher(tcfg)
    te.model.load_state_dict(mast3r_state_dict(tparams, tcfg))
    te.face_forward(torch.from_numpy(batches[0]["rgb_mast3r_1"]),
                    torch.from_numpy(batches[0]["rgb_mast3r_2"]))
    for head, mod in (("head1", te.model.downstream_head1),
                      ("head2", te.model.downstream_head2)):
        conv = mod.dpt.head[4]  # OIHW -> HWIO
        tparams[head]["dpt"]["head_4"]["kernel"] = conv.weight.detach().permute(2, 3, 1, 0).numpy()
        tparams[head]["dpt"]["head_4"]["bias"] = conv.bias.detach().numpy().copy()

    trainable, frozen = jsplit_params(jax.tree_util.tree_map(jnp.asarray, params))
    tx = jmake_optimizer(jcfg.train)
    state = init_state(tx, trainable)
    jgroup = jax.jit(jbuild_multistep(jst, jte, jcfg, tx, has_depth=True))
    state, m = jgroup(state, frozen, jax.tree_util.tree_map(jnp.asarray, tparams),
                      {k: jnp.asarray(v) for k, v in _stack(batches).items()}, 0.9)
    want = {k: np.asarray(v) for k, v in m.items()}
    want_params = student_state_dict(_np(merge_params(state.trainable, frozen)),
                                     StudentConfig(**STUDENT_KW))

    cfg = DistillConfig(teacher="mast3r", dataset="objaverse",
                        student=StudentConfig(**STUDENT_KW),
                        keypoints=KeypointConfig(nn_subsample=16))
    st = Student(cfg.student)
    st.load_state_dict(student_state_dict(params, cfg.student))
    st2 = copy.deepcopy(st)
    tr, _ = split_params(st)
    group = build_mast3r_train_multistep(st, te, cfg, make_optimizer(cfg.train, tr.values()),
                                         has_depth=True, device="cpu")
    got = {k: v.numpy() for k, v in group(_torch(_stack(batches)), 0.9).items()}
    _assert_group_matches(got, want, tr, want_params)

    # the same group as two single steps on a fresh copy: the same bits
    tr2, _ = split_params(st2)
    step = build_mast3r_train_step(st2, te, cfg, make_optimizer(cfg.train, tr2.values()),
                                   has_depth=True, device="cpu")
    singles = [step(_torch(b), 0.9) for b in batches]
    for k in got:
        assert np.array_equal(got[k], np.stack([s[k].numpy() for s in singles])), k
    for name, p in tr.items():
        assert torch.equal(p, tr2[name]), name


def _assert_group_matches(got, want, tr, want_params, noise_share=0.0):
    """Stacked losses rtol 1e-4; parameters atol 1e-6, except a share of
    at most `noise_share` of a tensor's elements, which must stay within
    4e-5: an element whose gradient sits at the fp32 noise floor takes an
    AdamW step of about lr = 1e-5 of either sign, in each of the two
    steps."""
    assert got.keys() == want.keys() and got["loss"].shape == (2,)
    for i in range(2):
        assert got["num_kps"][i] == want["num_kps"][i] > 0
        assert want["depth_loss"][i] > 0 and want["intra_depth_loss"][i] > 0
        for k in LOSSES:
            np.testing.assert_allclose(got[k][i], want[k][i], rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    for name, p in tr.items():
        diff = np.abs(p.detach().numpy() - want_params[name].numpy())
        assert (diff > 1e-6).mean() <= noise_share and diff.max() <= 4e-5, (
            name, int((diff > 1e-6).sum()), diff.size, float(diff.max()))


def test_vggt_group_matches_gd3d_multistep():
    """Both teachers pinned by bias_params_for_live_keypoints, the depth
    head's last conv rescaled on the first batch (VggtTeacher.spread_depth)
    and written back into gd3d's tree, as tests/test_torch_vggt_step.py
    does; the teacher's leaves perturbed so that its weights are not
    gd3d's init pattern."""
    params = _shared_student()
    rng = np.random.RandomState(3)
    tparams = _np(JVggtTeacher(JVggtConfig(**VGGT_KW)).init_params(jax.random.key(1),
                                                                   hw=(28, 28)))
    tparams = jax.tree_util.tree_map(
        lambda x: (x + 0.02 * rng.randn(*x.shape)).astype(np.float32), tparams)
    jcfg = JDistillConfig(teacher="vggt", dataset="scannetpp",
                          student=JStudentConfig(**STUDENT_KW),
                          loss_weights=JLossWeights(1.0, 1.0, 1.0, 1.0),
                          keypoints=JKeypointConfig(**KP_KW))
    jst, jte = JStudent(jcfg.student), JVggtTeacher(JVggtConfig(**VGGT_KW))
    batches = [synthetic_teacher_batch("vggt", "scannetpp", 1, s, tiny=True) for s in (5, 6)]
    for b in batches:  # the student frames of tests/test_torch_vggt_step.py
        b["rgb_1"], b["rgb_2"] = b["rgb_1"][:, :64, :64], b["rgb_2"][:, :64, :64]
    te = VggtTeacher(VggtConfig(**VGGT_KW))
    te.model.load_state_dict(vggt_state_dict(tparams, te.cfg))
    bias_params_for_live_keypoints(te)
    te.spread_depth(torch.from_numpy(batches[0]["rgb_vggt"]))
    conv = te.model.depth_head.scratch.output_conv2[2]
    jtp = jbias_params(jax.tree_util.tree_map(jnp.asarray, tparams), jte.cfg)
    jtp["depth_head"]["output_conv2_2"] = {
        "kernel": jnp.asarray(conv.weight.detach().permute(2, 3, 1, 0).numpy()),
        "bias": jnp.asarray(conv.bias.detach().numpy())}

    trainable, frozen = jsplit_params(jax.tree_util.tree_map(jnp.asarray, params))
    tx = jmake_optimizer(jcfg.train)
    state = init_state(tx, trainable)
    key = jax.random.key(2)
    jgroup = jax.jit(jbuild_vggt_multistep(jst, jte, jcfg, tx))
    state, m = jgroup(state, frozen, jtp, {k: jnp.asarray(v) for k, v in _stack(batches).items()},
                      0.9, key)
    want = {k: np.asarray(v) for k, v in m.items()}
    want_params = student_state_dict(_np(merge_params(state.trainable, frozen)),
                                     StudentConfig(**STUDENT_KW))
    # gd3d's draws: one key a slice of the group, split per pair inside the step
    priorities = torch.from_numpy(np.stack([
        np.stack([np.array(jax.random.uniform(k, (28 * 28,), jnp.float32))
                  for k in jax.random.split(slice_key, 1)])
        for slice_key in jax.random.split(key, 2)]))

    cfg = DistillConfig(teacher="vggt", dataset="scannetpp",
                        student=StudentConfig(**STUDENT_KW),
                        loss_weights=LossWeights(1.0, 1.0, 1.0, 1.0),
                        keypoints=KeypointConfig(**KP_KW))
    st = Student(cfg.student)
    st.load_state_dict(student_state_dict(params, cfg.student))
    tr, _ = split_params(st)
    group = build_vggt_train_multistep(st, te, cfg, make_optimizer(cfg.train, tr.values()),
                                       device="cpu")
    got = {k: v.numpy() for k, v in group(_torch(_stack(batches)), 0.9, priorities).items()}
    # two different batches through a 28^2 teacher leave a few refine-conv
    # elements with gradients at the noise floor (1 of 9216 on this input)
    _assert_group_matches(got, want, tr, want_params, noise_share=1e-3)


def test_vggt_group_equals_single_steps():
    """The group draws its NMS priorities from the generator in the order
    two single steps draw them; the metrics and parameters are the same
    bits. Tiny VGGT of tests/test_torch_vggt_step.py, random weights pinned
    by bias_params_for_live_keypoints."""
    g = torch.Generator().manual_seed(0)
    te = VggtTeacher(VggtConfig(
        img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=2, dino_depth=2,
        dino_num_heads=2, camera_trunk_depth=1, camera_iterations=2, dpt_features=8,
        dpt_out_channels=(8, 8, 8, 8), dpt_hooks=(0, 0, 1, 1), track_features=8,
        track_iters=2, corr_levels=2, corr_radius=1, track_hidden_size=16, track_depth=2,
        num_virtual_tracks=4))
    te.init_params(g)
    bias_params_for_live_keypoints(te)
    cfg = vggt_scannetpp().replace(student=StudentConfig(**STUDENT_KW), teacher_dtype="float32",
                                   keypoints=KeypointConfig(nms_num=32, nms_min_distance=2))
    batches = [synthetic_teacher_batch("vggt", "scannetpp", 1, s, tiny=True) for s in (5, 6)]
    te.spread_depth(torch.from_numpy(batches[0]["rgb_vggt"]))
    runs = []
    for grouped in (True, False):
        st = Student(cfg.student)
        init_params_(st, torch.Generator().manual_seed(1))
        tr, _ = split_params(st)
        opt = make_optimizer(cfg.train, tr.values())
        gen = torch.Generator().manual_seed(7)
        if grouped:
            m = build_vggt_train_multistep(st, te, cfg, opt, "cpu", gen)(
                _torch(_stack(batches)), 0.9)
        else:
            step = build_vggt_train_step(st, te, cfg, opt, "cpu", gen)
            ms = [step(_torch(b), 0.9) for b in batches]
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0]}
        runs.append((m, tr))
    (mg, trg), (ms, trs) = runs
    assert mg["loss"].shape == (2,) and float(mg["num_kps"].min()) > 0
    for k in mg:
        assert torch.equal(mg[k], ms[k]), k
    for name in trg:
        assert torch.equal(trg[name], trs[name]), name
