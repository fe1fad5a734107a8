"""Tensor parallelism (gd3d_torch/parallel/sharding.py) on gd3d's data x
model mesh (gd3d_torch/core/mesh.py) against gd3d's single-device runs, on
the CPU: the port on gloo with 2 spawned ranks (a 1 x 2 mesh) and 4 (2 x 2,
DP x TP), through tests/torch_parallel_worker.py; gd3d's jitted functions on
one device at the tiny configs of gd3d's tests/test_tensor_parallel.py
(whose slow tests show that gd3d's TP equals that run).

- The ME step with the student sliced over the model group, the global
  batch of 4 over the data group: the loss within 1e-5 relative, the
  post-AdamW trainables (gathered) by tests/test_torch_distributed.py's rule
  (atol 1e-6, at most 0.1% of a tensor's elements within 4e-5).
- The MASt3R teacher's extract_features, sliced: rtol 5e-4, atol 1e-5.
- The VGGT teacher's, sliced: rtol 5e-4, atol 5e-5.
- The TP run's restart state and adapter checkpoint, written by rank 0 in
  the single-device layout, reload at world 1 to the TP run's gathered
  tensors exactly, and restored at the TP mesh they re-slice to each rank's
  own slices bit for bit.
- shard_module slices a fused qkv by head; the mesh's groups follow gd3d's
  make_mesh layout; one process refuses mesh.model > 1, as make_mesh does.

Each rank compares its own batch rows (its data index) with gd3d's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from gd3d.core.config import DistillConfig as JDistillConfig
from gd3d.core.config import StudentConfig as JStudentConfig
from gd3d.data.synthetic import synthetic_me_batch as jsynthetic_me_batch
from gd3d.distill import build_me_train_step as jbuild_me_train_step
from gd3d.distill import make_optimizer as jmake_optimizer
from gd3d.distill.train_state import init_state
from gd3d.models.croco import CrocoConfig as JCrocoConfig
from gd3d.models.mast3r import Mast3rConfig as JMast3rConfig
from gd3d.models.student import Student as JStudent
from gd3d.models.student import merge_params
from gd3d.models.student import split_params as jsplit_params
from gd3d.models.vggt.config import VggtConfig as JVggtConfig
from gd3d.teachers.mast3r import Mast3rTeacher as JMast3rTeacher
from gd3d.teachers.vggt import VggtTeacher as JVggtTeacher
from gd3d_torch.cli.train import tiny_config
from gd3d_torch.convert import mast3r_state_dict, student_state_dict, vggt_state_dict
from gd3d_torch.core.checkpoint import restore_checkpoint, restore_train_state
from gd3d_torch.core.config import me_objaverse
from gd3d_torch.core.mesh import ModelGroup
from gd3d_torch.distill.train_state import make_optimizer
from gd3d_torch.models.croco import CrocoConfig
from gd3d_torch.models.mast3r import Mast3rConfig
from gd3d_torch.models.student import Student, split_params
from gd3d_torch.models.vggt.config import VggtConfig
from gd3d_torch.models.vit import Attention
from gd3d_torch.parallel.sharding import shard_module, tp_slice
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

GLOBAL_B = 4
CROCO_KW = dict(patch_size=16, enc_embed_dim=32, enc_depth=2, enc_num_heads=2,
                dec_embed_dim=16, dec_depth=2, dec_num_heads=2)
MAST3R_KW = dict(local_feat_dim=6, dpt_feature_dim=16, dpt_last_dim=8)
VGGT_KW = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=2,
               num_register_tokens=4, dino_depth=2, dino_num_heads=2, camera_trunk_depth=1,
               camera_iterations=2, dpt_features=8, dpt_out_channels=(8, 8, 8, 8),
               dpt_hooks=(0, 0, 1, 1), track_features=8, track_iters=2, track_stride=2,
               corr_levels=2, corr_radius=1, track_hidden_size=16, track_depth=2,
               num_virtual_tracks=4)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _tiny_student_kw():
    s = tiny_config(me_objaverse()).student
    return {f: getattr(s, f) for f in ("embed_dim", "depth", "num_heads", "patch_size",
                                       "pretrain_img_size", "lora_start_block",
                                       "use_adapters", "target_res", "depth_head_hidden")}


def _me_reference():
    """gd3d's ME step at the CLI's --tiny student (non-zero LoRA B) on a
    global batch of 4."""
    jcfg = JDistillConfig(teacher="me", dataset="objaverse",
                          student=JStudentConfig(**_tiny_student_kw()))
    jst = JStudent(jcfg.student, me_interp_quirk=True)
    params = _np(jst.init(jax.random.key(0), img_size=64))
    rng = np.random.RandomState(1)
    for name in ("lora_b_q", "lora_b_v"):
        k = params["vit"]["blocks_adapt"]["attn"][name]["kernel"]
        params["vit"]["blocks_adapt"]["attn"][name]["kernel"] = (
            0.1 * rng.randn(*k.shape)).astype(np.float32)
    batch = jsynthetic_me_batch(42, batch=GLOBAL_B, img=64, n_kps=64)
    trainable, frozen = jsplit_params(jax.tree_util.tree_map(jnp.asarray, params))
    tx = jmake_optimizer(jcfg.train)
    state, m = jax.jit(jbuild_me_train_step(jst, jcfg, tx))(
        init_state(tx, trainable), frozen, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = tiny_config(me_objaverse())
    want = ({k: float(v) for k, v in m.items()},
            student_state_dict(_np(merge_params(state.trainable, frozen)), cfg.student))
    return dict(job="me", n_model=2, student_state=student_state_dict(params, cfg.student),
                batch=batch), want


def _mast3r_reference():
    jte = JMast3rTeacher(JMast3rConfig(croco=JCrocoConfig(**CROCO_KW), **MAST3R_KW))
    tparams = _np(jte.init_params(jax.random.key(2), hw=(32, 64)))
    rng = np.random.RandomState(0)
    r1, r2 = ((rng.rand(GLOBAL_B, 32, 64, 3) * 2 - 1).astype(np.float32) for _ in range(2))
    want = _np(jax.jit(jte.extract_features)(jax.tree_util.tree_map(jnp.asarray, tparams),
                                             jnp.asarray(r1), jnp.asarray(r2), 0.8))
    tcfg = Mast3rConfig(croco=CrocoConfig(**CROCO_KW), **MAST3R_KW)
    return dict(job="teacher", kind="mast3r", tp=True, n_model=2,
                teacher_kw=dict(croco=CROCO_KW, **MAST3R_KW),
                teacher_state=mast3r_state_dict(tparams, tcfg), images=(r1, r2),
                temperature=0.8), want


def vggt_reference(B=GLOBAL_B):
    """gd3d's VGGT teacher at its tests' TINY config, its weights perturbed
    (random heads otherwise put the principal point at infinity), on B
    pairs: (the port's state dict, the frames, gd3d's features)."""
    jte = JVggtTeacher(JVggtConfig(**VGGT_KW))
    rng = np.random.RandomState(1)
    tparams = jax.tree_util.tree_map(
        lambda x: (np.array(x) + 0.02 * rng.randn(*x.shape)).astype(np.float32),
        jte.init_params(jax.random.key(1), hw=(28, 28)))
    rgb = np.random.RandomState(3).rand(B, 2, 28, 28, 3).astype(np.float32)
    want = _np(jax.jit(jte.extract_features)(jax.tree_util.tree_map(jnp.asarray, tparams),
                                             jnp.asarray(rgb), 0.9))
    return vggt_state_dict(tparams, VggtConfig(**VGGT_KW)), rgb, want


@pytest.fixture(scope="module")
def references():
    state, rgb, want = vggt_reference()
    return {"me": _me_reference(), "mast3r": _mast3r_reference(),
            "vggt": (dict(job="teacher", kind="vggt", tp=True, n_model=2, teacher_kw=VGGT_KW,
                          teacher_state=state, images=(rgb,), temperature=0.9), want)}


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def runs(request, references, tmp_path_factory):
    world = request.param
    out = tmp_path_factory.mktemp(f"tp{world}")
    worker.spawn(world, {name: job for name, (job, _) in references.items()}, out)
    return world, out, {name: worker.load(out, name, world) for name in references}


def _rows(want, res):
    per = GLOBAL_B // res["n_data"]
    return {k: v[res["data_rank"] * per:(res["data_rank"] + 1) * per] for k, v in want.items()}


def test_me_step_matches_gd3d(references, runs):
    want_m, want_p = references["me"][1]
    _, _, results = runs
    assert want_m["loss"] > 0
    for res in results["me"]:
        assert res["sliced"] > 0 and not res["whole"]
        assert res["local_qkv"] == (3 * 16, 32)  # one head of 16 of the two
        assert res["metrics"]["ap_pos_overflow"] == want_m["ap_pos_overflow"]
        np.testing.assert_allclose(res["metrics"]["loss"], want_m["loss"], rtol=1e-5)
        for name, p in res["trainable"].items():
            diff = np.abs(p.numpy() - want_p[name].numpy())
            assert (diff > 1e-6).mean() <= 1e-3 and diff.max() <= 4e-5, (
                name, int((diff > 1e-6).sum()), diff.size, float(diff.max()))


@pytest.mark.parametrize("kind,tol", [("mast3r", dict(rtol=5e-4, atol=1e-5)),
                                      ("vggt", dict(rtol=5e-4, atol=5e-5))])
def test_teacher_matches_gd3d(references, runs, kind, tol):
    want = references[kind][1]
    for res in runs[2][kind]:
        assert res["sliced"] > 0 and not res["whole"]
        rows = _rows(want, res)
        for k, v in res["features"].items():
            np.testing.assert_allclose(v, rows[k], err_msg=k, **tol)


def test_checkpoint_reloads_at_world_one(runs):
    """The TP run's files hold the single-device layout: restored into a
    world-1 student they give the TP run's gathered trainables, and the
    restore at the TP mesh re-sliced each rank's own state bit for bit."""
    _, out, results = runs
    gathered = results["me"][0]["trainable"]
    cfg = tiny_config(me_objaverse())
    st = Student(cfg.student, me_interp_quirk=True)
    tr, _ = split_params(st)
    opt = make_optimizer(cfg.train, tr.values())
    assert restore_train_state(str(out / "me_last"), tr, opt) == 1
    for name, p in tr.items():
        assert torch.equal(p.detach(), gathered[name]), name
    for p in opt.params:
        assert opt.adamw.state[p]["exp_avg"].shape == p.shape
    st2 = Student(cfg.student, me_interp_quirk=True)
    tr2, _ = split_params(st2)
    restore_checkpoint(str(out / "me_ckpt"), tr2, cfg.student)
    for name in ("vit.blocks.3.attn.lora_b_q.weight", "vit.blocks.2.attn.lora_a_v.weight"):
        assert torch.equal(tr2[name].detach(), gathered[name]), name
    assert all(res["resumed_equal"] for res in results["me"])


def test_shard_module_slices_qkv_by_head():
    """Rank m of n keeps heads m * H / n onwards in each of the q, k and v
    thirds of a fused qkv (not a contiguous third of the 3C rows), the same
    rows of lora_b_q / lora_b_v, and proj's matching input columns; a
    module whose heads n does not divide stays whole."""
    C, H, n = 32, 4, 2
    D = C // H
    att = Attention(C, H, lora_rank=4)
    full = att.qkv.weight.detach().clone()
    proj = att.proj.weight.detach().clone()
    lora = att.lora_b_q.weight.detach().clone()
    assert shard_module(att, ModelGroup(rank=1, size=n)) == []
    rows = np.concatenate([np.arange(t * C + 2 * D, t * C + 4 * D) for t in range(3)])
    assert torch.equal(att.qkv.weight, full[rows])
    assert torch.equal(att.proj.weight, proj[:, 2 * D:4 * D])
    assert torch.equal(att.lora_b_q.weight, lora[2 * D:4 * D])
    assert att.num_heads == H // n and tp_slice(att.qkv.weight).full == 3 * C
    assert tp_slice(att.proj.bias) is None  # added once, after the all-reduce
    odd = Attention(C, H)
    assert shard_module(odd, ModelGroup(rank=0, size=3)) == [""]
    assert odd.qkv.weight.shape == (3 * C, C) and odd.tp is None


@pytest.mark.parametrize("world,n_model,want", [
    (4, 2, (2, [[0, 2], [1, 3]], [[0, 1], [2, 3]])),
    (8, 4, (2, [[0, 4], [1, 5], [2, 6], [3, 7]], [[0, 1, 2, 3], [4, 5, 6, 7]])),
    (3, 2, (1, [[0], [1]], [[0, 1]])),  # rank 2 left out, as make_mesh does
    (2, 1, (2, [[0, 1]], [[0], [1]])),
])
def test_mesh_groups_follow_gd3d_make_mesh(world, n_model, want):
    """Rank r at data index r // model and model index r % model: gd3d's
    make_mesh reshapes its device list row-major to (n_data, n_model)."""
    from gd3d.core.mesh import make_mesh
    from gd3d_torch.core.mesh import mesh_groups

    assert mesh_groups(world, n_model) == want
    grid = np.vectorize(lambda d: d.id)(make_mesh(n_model=n_model,
                                                  devices=jax.devices()[:world]).devices)
    assert grid.T.tolist() == want[1] and grid.tolist() == want[2]


def test_one_process_refuses_a_model_axis(tmp_path, monkeypatch):
    """Without --multihost there is one rank: mesh.model = 2 raises, as
    gd3d's make_mesh does on one device."""
    import dataclasses

    from gd3d_torch.cli import train
    from gd3d_torch.core import config as cfglib

    named = cfglib.resolve_config
    monkeypatch.setattr(cfglib, "resolve_config", lambda name: named(name).replace(
        mesh=dataclasses.replace(named(name).mesh, model=2)))
    with pytest.raises(ValueError, match="mesh.model=2 exceeds the 1 ranks"):
        train.setup(train.parse_args(["--tiny", "--synthetic", "--device", "cpu",
                                      "--output", str(tmp_path / "r")]))
