"""Data-parallel training (gd3d_torch/core/mesh.py) and the FSDP-sharded
teacher (gd3d_torch/parallel/fsdp.py) against gd3d on one device, on the
CPU: the port on gloo with 2 and 4 spawned processes, gd3d's jitted step
on the same global batch of 4 pairs, at the tiny configs of
tests/test_torch_step.py (MASt3R) and tests/test_torch_vggt_step.py (VGGT),
one step each, with and without the sharded teacher (a small min_size, so
that the tiny teacher's weights are sharded at all).

Tolerances: every rank logs the same metrics (the global batch's, summed
shares, compared exactly); the losses against gd3d's within rtol 1e-5 (the
port's ranks sum their shares in another order than gd3d's one device);
the keypoint count exactly; the post-AdamW trainable tensors atol 1e-6,
except at most 0.1% of a tensor's elements within 4e-5 (the rule of
tests/test_torch_multistep.py: an element whose gradient sits at the fp32
noise floor takes an AdamW step of about lr = 1e-5 of either sign).

The CLI test runs `--multihost --fsdp-teacher --tiny` with 2 ranks as two
processes: rank 1 writes proc1/metrics.jsonl, only rank 0 writes
checkpoints, and both log the same losses as one process on the whole
global batch (rtol 1e-5). The mesh CLI tests run it as two processes at
mesh.model = 2 (n_data = 1), ME alone and VGGT with sequence_parallel and
--fsdp-teacher (the teacher sliced over the model group, its global
attention on the ring), against one process on the same batch (MESH_CASES
gives each tolerance). Each spawned run has its own timeout.
"""
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_step as mst
import test_torch_vggt_step as vst
from gd3d.core.config import DistillConfig as JDistillConfig
from gd3d.core.config import KeypointConfig as JKeypointConfig
from gd3d.core.config import LossWeights as JLossWeights
from gd3d.core.config import StudentConfig as JStudentConfig
from gd3d.distill import make_optimizer as jmake_optimizer
from gd3d.distill.mast3r_step import build_mast3r_train_step as jbuild_mast3r
from gd3d.distill.train_state import init_state
from gd3d.distill.vggt_step import build_vggt_train_step as jbuild_vggt
from gd3d.models.croco import CrocoConfig as JCrocoConfig
from gd3d.models.mast3r import Mast3rConfig as JMast3rConfig
from gd3d.models.student import Student as JStudent
from gd3d.models.student import merge_params
from gd3d.models.student import split_params as jsplit_params
from gd3d.models.vggt.config import VggtConfig as JVggtConfig
from gd3d.teachers.mast3r import Mast3rTeacher as JMast3rTeacher
from gd3d.teachers.vggt import VggtTeacher as JVggtTeacher
from gd3d.teachers.vggt import bias_params_for_live_keypoints as jbias_params
from gd3d_torch.convert import mast3r_state_dict, student_state_dict
from gd3d_torch.core.config import StudentConfig
from gd3d_torch.models.croco import CrocoConfig
from gd3d_torch.models.mast3r import Mast3rConfig
from gd3d_torch.teachers.mast3r import Mast3rTeacher
from torch_dist_worker import run_rank
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

GLOBAL_B = 4
SPAWN_TIMEOUT_S = 300
LOSSES = ("loss", "ap_loss", "depth_loss", "intra_depth_loss", "kl_loss")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _student_params(kw):
    params = mst._np(JStudent(JStudentConfig(**kw)).init(jax.random.key(0), img_size=32))
    rng = np.random.RandomState(1)
    for name in ("lora_b_q", "lora_b_v"):  # non-zero LoRA B: the LoRA path matters
        k = params["vit"]["blocks_adapt"]["attn"][name]["kernel"]
        params["vit"]["blocks_adapt"]["attn"][name]["kernel"] = (
            0.1 * rng.randn(*k.shape)).astype(np.float32)
    return params


def _gd3d_step(jcfg, skw, jte, jtp, params, batch, *extra):
    jst = JStudent(jcfg.student)
    trainable, frozen = jsplit_params(jax.tree_util.tree_map(jnp.asarray, params))
    tx = jmake_optimizer(jcfg.train)
    build = jbuild_mast3r if jcfg.teacher == "mast3r" else jbuild_vggt
    args = (False,) if jcfg.teacher == "mast3r" else ()
    step = jax.jit(build(jst, jte, jcfg, tx, *args))
    state, m = step(init_state(tx, trainable), frozen, jtp,
                    {k: jnp.asarray(v) for k, v in batch.items()}, *extra)
    return ({k: float(v) for k, v in m.items()},
            student_state_dict(mst._np(merge_params(state.trainable, frozen)),
                               StudentConfig(**skw)))


@pytest.fixture(scope="module")
def jobs():
    """The two paths' port inputs (state dicts, the global batch) and gd3d's
    one-device results on that batch."""
    out = {}
    # MASt3R: the teacher's DPT xyz rescaled on the global batch, written back
    params = _student_params(mst.STUDENT_KW)
    jte = JMast3rTeacher(JMast3rConfig(croco=JCrocoConfig(**mst.CROCO_KW), **mst.MAST3R_KW))
    tparams = mst._np(jte.init_params(jax.random.key(1), hw=(64, 96)))
    batch = mst._batch(B=GLOBAL_B)
    tcfg = Mast3rConfig(croco=CrocoConfig(**mst.CROCO_KW), **mst.MAST3R_KW)
    te = Mast3rTeacher(tcfg)
    te.model.load_state_dict(mast3r_state_dict(tparams, tcfg))
    te.face_forward(torch.from_numpy(batch["rgb_mast3r_1"]),
                    torch.from_numpy(batch["rgb_mast3r_2"]))
    for head, mod in (("head1", te.model.downstream_head1),
                      ("head2", te.model.downstream_head2)):
        conv = mod.dpt.head[4]
        tparams[head]["dpt"]["head_4"]["kernel"] = conv.weight.detach().permute(2, 3, 1, 0).numpy()
        tparams[head]["dpt"]["head_4"]["bias"] = conv.bias.detach().numpy().copy()
    jcfg = JDistillConfig(teacher="mast3r", dataset="scannetpp",
                          student=JStudentConfig(**mst.STUDENT_KW),
                          loss_weights=JLossWeights(1.0, 1.0, 1.0, 1.0),
                          keypoints=JKeypointConfig(nn_subsample=16))
    want = _gd3d_step(jcfg, mst.STUDENT_KW, jte, jax.tree_util.tree_map(jnp.asarray, tparams),
                      params, batch, 1.0)
    out["mast3r"] = (dict(
        kind="mast3r", student_kw=mst.STUDENT_KW, kp_kw=dict(nn_subsample=16),
        student_state=student_state_dict(params, StudentConfig(**mst.STUDENT_KW)),
        teacher_kw=dict(croco=mst.CROCO_KW, **mst.MAST3R_KW),
        teacher_state=te.model.state_dict(), batch=batch, temperature=1.0), want)

    # VGGT: both teachers pinned, the depth conv rescaled on the global batch
    params = _student_params(vst.STUDENT_KW)
    rng = np.random.RandomState(1)
    tparams = vst._np(JVggtTeacher(JVggtConfig(**vst.TINY_KW)).init_params(
        jax.random.key(1), hw=(28, 28)))
    tparams = jax.tree_util.tree_map(
        lambda x: (x + 0.02 * rng.randn(*x.shape)).astype(np.float32), tparams)
    r = np.random.RandomState(4)
    batch = {"rgb_1": r.rand(GLOBAL_B, 64, 64, 3).astype(np.float32),
             "rgb_2": r.rand(GLOBAL_B, 64, 64, 3).astype(np.float32),
             "rgb_vggt": r.rand(GLOBAL_B, 2, 28, 28, 3).astype(np.float32)}
    jte = JVggtTeacher(JVggtConfig(**vst.TINY_KW))
    te = vst._port_teacher(tparams)
    jtp = vst._spread_depth(te, jbias_params(jax.tree_util.tree_map(jnp.asarray, tparams),
                                             jte.cfg), batch["rgb_vggt"])
    key = jax.random.key(2)
    priority = np.stack([np.array(jax.random.uniform(k, (28 * 28,), jnp.float32))
                         for k in jax.random.split(key, GLOBAL_B)])
    jcfg = JDistillConfig(teacher="vggt", dataset="scannetpp",
                          student=JStudentConfig(**vst.STUDENT_KW),
                          loss_weights=JLossWeights(1.0, 1.0, 1.0, 1.0),
                          keypoints=JKeypointConfig(**vst.KP_KW))
    want = _gd3d_step(jcfg, vst.STUDENT_KW, jte, jtp, params, batch, 0.9, key)
    out["vggt"] = (dict(
        kind="vggt", student_kw=vst.STUDENT_KW, kp_kw=vst.KP_KW,
        student_state=student_state_dict(params, StudentConfig(**vst.STUDENT_KW)),
        teacher_kw=vst.TINY_KW, teacher_state=te.model.state_dict(), batch=batch,
        priority=priority, temperature=0.9), want)
    return out


def _spawn(world, jobs, out_dir):
    ctx = mp.start_processes(run_rank, args=(world, _free_port(), jobs, str(out_dir)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} gloo ranks did not finish in {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


def _assert_params(got, want):
    for name, p in got.items():
        diff = np.abs(p.numpy() - want[name].numpy())
        assert (diff > 1e-6).mean() <= 1e-3 and diff.max() <= 4e-5, (
            name, int((diff > 1e-6).sum()), diff.size, float(diff.max()))


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_steps_match_gd3d(jobs, tmp_path, world):
    run = {f"{kind}{'_fsdp' * fsdp}": dict(job, fsdp=fsdp)
           for kind, (job, _) in jobs.items() for fsdp in (False, True)}
    _spawn(world, run, tmp_path)
    for name, job in run.items():
        want_m, want_p = jobs[job["kind"]][1]
        ranks = [torch.load(tmp_path / f"{name}.rank{r}.pt", weights_only=False)
                 for r in range(world)]
        got_m = ranks[0]["metrics"]
        assert want_m["num_kps"] > 0 and want_m["depth_loss"] > 0
        assert got_m["num_kps"] == want_m["num_kps"], name
        for k in LOSSES:
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} {k}")
        for r in ranks:
            assert r["metrics"] == got_m, name  # every rank logs the global metrics
            _assert_params(r["trainable"], want_p)
            assert (r["dtensors"] > 0) == job["fsdp"] and (r["sharded_bytes"] > 0) == job["fsdp"]


def test_cli_multihost_fsdp_teacher(tmp_path):
    """--multihost --fsdp-teacher --tiny with 2 ranks against one process on
    the same global batch (--batch-per-device 2)."""
    base = [sys.executable, "-m", "gd3d_torch.cli.train", "--config",
            "finetune_timm_mast3r_scannetpp", "--tiny", "--dev", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2")
    procs = [subprocess.Popen(base + ["--multihost", "--fsdp-teacher", "--output",
                                      str(tmp_path / "dp")],
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    one = subprocess.Popen(base + ["--batch-per-device", "2", "--output", str(tmp_path / "one")],
                           env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    logs = []
    try:
        for p in procs + [one]:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs + [one]:
            p.kill()
    for p, log in zip(procs + [one], logs):
        assert p.returncode == 0, log[-3000:]
    assert "fsdp teacher:" in logs[0]

    def steps(path):
        import json
        recs = [json.loads(line) for line in Path(path).read_text().splitlines()]
        return [r for r in recs if "step" in r]

    dp0, dp1 = tmp_path / "dp", tmp_path / "dp" / "proc1"
    assert (dp1 / "metrics.jsonl").exists()
    assert (dp0 / "last").exists() and (dp0 / "ckpt_epoch_0001").exists()
    assert not list(dp1.glob("ckpt_*")) and not (dp1 / "last").exists()
    a, b, c = steps(dp0 / "metrics.jsonl"), steps(dp1 / "metrics.jsonl"), steps(
        tmp_path / "one" / "metrics.jsonl")
    assert len(a) == len(b) == len(c) == 2
    for ra, rb, rc in zip(a, b, c):
        for k in LOSSES + ("num_kps",):
            assert ra[k] == rb[k], k
            np.testing.assert_allclose(ra[k], rc[k], rtol=1e-5, atol=1e-7, err_msg=k)


MESH_CASES = {
    # ME: a 1 x 2 mesh; the student stays replicated, as in gd3d's CLI
    "me-model2": ("finetune_timm_me_objaverse", dict(model=2), [], 1e-5),
    # VGGT: the teacher sliced over the model group and FSDP-sharded over the
    # data group, its global attention on the ring over the model group. The
    # config runs the aggregator in bf16, and each rank rounds its partial
    # row-parallel product to bf16 before the all-reduce where one process
    # rounds the whole sum once: the bf16 tolerance (1e-2; 2.5e-3 measured
    # on the loss). With the teacher in fp32 the losses came out equal to
    # the last bit; tests/test_torch_sequence_parallel.py holds the TP x SP
    # teacher in fp32 to gd3d at 5e-4.
    "vggt-model2-sp": ("finetune_timm_vggt_scannetpp",
                       dict(model=2, sequence_parallel=True), ["--fsdp-teacher"], 1e-2),
}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_cli_mesh_options(tmp_path, case):
    """cli.train --tiny --synthetic --multihost at mesh.model = 2 (and
    sequence_parallel) as 2 gloo ranks: n_data = 1, so the global batch is
    one --batch-per-device, and both ranks log the losses of one process on
    that batch."""
    config, mesh, extra, rtol = MESH_CASES[case]
    base = ["--config", config, "--tiny", "--synthetic", "--steps-per-epoch", "2",
            "--epochs", "1", "--device", "cpu"]
    fields = [f"{k}={int(v)}" for k, v in mesh.items()]
    runner = [sys.executable, str(Path(__file__).with_name("torch_parallel_worker.py"))]
    env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2")
    procs = [subprocess.Popen(runner + fields + ["--"] + base + extra + [
        "--multihost", "--output", str(tmp_path / "mesh")], env=dict(env, RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    one = subprocess.Popen([sys.executable, "-m", "gd3d_torch.cli.train"] + base + [
        "--output", str(tmp_path / "one")], env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = []
    try:
        for p in procs + [one]:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs + [one]:
            p.kill()
    for p, log in zip(procs + [one], logs):
        assert p.returncode == 0, log[-3000:]
    if extra:
        assert "tensor parallel over 2" in logs[0], logs[0][-2000:]

    def steps(path):
        import json
        recs = [json.loads(line) for line in Path(path).read_text().splitlines()]
        return [r for r in recs if "step" in r]

    a, b = steps(tmp_path / "mesh" / "metrics.jsonl"), steps(
        tmp_path / "mesh" / "proc1" / "metrics.jsonl")
    c = steps(tmp_path / "one" / "metrics.jsonl")
    assert len(a) == len(b) == len(c) == 2
    for ra, rb, rc in zip(a, b, c):
        for k in rc:
            if k in ("time_s", "epoch", "step", "temperature"):
                continue
            assert ra[k] == rb[k], k  # the model group's ranks log one value
            np.testing.assert_allclose(ra[k], rc[k], rtol=rtol, atol=1e-7, err_msg=k)
    assert (tmp_path / "mesh" / "last").exists() and not (tmp_path / "mesh" / "proc1" / "last").exists()
