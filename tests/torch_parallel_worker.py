"""One rank of the tensor- and sequence-parallel gloo runs of
tests/test_torch_tensor_parallel.py and tests/test_torch_sequence_parallel.py,
and the mesh CLI runs of tests/test_torch_distributed.py.

`run_rank` joins the process group, builds gd3d's data x model mesh for
each job (gd3d_torch/core/mesh.py::join_mesh) and saves each job's
results under <out_dir>/<name>.rank<r>.pt. It imports torch and
gd3d_torch only (no JAX): the spawned processes import this module, not the
test files.

    python tests/torch_parallel_worker.py model=2 sequence_parallel=1 -- <cli.train args>

runs gd3d_torch.cli.train.main with the named config's mesh fields replaced
(gd3d's CLI, like the port's, reads the mesh from the config and has no flag
for it).
"""
from __future__ import annotations

import dataclasses
import os
import socket
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(world: int, jobs: dict, out_dir) -> None:
    """Run `jobs` on `world` spawned gloo ranks, with a timeout."""
    ctx = mp.start_processes(run_rank, args=(world, free_port(), jobs, str(out_dir)),
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


def load(out_dir, name: str, world: int) -> list:
    return [torch.load(os.path.join(str(out_dir), f"{name}.rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _rows(dp, *arrays):
    from gd3d_torch.core.mesh import shard_batch

    rows = shard_batch({str(i): a for i, a in enumerate(arrays)}, dp)
    return [torch.from_numpy(rows[str(i)]) for i in range(len(arrays))]


def _n_sliced(module) -> int:
    from gd3d_torch.parallel.sharding import tp_slice

    return sum(tp_slice(p) is not None for p in module.parameters())


def me_job(job: dict, dp, out_dir: str) -> dict:
    """The ME step with the student sliced over the model group, its
    restart state saved (rank 0 writes) and restored into a fresh sliced
    student."""
    from gd3d_torch.cli.train import tiny_config
    from gd3d_torch.core.checkpoint import (
        restore_train_state, save_checkpoint, save_train_state, whole_tensors)
    from gd3d_torch.core.config import me_objaverse
    from gd3d_torch.core.mesh import shard_batch
    from gd3d_torch.distill.me import build_me_train_step
    from gd3d_torch.distill.train_state import make_optimizer
    from gd3d_torch.models.student import Student, split_params
    from gd3d_torch.parallel.sharding import shard_module

    cfg = tiny_config(me_objaverse())

    def student():
        st = Student(cfg.student, me_interp_quirk=True)
        st.load_state_dict(job["student_state"])
        whole = shard_module(st.vit, dp.model)
        tr, _ = split_params(st)
        return st, tr, make_optimizer(cfg.train, tr.values(), dp), whole

    st, tr, opt, whole = student()
    step = build_me_train_step(st, cfg, opt, device="cpu", dp=dp)
    batch = {k: torch.from_numpy(v) for k, v in shard_batch(job["batch"], dp).items()}
    metrics = step(batch)
    last = os.path.join(out_dir, "me_last")
    save_train_state(last, tr, opt, 0, write=dp.is_main)
    save_checkpoint(os.path.join(out_dir, "me_ckpt"), tr, cfg.student, write=dp.is_main)
    dist.barrier()
    st2, tr2, opt2, _ = student()
    restore_train_state(last, tr2, opt2)
    same = all(torch.equal(tr[k], tr2[k]) for k in tr) and all(
        torch.equal(opt.adamw.state[p][m], opt2.adamw.state[q][m])
        for p, q in zip(opt.params, opt2.params) for m in ("exp_avg", "exp_avg_sq"))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "trainable": whole_tensors(tr), "sliced": _n_sliced(st.vit), "whole": whole,
            "local_qkv": tuple(st.vit.blocks[0].attn.qkv.weight.shape),
            "resumed_equal": same}


def teacher_job(job: dict, dp, out_dir: str) -> dict:
    """A teacher's extract_features on this rank's rows, sliced over the
    model group (tp) and / or with ring attention over it (sp)."""
    from gd3d_torch.parallel.sharding import shard_module

    if job["kind"] == "mast3r":
        from gd3d_torch.models.croco import CrocoConfig
        from gd3d_torch.models.mast3r import Mast3rConfig
        from gd3d_torch.teachers.mast3r import Mast3rTeacher

        kw = dict(job["teacher_kw"])
        te = Mast3rTeacher(Mast3rConfig(croco=CrocoConfig(**kw.pop("croco")), **kw))
    else:
        from gd3d_torch.models.vggt.config import VggtConfig
        from gd3d_torch.teachers.vggt import VggtTeacher

        te = VggtTeacher(VggtConfig(**job["teacher_kw"]),
                         sp_group=dp.model if job.get("sp") else None)
    te.model.load_state_dict(job["teacher_state"])
    whole = shard_module(te.model, dp.model) if job.get("tp") else []
    imgs = _rows(dp, *job["images"])
    if job["kind"] == "mast3r":
        feats = te.extract_features(*imgs, job["temperature"], dp=dp)
    else:
        feats = te.extract_features(*imgs, job["temperature"])
    return {"features": {k: v.numpy() for k, v in feats.items()}, "data_rank": dp.rank,
            "n_data": dp.world, "sliced": _n_sliced(te.model), "whole": whole}


def ring_job(job: dict, dp, out_dir: str) -> dict:
    """ring_attention and allgather_kv_attention over the model group:
    the output and the gradients of sum(out * w), the backward twice."""
    from gd3d_torch.parallel.sequence import (
        GroupTransport, allgather_kv_attention, ring_attention)

    transport = GroupTransport(dp.model)
    out = {}
    for name, fn in (("ring", ring_attention), ("allgather", allgather_kv_attention)):
        q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in job["qkv"])
        o = fn(q, k, v, transport)
        loss = (o * torch.from_numpy(job["w"])).sum()
        grads = torch.autograd.grad(loss, (q, k, v), retain_graph=True)
        again = torch.autograd.grad(loss, (q, k, v))
        out[name] = {"out": o.detach().numpy(), "grads": [g.numpy() for g in grads],
                     "repeat": all(torch.equal(a, b) for a, b in zip(grads, again))}
    return out


JOBS = {"me": me_job, "teacher": teacher_job, "ring": ring_job}


def run_rank(rank: int, world: int, port: int, jobs: dict, out_dir: str) -> None:
    from gd3d_torch.core.mesh import join_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        # every rank makes every mesh's groups, in one order
        meshes = {m: join_mesh(rank, world, m) for m in sorted({j["n_model"] for j in
                                                                 jobs.values()})}
        for name, job in jobs.items():
            res = JOBS[job["job"]](job, meshes[job["n_model"]], out_dir)
            torch.save(res, os.path.join(out_dir, f"{name}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def cli_main(mesh: dict, argv: list) -> None:
    """gd3d_torch.cli.train.main with the config's mesh fields replaced; on
    the card it then prints this rank's peak memory as one JSON line."""
    import json

    from gd3d_torch.cli import train
    from gd3d_torch.core import config as cfglib

    named = cfglib.resolve_config
    cfglib.resolve_config = lambda name: named(name).replace(
        mesh=dataclasses.replace(named(name).mesh, **mesh))
    run = train.main(argv)
    if run.device.type == "cuda":
        print(json.dumps({"rank": run.dp.process, "device": str(run.device),
                          "peak_gib": torch.cuda.max_memory_allocated(run.device) / 2 ** 30}),
              flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    split = sys.argv.index("--")
    fields = dict(a.split("=", 1) for a in sys.argv[1:split])
    cli_main({k: (v == "1") if k in ("sequence_parallel", "fsdp_teacher") else int(v)
              for k, v in fields.items()}, sys.argv[split + 1:])
