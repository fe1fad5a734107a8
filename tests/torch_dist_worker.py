"""One rank of tests/test_torch_distributed.py's gloo runs: it joins the
process group, takes its rows of each job's global batch, runs one
data-parallel train step of the port (optionally with the FSDP-sharded
teacher) and saves its metrics and post-AdamW trainable tensors.

It imports torch and gd3d_torch only (no JAX): the spawned processes
import this module, not the test file.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def run_job(job: dict, dp) -> dict:
    from gd3d_torch.core.config import DistillConfig, KeypointConfig, LossWeights, StudentConfig
    from gd3d_torch.core.mesh import shard_batch
    from gd3d_torch.distill.mast3r_step import build_mast3r_train_step
    from gd3d_torch.distill.train_state import make_optimizer
    from gd3d_torch.distill.vggt_step import build_vggt_train_step
    from gd3d_torch.models.student import Student, split_params
    from gd3d_torch.parallel.fsdp import shard_teacher

    cfg = DistillConfig(teacher=job["kind"], dataset="scannetpp",
                        student=StudentConfig(**job["student_kw"]),
                        loss_weights=LossWeights(1.0, 1.0, 1.0, 1.0),
                        keypoints=KeypointConfig(**job["kp_kw"]))
    st = Student(cfg.student)
    st.load_state_dict(job["student_state"])
    tr, _ = split_params(st)
    opt = make_optimizer(cfg.train, tr.values(), dp)
    if job["kind"] == "mast3r":
        from gd3d_torch.models.croco import CrocoConfig
        from gd3d_torch.models.mast3r import Mast3rConfig
        from gd3d_torch.teachers.mast3r import Mast3rTeacher

        kw = dict(job["teacher_kw"])
        te = Mast3rTeacher(Mast3rConfig(croco=CrocoConfig(**kw.pop("croco")), **kw))
    else:
        from gd3d_torch.models.vggt.config import VggtConfig
        from gd3d_torch.teachers.vggt import VggtTeacher

        te = VggtTeacher(VggtConfig(**job["teacher_kw"]))
    te.model.load_state_dict(job["teacher_state"])
    sharded = 0
    if job["fsdp"]:
        # a small min_size, so that the tiny teacher's weights are sharded
        sharded, _ = shard_teacher(te, dp, torch.device("cpu"), min_size=256)
    batch = {k: torch.from_numpy(v) for k, v in shard_batch(job["batch"], dp).items()}
    if job["kind"] == "mast3r":
        step = build_mast3r_train_step(st, te, cfg, opt, has_depth=False, device="cpu", dp=dp)
        metrics = step(batch, job["temperature"])
    else:
        step = build_vggt_train_step(st, te, cfg, opt, device="cpu", dp=dp)
        rows = shard_batch({"p": job["priority"]}, dp)["p"]
        metrics = step(batch, job["temperature"], priority=torch.from_numpy(rows))
    dtensors = sum(type(p).__name__ == "DTensor" for p in te.model.parameters())
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "trainable": {k: p.detach().clone() for k, p in tr.items()},
            "sharded_bytes": sharded, "dtensors": dtensors}


def run_rank(rank: int, world: int, port: int, jobs: dict, out_dir: str) -> None:
    from gd3d_torch.core.mesh import DataParallel

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        dp = DataParallel(rank=rank, world=world)
        for name, job in jobs.items():
            torch.save(run_job(job, dp), os.path.join(out_dir, f"{name}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
