"""Training CLI of the port (counterpart of gd3d/cli/train.py).

Usage:
  python -m gd3d_torch.cli.train --config finetune_timm_mast3r_scannetpp \\
      [--synthetic | --dev] [--epochs 500] [--steps-per-epoch 100] \\
      [--batch-per-device 1] [--multistep K] [--output outputs/run1] \\
      [--data-root data] [--workers N] [--student-ckpt timm.pth] \\
      [--teacher-ckpt mast3r.pth] [--resume <run>/last] [--device cuda] \\
      [--tensorboard] [--multihost [--fsdp-teacher]]
  torchrun --nproc-per-node 4 -m gd3d_torch.cli.train --multihost ...

gd3d's flags and behaviour: seed 42, the named configs and bundled YAMLs,
the --tiny overrides, the linear teacher-temperature schedule, K optimizer
steps per group with an epoch rounded up to a multiple of K with fresh
batches, metrics.jsonl with gd3d's record keys, the adapter checkpoint
(reference key layout) every ckpt_every_epochs and the restart state in
<out>/last, and --resume from it. It runs on the card unless --device says
otherwise; asking for cuda without one raises.

Data, as gd3d reads it: with neither --synthetic nor --dev, an existing
--data-root is read as real data (gd3d_torch/data/pipeline.py): the ME
config from <root>/objaverse_renderings, 10k.txt and obj_poses.npy; the
MASt3R and VGGT configs from <root>/scannetpp or the Objaverse renders. A
missing root gives a warning and synthetic data. Real-data images cross to
the device as uint8 and become float32 there. --workers N decodes in one
pool of N spawned processes for the run: --workers 0 is gd3d's sequential
stream (step s of epoch e equals gd3d's), N >= 1 seeds each step's datasets
from (seed + epoch, s), so that every N >= 1 gives the same batches.

--tensorboard writes every metric record as a TF2 scalar event under
<out>/tb at step epoch * steps + step, as gd3d does, with the port's own
event writer (gd3d_torch/core/tensorboard.py; no TensorFlow).

--multihost trains data-parallel over the torch.distributed ranks that the
environment describes (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as
torchrun sets them; NCCL on the card, gloo on the CPU), one process per
card: every rank builds the same global batch of world x --batch-per-device
pairs and keeps its rows, the losses are the global batch's and the adapter
gradients are summed over the ranks before the clip (gd3d_torch/core/mesh.py).
Each rank but 0 writes its metrics under <out>/proc<rank>; only rank 0
writes checkpoints; --resume reads the same file on every rank.
--fsdp-teacher (with --multihost) shards the frozen teacher's large weights
over the ranks with FSDP2 (gd3d_torch/parallel/fsdp.py). The config's
mesh.model > 1 (tensor parallelism) and mesh.sequence_parallel are not
ported and raise.

The eval epoch runs gd3d's callback (gd3d_torch/eval/callback.py):
PF-PASCAL PCK, TAP-Vid DAVIS tracking and OnePose-LowTexture pose where
their data exist, nothing where none do.

Without --teacher-ckpt the teacher has seeded random weights, and the
set-ups that keep its losses live on random weights
(Mast3rTeacher.face_forward; bias_params_for_live_keypoints and
VggtTeacher.spread_depth for VGGT) run once on the first batch of epoch 0.

The module imports torch inside its functions only: the data workers and
the eval epoch's JPEG decode processes are spawned, re-run this top level,
and so start without it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Dict, Iterator, Optional

import numpy as np

if TYPE_CHECKING:
    import torch

    from gd3d_torch.core import config as cfglib
    from gd3d_torch.core.mesh import DataParallel
    from gd3d_torch.core.tensorboard import EventWriter
    from gd3d_torch.data.pipeline import EpochSource
    from gd3d_torch.distill.train_state import ClippedAdamW
    from gd3d_torch.models.student import Student


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m gd3d_torch.cli.train")
    p.add_argument("--config", default="finetune_timm_me_objaverse",
                   help="named config (gd3d_torch/core/config.py NAMED_CONFIGS / "
                        "gd3d_torch/configs/<name>.yaml) or a path to a .yaml")
    p.add_argument("--data-root", default="data")
    p.add_argument("--output", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps-per-epoch", type=int, default=100)
    p.add_argument("--batch-per-device", type=int, default=1)
    p.add_argument("--dev", action="store_true",
                   help="2-batch smoke run on synthetic data, one epoch")
    p.add_argument("--student-ckpt", default=None,
                   help="torch state_dict (.pth) of the pretrained timm student")
    p.add_argument("--teacher-ckpt", default=None,
                   help="torch state_dict (.pth) of MASt3R / VGGT")
    p.add_argument("--synthetic", action="store_true",
                   help="force the synthetic data pipeline")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model + tiny shapes (CI smoke testing)")
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly detection, and stop at a non-finite metric")
    p.add_argument("--multistep", type=int, default=1, metavar="K",
                   help="MASt3R/VGGT: K optimizer steps per group over a (K, ...) "
                        "batch stack")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write the step metrics as TensorBoard scalars under <out>/tb")
    p.add_argument("--eval-every", type=int, default=None,
                   help="override cfg.train.eval_every_epochs (default 10)")
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="resume from a save_train_state file (e.g. <run>/last); "
                        "restores adapters + optimizer + epoch")
    p.add_argument("--workers", type=int, default=0,
                   help="real data: decode in N spawned processes (0: gd3d's sequential "
                        "stream in the prefetch thread)")
    p.add_argument("--fsdp-teacher", action="store_true",
                   help="with --multihost: shard the frozen teacher's weights over the "
                        "ranks (FSDP2, per block)")
    p.add_argument("--multihost", action="store_true",
                   help="train data-parallel over the torch.distributed ranks that RANK, "
                        "WORLD_SIZE, MASTER_ADDR and MASTER_PORT describe (torchrun)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    return p.parse_args(argv)


def check_flags(args) -> None:
    """Raise for what this port does not bring, before any work."""
    if args.workers < 0:
        raise ValueError("--workers must be at least 0")
    if args.fsdp_teacher and not args.multihost:
        raise ValueError("--fsdp-teacher shards over the ranks of --multihost: the port "
                         "runs one process per card (WORLD_SIZE=1 for one card)")
    if args.multistep < 1:
        raise ValueError("--multistep must be at least 1")


def load_torch_state(path: str) -> Dict[str, torch.Tensor]:
    """An upstream torch checkpoint's tensors, unwrapped from 'model' or
    'state_dict' where it nests them."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(state, dict) and "model" in state:
        state = state["model"]
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: v for k, v in state.items() if torch.is_tensor(v)}


def load_upstream(module: torch.nn.Module, path, may_miss=()) -> None:
    """Load an upstream state dict (a file, or its tensors by key) into a
    port module that keeps its key layout. Keys the module has and the state
    lacks raise, except those containing one of `may_miss`; keys the module
    lacks are reported."""
    state = path if isinstance(path, dict) else load_torch_state(path)
    name = "the state dict" if isinstance(path, dict) else path
    missing, unexpected = module.load_state_dict(state, strict=False)
    bad = [k for k in missing if not any(m in k for m in may_miss)]
    if bad:
        raise KeyError(f"{name} lacks {len(bad)} parameters of the model: {bad[:8]}")
    print(f"loaded {name}" + (f"; ignored {len(unexpected)} keys the model lacks: "
                              f"{unexpected[:8]}" if unexpected else ""))


@dataclasses.dataclass
class Run:
    """What a training run is made of; main() returns it."""

    args: argparse.Namespace
    cfg: cfglib.DistillConfig
    device: torch.device
    student: Student
    teacher: Optional[torch.nn.Module]
    trainable: Dict[str, torch.nn.Parameter]
    frozen: Dict[str, torch.nn.Parameter]
    optimizer: ClippedAdamW
    run_step: Callable
    source: SyntheticSource | EpochSource
    generator: Optional[torch.Generator]
    out_dir: Path
    epochs: int
    steps: int
    K: int
    dp: DataParallel
    tb: Optional[EventWriter] = None
    start_epoch: int = 0

    def close(self) -> None:
        """Stop the data workers, if any, close the event file, and leave
        the process group that --multihost joined."""
        self.source.close()
        if self.tb is not None:
            self.tb.close()
        self.dp.close()


class SyntheticSource:
    """gd3d's synthetic batches: step s of epoch e from fetch(e, s)."""

    def __init__(self, fetch: Callable[[int, int], Dict[str, np.ndarray]]):
        self.fetch = fetch

    def batches(self, epoch: int, n_steps: int) -> Iterator[Dict[str, np.ndarray]]:
        for step in range(n_steps):
            yield self.fetch(epoch, step)

    def close(self) -> None:
        pass


def tiny_config(cfg: cfglib.DistillConfig) -> cfglib.DistillConfig:
    from gd3d_torch.core import config as cfglib

    return cfg.replace(
        student=cfglib.StudentConfig(
            embed_dim=32, depth=4, num_heads=2, patch_size=16, pretrain_img_size=32,
            lora_start_block=2, use_adapters=False, target_res=64, depth_head_hidden=16),
        keypoints=cfglib.KeypointConfig(nn_subsample=16))


def build_teacher(cfg, args, device: torch.device, first_batch: Callable[[], Dict]):
    """The frozen teacher on `device`: upstream weights from --teacher-ckpt,
    or seeded random ones made on the device, with the live-loss set-ups
    run on the first batch."""
    import torch

    if cfg.teacher == "mast3r":
        from gd3d_torch.models.croco import CrocoConfig
        from gd3d_torch.models.mast3r import Mast3rConfig
        from gd3d_torch.teachers.mast3r import Mast3rTeacher

        tcfg = Mast3rConfig()
        if args.tiny:
            tcfg = Mast3rConfig(
                croco=CrocoConfig(patch_size=16, enc_embed_dim=32, enc_depth=2,
                                  enc_num_heads=2, dec_embed_dim=16, dec_depth=2,
                                  dec_num_heads=2),
                local_feat_dim=6, dpt_feature_dim=32, dpt_last_dim=16)
        with device:
            teacher = Mast3rTeacher(tcfg)
    else:
        from gd3d_torch.models.vggt.config import VggtConfig
        from gd3d_torch.teachers.vggt import VggtTeacher, bias_params_for_live_keypoints

        tcfg = VggtConfig()
        if args.tiny:
            tcfg = VggtConfig(
                img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=2,
                num_register_tokens=4, dino_depth=2, dino_num_heads=2,
                camera_trunk_depth=1, camera_iterations=2, dpt_features=8,
                dpt_out_channels=(8, 8, 8, 8), dpt_hooks=(0, 0, 1, 1), track_features=8,
                track_iters=2, track_stride=2, corr_levels=2, corr_radius=1,
                track_hidden_size=16)
        with device:
            teacher = VggtTeacher(tcfg)
    if args.teacher_ckpt:
        load_upstream(teacher.model, args.teacher_ckpt)
        return teacher
    from gd3d_torch.data.loader import DeviceCopier

    print(f"WARNING: no --teacher-ckpt; random {cfg.teacher} teacher weights, with the "
          f"live-loss set-ups on the first batch")
    teacher.init_params(torch.Generator(device=device).manual_seed(1))
    batch = DeviceCopier(device)(first_batch()).ready()
    if cfg.teacher == "mast3r":
        teacher.face_forward(batch["rgb_mast3r_1"], batch["rgb_mast3r_2"])
    else:
        bias_params_for_live_keypoints(teacher)
        teacher.spread_depth(batch["rgb_vggt"], dtype=cfg.teacher_dtype)
    return teacher


def setup(args) -> Run:
    import torch

    from gd3d_torch.core import config as cfglib
    from gd3d_torch.core.checkpoint import restore_train_state
    from gd3d_torch.core.mesh import DataParallel, init_distributed, local_device
    from gd3d_torch.core.tensorboard import EventWriter
    from gd3d_torch.data.pipeline import DataSpec, EpochSource
    from gd3d_torch.data.synthetic import synthetic_me_batch, synthetic_teacher_batch
    from gd3d_torch.distill.train_state import make_optimizer
    from gd3d_torch.models.student import Student, split_params
    from gd3d_torch.models.vit import init_params_

    check_flags(args)
    cfg = cfglib.resolve_config(args.config)
    if args.fsdp_teacher:
        cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, fsdp_teacher=True))
    if cfg.mesh.model > 1 or cfg.mesh.sequence_parallel:
        raise NotImplementedError(
            "mesh.model > 1 (tensor parallelism) and mesh.sequence_parallel are not ported "
            "(ROADMAP.md, Queue 1: they wait until one card's memory needs them)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asks for a card, and torch sees none "
                           "(pass --device cpu to train on the CPU)")
    dp = DataParallel()
    if args.multihost:
        device = local_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dp = init_distributed(device)
    if args.tiny:
        cfg = tiny_config(cfg)
    if args.epochs:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, max_epochs=args.epochs))
    if args.eval_every:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    eval_every_epochs=args.eval_every))
    real_data = not args.synthetic and not args.dev and Path(args.data_root).exists()
    if not args.synthetic and not args.dev and not real_data:
        print(f"WARNING: data root {args.data_root} missing; synthetic data")
    epochs = 1 if args.dev else cfg.train.max_epochs
    steps = 2 if args.dev else args.steps_per_epoch
    out_dir = Path(args.output or f"outputs/{args.config}/{time.strftime('%Y%m%d_%H%M%S')}")
    if not dp.is_main:  # per-rank metric streams; checkpoints are rank 0's
        out_dir = out_dir / f"proc{dp.rank}"
    out_dir.mkdir(parents=True, exist_ok=True)
    np.random.seed(cfg.train.seed)
    torch.manual_seed(cfg.train.seed)

    with device:
        student = Student(cfg.student, me_interp_quirk=(cfg.teacher == "me"))
    init_params_(student, torch.Generator(device=device).manual_seed(cfg.train.seed))
    if args.student_ckpt:
        load_upstream(student.vit, args.student_ckpt, may_miss=(".lora_", ".adapter."))
    trainable, frozen = split_params(student)
    optimizer = make_optimizer(cfg.train, trainable.values(), dp)
    batch_size = dp.world * args.batch_per_device  # the global batch
    K = args.multistep if cfg.teacher in ("mast3r", "vggt") else 1

    if real_data:
        source = EpochSource(DataSpec(cfg.teacher, cfg.dataset, cfg.train.seed,
                                      str(args.data_root), batch_size), args.workers)
    elif cfg.teacher == "me":
        img, kps = (64, 64) if args.tiny else (512, 3000)
        source = SyntheticSource(lambda epoch, step: synthetic_me_batch(
            seed=cfg.train.seed + epoch * 10000 + step, batch=batch_size, img=img, n_kps=kps))
    else:
        source = SyntheticSource(lambda epoch, step: synthetic_teacher_batch(
            cfg.teacher, cfg.dataset, batch_size, epoch * 10000 + step, tiny=args.tiny))

    def first_batch():
        return next(iter(source.batches(0, 1)))

    teacher, generator = None, None
    if cfg.teacher == "me":
        from gd3d_torch.distill.me import build_me_train_step

        step_fn = build_me_train_step(student, cfg, optimizer, device, dp)

        def run_step(batch, temperature):
            return step_fn(batch)
    elif cfg.teacher == "mast3r":
        from gd3d_torch.distill import mast3r_step

        teacher = build_teacher(cfg, args, device, first_batch)
        build = (mast3r_step.build_mast3r_train_multistep if K > 1
                 else mast3r_step.build_mast3r_train_step)
        run_step = build(student, teacher, cfg, optimizer, cfg.dataset == "objaverse", device,
                         dp)
    elif cfg.teacher == "vggt":
        from gd3d_torch.distill import vggt_step

        teacher = build_teacher(cfg, args, device, first_batch)
        generator = torch.Generator(device=device).manual_seed(cfg.train.seed)
        build = (vggt_step.build_vggt_train_multistep if K > 1
                 else vggt_step.build_vggt_train_step)
        run_step = build(student, teacher, cfg, optimizer, device, generator, dp)
    else:
        raise ValueError(f"teacher {cfg.teacher!r} has no train step")
    if cfg.mesh.fsdp_teacher and teacher is not None:
        from gd3d_torch.parallel.fsdp import shard_teacher

        sharded, total = shard_teacher(
            teacher, dp, device, torch.bfloat16 if cfg.teacher_dtype == "bfloat16" else None)
        print(f"fsdp teacher: {sharded / 2 ** 20:.0f} / {total / 2 ** 20:.0f} MiB sharded "
              f"over {dp.world} ranks")

    run = Run(args=args, cfg=cfg, device=device, student=student, teacher=teacher,
              trainable=trainable, frozen=frozen, optimizer=optimizer, run_step=run_step,
              source=source, generator=generator, out_dir=out_dir, epochs=epochs,
              steps=steps, K=K, dp=dp,
              tb=EventWriter(out_dir / "tb") if args.tensorboard else None)
    if args.resume:
        run.start_epoch = restore_train_state(args.resume, trainable, optimizer, generator)
        print(f"resumed from {args.resume}; continuing at epoch {run.start_epoch}")
    return run


def host_batches(run: Run, epoch: int):
    """(live step indices, numpy batch) for one epoch, K steps a group,
    stacked (K, ...) when K > 1, this rank's rows of the global batch. The
    epoch is rounded up to a multiple of K with fresh batches, never padded
    with a repeated one (each slice of a group runs a real update)."""
    from gd3d_torch.core.mesh import shard_batch

    K, steps = run.K, run.steps
    steps_run = -(-steps // K) * K
    if steps_run != steps and epoch == run.start_epoch:
        print(f"steps_per_epoch {steps} rounded up to {steps_run} "
              f"(multiple of --multistep {K})")
    batches = run.source.batches(epoch, steps_run)
    for step0 in range(0, steps_run, K):
        live = list(range(step0, step0 + K))
        raw = [next(batches) for _ in live]
        batch = {k: np.stack([b[k] for b in raw]) for k in raw[0]} if K > 1 else raw[0]
        yield live, shard_batch(batch, run.dp, axis=1 if K > 1 else 0)


def eval_epoch(run: Run, epoch: int) -> Dict[str, float]:
    """The in-training eval (gd3d_torch/eval/callback.py): every configured
    method whose data exist under --data-root, its CSVs under
    <output>/epoch_<N>/, its means as the summary; with no method's data on
    disk, nothing and an empty summary. JPEGs are decoded in one pool of
    min(8, CPUs) spawned processes for the epoch; --tiny evaluates at the
    tiny sizes (a 64^2 PCK canvas, 64 x 96 tracking frames) and decodes in
    this process."""
    from gd3d_torch.eval.callback import run_eval_callback
    from gd3d_torch.eval.images import eval_workers, make_pool

    sizes = dict(img_size=64, tracking_size=(64, 96)) if run.args.tiny else {}
    run.student.eval()
    try:
        with make_pool(eval_workers(run.args.tiny)) as pool:
            return run_eval_callback(run.student, run.cfg.evaluation_methods,
                                     run.args.data_root, str(run.out_dir), epoch + 1,
                                     pool=pool, **sizes)
    finally:
        run.student.train()


def train(run: Run) -> None:
    import torch

    from gd3d_torch.core.checkpoint import save_checkpoint, save_train_state
    from gd3d_torch.data.loader import DeviceCopier, PrefetchIterator
    from gd3d_torch.distill.mast3r_step import temperature_schedule

    args, cfg = run.args, run.cfg
    copier = DeviceCopier(run.device)

    def device_batches(epoch):
        # runs in the prefetch thread: the copy overlaps the previous step
        for live, batch in host_batches(run, epoch):
            yield live, copier(batch)

    print(f"device: {run.device}; output: {run.out_dir}")
    with open(run.out_dir / "metrics.jsonl", "a") as mf, \
            torch.autograd.set_detect_anomaly(args.debug_nans):
        for epoch in range(run.start_epoch, run.epochs):
            temp = temperature_schedule(cfg, epoch)
            epoch_metrics: Dict[str, list] = {}
            source = PrefetchIterator(device_batches(epoch), depth=2)
            epoch_t0 = time.perf_counter()
            for live, batch in source:
                t0 = time.perf_counter()
                metrics = run.run_step(batch.ready(), temp)
                stacked = {k: v.detach().reshape(-1).cpu().numpy() for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                if args.debug_nans:
                    bad = {k: v.tolist() for k, v in stacked.items() if not np.isfinite(v).all()}
                    if bad:
                        raise FloatingPointError(
                            f"non-finite metrics at epoch {epoch} steps {live}: {bad}")
                for i, step in enumerate(live):
                    rec = {k: float(v[i if v.size > 1 else 0]) for k, v in stacked.items()}
                    for k, v in rec.items():
                        epoch_metrics.setdefault(k, []).append(v)
                    rec.update(epoch=epoch, step=step, time_s=dt / len(live), temperature=temp)
                    mf.write(json.dumps(rec) + "\n")
                    if run.tb is not None:
                        run.tb.scalars(epoch * run.steps + step, rec)
                mf.flush()
                if run.tb is not None:
                    run.tb.flush()
                print(f"epoch {epoch} step {live[-1]}: loss={float(stacked['loss'][-1]):.4f} "
                      f"({dt:.2f}s / {len(live)} steps)")
            epoch_wall = time.perf_counter() - epoch_t0
            means = {f"epoch/{k}": float(np.mean(v)) for k, v in epoch_metrics.items()}
            means["epoch"] = epoch
            means["epoch/host_wait_s"] = round(source.wait_time, 4)
            means["epoch/wall_s"] = round(epoch_wall, 4)
            mf.write(json.dumps(means) + "\n")
            mf.flush()
            if run.dp.is_main and (epoch + 1) % cfg.train.ckpt_every_epochs == 0:
                save_checkpoint(str(run.out_dir / f"ckpt_epoch_{epoch + 1:04d}"),
                                run.trainable, cfg.student)
                save_train_state(str(run.out_dir / "last"), run.trainable, run.optimizer,
                                 epoch, run.generator)
            if (epoch + 1) % cfg.train.eval_every_epochs == 0:
                summary = eval_epoch(run, epoch)
                if summary:
                    summary["epoch"] = epoch
                    mf.write(json.dumps(summary) + "\n")
                    mf.flush()
    print("training finished")


def main(argv=None) -> Run:
    """Parse, set up, train, stop the data workers, and return the run."""
    run = setup(parse_args(argv))
    try:
        train(run)
    finally:
        run.close()
    return run


if __name__ == "__main__":
    main()
