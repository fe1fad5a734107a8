"""Data parallelism over torch.distributed ranks (counterpart of
gd3d/core/mesh.py).

gd3d jits one step over a `data` mesh axis: every process builds the same
global batch, each device holds its rows, and the step computes exactly
what one device would on the whole batch. The port runs one process per
card (torchrun, or `--multihost` with RANK, WORLD_SIZE, MASTER_ADDR and
MASTER_PORT in the environment), and a step that sums to the same thing:

- `shard_batch` keeps this rank's rows of the global batch (axis 1 for a
  K-step group's (K, B, ...) stack);
- a batch-wide statistic inside the teacher is taken over the ranks: the
  MASt3R cost maps' per-layer floor is the global batch's minimum
  (`DataParallel.min`);
- each loss is computed as this rank's share of the global loss. A mean
  over a batch-wide count (valid keypoints, valid pairs, positives) divides
  this rank's sum by the count summed over the ranks (`DataParallel.count`);
  a mean over equal per-rank slices of the batch divides by the world size
  (`DataParallel.share`). The shares of all ranks sum to the one-device loss;
- the trainable gradients are summed over the ranks (one all-reduce of the
  flat gradient) before the clip and AdamW, so the clip sees the global
  gradient (distill/train_state.py);
- the metrics are summed over the ranks, so every rank logs the global
  values, as every gd3d process does.

Tensor and sequence parallelism (gd3d's `model` mesh axis and ring
attention) are not ported: ROADMAP.md, Queue 1.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class DataParallel:
    """This process's place among the data-parallel ranks. A world of 1
    (no process group) makes every method the identity."""

    rank: int = 0
    world: int = 1
    group: Optional[dist.ProcessGroup] = None
    owns_group: bool = False  # init_distributed made the default group

    def close(self) -> None:
        """Leave the default process group, where this object made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def count(self, local: torch.Tensor) -> torch.Tensor:
        """A batch-wide count: `local` summed over the ranks, with no
        gradient (counts of valid entries carry none)."""
        if self.world == 1:
            return local
        total = local.detach().clone()
        dist.all_reduce(total, group=self.group)
        return total

    def min(self, local: torch.Tensor) -> torch.Tensor:
        """An elementwise min over the ranks (no gradient): a batch-wide
        minimum, as the MASt3R teacher's per-layer cost-map floor."""
        if self.world == 1:
            return local
        total = local.detach().float()  # a copy; bf16 -> fp32 -> bf16 is exact
        dist.all_reduce(total, op=dist.ReduceOp.MIN, group=self.group)
        return total.to(local.dtype)

    def share(self, local_mean: torch.Tensor) -> torch.Tensor:
        """This rank's share of a mean over equal per-rank slices."""
        return local_mean if self.world == 1 else local_mean / self.world

    def sum_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each rank's shares summed: the global metrics, on every rank."""
        if self.world == 1:
            return metrics
        keys = list(metrics)
        flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        dist.all_reduce(flat, group=self.group)
        return {k: flat[i] for i, k in enumerate(keys)}

    def sum_grads_(self, params) -> None:
        """Sum the parameters' gradients over the ranks, in place, in one
        all-reduce of the flat gradient."""
        if self.world == 1:
            return
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def init_distributed(device: torch.device) -> DataParallel:
    """Join the process group the environment describes (torchrun's
    RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): NCCL for the card, gloo
    for the CPU. Every variable must be set: nothing is guessed."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost reads the process group from the environment "
                           f"(as torchrun sets it); missing {missing}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    owns = not dist.is_initialized()
    if owns:
        dist.init_process_group(
            backend="nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            rank=rank, world_size=world,
            device_id=device if device.type == "cuda" else None)
    return DataParallel(rank=rank, world=world, owns_group=owns)


def local_device(device: torch.device) -> torch.device:
    """The card of this process: LOCAL_RANK's (torchrun), else the
    RANK-th modulo the cards this host has; the CPU stays the CPU."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    return torch.device("cuda", local % torch.cuda.device_count())


def shard_batch(batch: Dict[str, np.ndarray], dp: DataParallel,
                axis: int = 0) -> Dict[str, np.ndarray]:
    """This rank's rows of a host batch that every rank built alike: the
    batch axis (`axis`; 1 for a K-step group's (K, B, ...) stack) is cut
    into `world` equal slices."""
    if dp.world == 1:
        return batch
    out = {}
    for k, v in batch.items():
        n = v.shape[axis]
        if n % dp.world:
            raise ValueError(f"batch key {k!r}: {n} rows on axis {axis} do not split over "
                             f"{dp.world} ranks")
        per = n // dp.world
        out[k] = np.take(v, np.arange(dp.rank * per, (dp.rank + 1) * per), axis=axis)
    return out
