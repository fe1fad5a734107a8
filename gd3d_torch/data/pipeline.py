"""Real-data batches of the training CLI (counterpart of the data half of
gd3d/cli/train.py: _make_epoch_dataset, _sample_transform, the sequential
fetch and the grain loader), numpy only, so that spawned worker processes
import neither torch nor the models.

  - `make_epoch_dataset`: gd3d's per-epoch datasets, seeded seed + epoch:
    ME on <root>/objaverse_renderings with the object names of
    <root>/10k.txt (the first 10 000) and the poses of <root>/obj_poses.npy;
    MASt3R and VGGT on <root>/scannetpp or on the Objaverse renders.
  - `sample_transform`: gd3d's per-sample transform (ME: keypoints padded
    to 3000 with a validity mask, the mask and rotation dropped; else
    strings and None dropped), then the images packed to uint8 as gd3d
    packs a real-data batch before it crosses to the device: rgb_mast3r*
    as round((v + 1) * 127.5), the other rgb* as round(v * 255). The
    device turns them back into float32 (data/loader.py::DeviceCopier).
  - `EpochSource`: the batches of an epoch in step order. With no workers
    it is gd3d's sequential stream: one dataset an epoch, step s the
    samples (s * B + i) % len of that one stream, so step s of epoch e
    equals gd3d's. With N >= 1 workers (one pool of spawned processes a
    run, `StepPool`), the samples of step s come from the epoch's datasets
    with their RandomStates seeded from (seed + epoch, s) instead; a step's
    batch is then the same for every N >= 1, and no two workers repeat a
    draw. (gd3d's grain loader copies one RandomState into every worker;
    that stream depends on the worker count and repeats draws across
    workers.) Batches arrive in step order, a worker's error is raised in
    the caller, and an epoch is never shortened without one.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import multiprocessing
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np


def pad_keypoints(kps: np.ndarray, pts3d: np.ndarray, capacity: int,
                  valid: Optional[np.ndarray] = None):
    """Pad (N, 2)/(N, 3) keypoint arrays to `capacity` with a validity mask,
    or truncate them to it."""
    n = kps.shape[0]
    if valid is None:
        valid = np.ones((n,), bool)
    if n >= capacity:
        return (kps[:capacity].astype(np.float32), pts3d[:capacity].astype(np.float32),
                valid[:capacity])
    pad = capacity - n
    # cast before concatenating, so both branches give float32
    return (
        np.concatenate([kps.astype(np.float32), np.zeros((pad, kps.shape[1]), np.float32)]),
        np.concatenate([pts3d.astype(np.float32),
                        np.zeros((pad, pts3d.shape[1]), np.float32)]),
        np.concatenate([valid.astype(bool), np.zeros((pad,), bool)]),
    )


def collate(samples: Sequence[Dict]) -> Dict[str, np.ndarray]:
    """Stack a list of dict samples into batched numpy arrays (string and
    None values dropped)."""
    out = {}
    for k, v in samples[0].items():
        if v is None or isinstance(v, str):
            continue
        out[k] = np.stack([np.asarray(s[k]) for s in samples])
    return out


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """What a worker needs to make an epoch's datasets and batches."""

    teacher: str
    dataset: str
    seed: int
    data_root: str
    batch_size: int


def make_epoch_dataset(spec: DataSpec, epoch: int):
    """gd3d's per-epoch-seeded map-style dataset for the config."""
    root = Path(spec.data_root)
    seed = spec.seed + epoch
    if spec.teacher == "me":
        from gd3d_torch.data.objaverse import AugmentedCorrDataset, ObjaverseCorrDataset

        names = (root / "10k.txt").read_text().splitlines()
        poses = np.load(root / "obj_poses.npy")
        return AugmentedCorrDataset(
            ObjaverseCorrDataset(str(root / "objaverse_renderings"), names[:10_000], poses,
                                 seed=seed), seed=seed)
    if spec.dataset == "scannetpp":
        from gd3d_torch.data.scannetpp import AugmentedScanNetPPDataset, ScanNetPPDataset

        return AugmentedScanNetPPDataset(
            ScanNetPPDataset(str(root / "scannetpp"), vggt=(spec.teacher == "vggt"), seed=seed),
            seed=seed)
    from gd3d_torch.data.objaverse import AugmentedObjaverseDataset, ObjaverseMASt3RDataset

    names = (root / "10k.txt").read_text().splitlines()
    return AugmentedObjaverseDataset(
        ObjaverseMASt3RDataset(str(root / "objaverse_renderings"), names[:10_000], seed=seed,
                               vggt=(spec.teacher == "vggt")), seed=seed)


def pack_u8(sample: Dict) -> Dict:
    """The images of a real-data sample as gd3d's _pack_u8 packs them."""
    out = {}
    for k, v in sample.items():
        if k.startswith("rgb_mast3r"):  # [-1, 1] = u8 / 127.5 - 1
            out[k] = np.round((v + 1.0) * 127.5).astype(np.uint8)
        elif k.startswith("rgb"):  # [0, 1] = u8 / 255
            out[k] = np.round(np.asarray(v) * 255.0).astype(np.uint8)
        else:
            out[k] = v
    return out


def sample_transform(teacher: str) -> Callable[[Dict], Dict]:
    """gd3d's _sample_transform, then pack_u8."""
    if teacher == "me":
        def tr(s):
            s = dict(s)
            for v in ("1", "2"):
                kp, p3, val = pad_keypoints(s[f"pts2d_{v}"], s[f"pts3d_{v}"], 3000,
                                            s.get(f"valid_{v}"))
                s[f"pts2d_{v}"], s[f"pts3d_{v}"], s[f"valid_{v}"] = kp, p3, val
                s.pop(f"mask_{v}", None)
                s.pop(f"rot_{v}", None)
            return pack_u8(s)

        return tr

    def tr(s):
        return pack_u8({k: v for k, v in s.items() if v is not None and not isinstance(v, str)})

    return tr


def step_batch(spec: DataSpec, ds, step: int, transform: Callable[[Dict], Dict]) -> Dict:
    """Step `step`'s collated batch from the dataset `ds` as it stands."""
    b = spec.batch_size
    return collate([transform(ds[(step * b + i) % len(ds)]) for i in range(b)])


def reseed(ds, seed) -> None:
    """Give a dataset and every dataset it wraps a RandomState from `seed`."""
    while ds is not None:
        ds.rng = np.random.RandomState(seed)
        ds = getattr(ds, "base", None)


# One worker process's state: the spec (set by the pool's initializer) and
# the dataset of the epoch it last served.
_WORKER: Dict = {}


def _init_worker(spec: DataSpec) -> None:
    _WORKER.clear()
    _WORKER["spec"] = spec


def _worker_step(epoch: int, step: int) -> Dict[str, np.ndarray]:
    spec = _WORKER["spec"]
    if _WORKER.get("epoch") != epoch:
        _WORKER["ds"] = make_epoch_dataset(spec, epoch)
        _WORKER["epoch"] = epoch
    ds = _WORKER["ds"]
    reseed(ds, [spec.seed + epoch, step])
    return step_batch(spec, ds, step, sample_transform(spec.teacher))


class StepPool:
    """One pool of `workers` spawned processes for a run; `batches(epoch,
    n)` yields steps 0..n-1 of an epoch in order, at most 2 * workers of
    them in flight."""

    def __init__(self, workers: int, spec: DataSpec):
        self.workers = workers
        self.executor = concurrent.futures.ProcessPoolExecutor(
            max_workers=workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_init_worker, initargs=(spec,))

    def batches(self, epoch: int, n_steps: int) -> Iterator[Dict[str, np.ndarray]]:
        pending = []
        submitted = 0
        try:
            for _ in range(n_steps):
                while submitted < n_steps and len(pending) < 2 * self.workers:
                    pending.append(self.executor.submit(_worker_step, epoch, submitted))
                    submitted += 1
                yield pending.pop(0).result()
        finally:
            for f in pending:
                f.cancel()

    def close(self) -> None:
        self.executor.shutdown(wait=True, cancel_futures=True)


class EpochSource:
    """The real-data batches of each epoch (see the module docstring)."""

    def __init__(self, spec: DataSpec, workers: int = 0):
        self.spec = spec
        self.pool = None
        if workers > 0:
            if spec.dataset == "scannetpp" and spec.teacher != "me":
                make_epoch_dataset(spec, 0)  # mines and writes the pair cache here, once
            self.pool = StepPool(workers, spec)

    def batches(self, epoch: int, n_steps: int) -> Iterator[Dict[str, np.ndarray]]:
        if self.pool is not None:
            yield from self.pool.batches(epoch, n_steps)
            return
        ds = make_epoch_dataset(self.spec, epoch)
        tr = sample_transform(self.spec.teacher)
        for step in range(n_steps):
            yield step_batch(self.spec, ds, step, tr)

    def close(self) -> None:
        if self.pool is not None:
            self.pool.close()
