"""Host data pipeline: batching, padding, background prefetch and the
host-to-device copy (counterpart of gd3d/data/loader.py; pad_keypoints and
collate live in data/pipeline.py, which worker processes import without
torch).

The prefetch thread assembles fixed-shape numpy batches and, for a CUDA
device, copies them to the card itself: pinned host tensors, then
`.to(device, non_blocking=True)` on a side stream of the thread's own. The
copy is ordered before the step by an event recorded after it, on which
the consumer's stream waits (`DeviceBatch.ready`); the tensors are marked
as used on that stream, so the allocator does not hand their memory to
the next copy while the step still reads them.

Real-data images cross as uint8 (data/pipeline.py::pack_u8) and become
float32 on the device with gd3d's formulas (gd3d/cli/train.py::_unpack_u8):
u8 / 127.5 - 1 for rgb_mast3r*, u8 / 255 for the other rgb* keys.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from gd3d_torch.data.pipeline import collate, pad_keypoints  # noqa: F401  (gd3d's loader API)


class PrefetchIterator:
    """Wrap any iterator with a daemon producer thread and a bounded queue.
    `wait_time` accumulates the seconds the consumer spent blocked on the
    queue (the host-bound share of the step loop); an exception in the
    producer is raised on the consumer's side."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = object()
        self._err: Optional[BaseException] = None
        self.wait_time = 0.0

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                self._q.put(self._stop)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self._q.get()
        self.wait_time += time.perf_counter() - t0
        if item is self._stop:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class PrefetchLoader:
    """Iterate batches of `batch_size` random samples with a prefetch
    thread (one process: the seed is used as given)."""

    def __init__(self, dataset, batch_size: int = 1, steps_per_epoch: Optional[int] = None,
                 prefetch: int = 2, transform: Optional[Callable[[Dict], Dict]] = None,
                 seed: int = 42):
        self.dataset = dataset
        self.batch_size = batch_size
        self.steps = steps_per_epoch or (len(dataset) // batch_size)
        self.prefetch = prefetch
        self.transform = transform
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.steps

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(self.steps):
            idxs = [int(self.rng.randint(len(self.dataset))) for _ in range(self.batch_size)]
            samples = [self.dataset[i] for i in idxs]
            if self.transform:
                samples = [self.transform(s) for s in samples]
            yield collate(samples)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return PrefetchIterator(self._batches(), depth=self.prefetch)


class DeviceBatch(dict):
    """A batch of device tensors (name -> tensor) and the event that ends
    its host-to-device copy (None on the CPU). Call ready() before the step
    reads it."""

    event: Optional[torch.cuda.Event] = None

    def ready(self) -> "DeviceBatch":
        if self.event is not None:
            stream = torch.cuda.current_stream(self.event.device)
            stream.wait_event(self.event)
            for t in self.values():
                t.record_stream(stream)
            self.event = None
        return self


class DeviceCopier:
    """Copies numpy batches to `device` from the thread that calls it: on
    the CPU a zero-copy torch.from_numpy; on a CUDA device pinned tensors
    copied on this copier's own stream, with an event recorded after them.
    uint8 images become float32 there (unpack_u8)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, batch: Dict[str, np.ndarray]) -> DeviceBatch:
        if self.stream is None:
            return DeviceBatch({k: unpack_u8(k, torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device)) for k, v in batch.items()})
        with torch.cuda.stream(self.stream):
            out = DeviceBatch({
                k: unpack_u8(k, torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
                    self.device, non_blocking=True))
                for k, v in batch.items()})
            out.event = torch.cuda.Event()
            out.event.record(self.stream)
        return out


def unpack_u8(key: str, t: torch.Tensor) -> torch.Tensor:
    """A uint8 image tensor as float32 with gd3d's formulas (see the module
    docstring); any other tensor as it is."""
    if t.dtype != torch.uint8 or not key.startswith("rgb"):
        return t
    if key.startswith("rgb_mast3r"):
        return t.to(torch.float32) / 127.5 - 1.0
    return t.to(torch.float32) / 255.0
