"""Image loading of the eval harness: JPEG decode and PIL-exact Lanczos
resizes (gd3d_torch/data/{jpeg,resample}.py) and cv2-exact PNG reads
(gd3d_torch/data/png.py), optionally spread over a process pool.

A spawned worker imports this module (numpy only) and re-runs the top level
of the parent's __main__ module. The eval and train CLI modules import torch
only inside their functions, so under `python -m gd3d_torch.cli.evaluate`
or `python -m gd3d_torch.cli.train` a worker starts without torch. Each CLI
makes one pool per run or eval epoch and passes it down.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import multiprocessing
import os
from typing import Callable, ContextManager, Optional, Sequence

import numpy as np

from gd3d_torch.data.jpeg import decode_jpeg
from gd3d_torch.data.png import imread
from gd3d_torch.data.resample import resize_lanczos


def resize_to_canvas(img: np.ndarray, target_res: int) -> np.ndarray:
    """A uint8 RGB image on a black target_res^2 canvas: the long side
    Lanczos-resized to target_res, the short side in proportion, centred
    (gd3d/eval/pck.py::resize_to_canvas, edge=False)."""
    h, w = img.shape[:2]
    canvas = np.zeros((target_res, target_res, 3), np.uint8)
    if h <= w:
        img = resize_lanczos(img, (target_res, int(np.around(target_res * h / w))))
        h2, w2 = img.shape[:2]
        canvas[(w2 - h2) // 2: (w2 + h2) // 2] = img
    else:
        img = resize_lanczos(img, (int(np.around(target_res * w / h)), target_res))
        h2, w2 = img.shape[:2]
        canvas[:, (h2 - w2) // 2: (h2 + w2) // 2] = img
    return canvas


def load_canvas(path: str, target_res: int) -> np.ndarray:
    """decode_jpeg, then resize_to_canvas (a PF-PASCAL image)."""
    return resize_to_canvas(decode_jpeg(path), target_res)


def load_frame(path: str, w: int, h: int) -> np.ndarray:
    """decode_jpeg, then the Lanczos resize to (w, h) (a DAVIS frame)."""
    return resize_lanczos(decode_jpeg(path), (w, h))


def load_png_rgb(path: str) -> np.ndarray:
    """cv2.imread(path)[..., ::-1].copy(): a PNG as 8-bit RGB (an OnePose
    frame)."""
    return imread(path)[..., ::-1].copy()


def make_pool(workers: int) -> ContextManager[Optional[concurrent.futures.Executor]]:
    """`with make_pool(n) as pool`: a pool of n spawned processes for
    map_images, shut down on exit, or None for n = 0 (decode in this
    process)."""
    if workers <= 0:
        return contextlib.nullcontext()
    return concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))


def eval_workers(tiny: bool) -> int:
    """The CLIs' decode processes: none at the tiny sizes, else min(8, CPUs)."""
    return 0 if tiny else min(8, os.cpu_count() or 1)


def map_images(fn: Callable, paths: Sequence[str], *args,
               pool: Optional[concurrent.futures.Executor] = None) -> list:
    """[fn(path, *args) for path in paths], in the pool when there is one."""
    if pool is None:
        return [fn(p, *args) for p in paths]
    futures = [pool.submit(fn, p, *args) for p in paths]
    return [f.result() for f in futures]
