"""Optimizer for adapter-only fine-tuning (counterpart of
gd3d/distill/train_state.py::make_optimizer).

Clip the global gradient norm at grad_clip, then AdamW, over the trainable
parameters only: the optax chain clip_by_global_norm + adamw that gd3d
builds (tests/test_optimizer_parity.py shows torch's AdamW tracks it).
With grad_accum = k > 1 it follows optax.MultiSteps(every_k_schedule=k):
each call folds its gradients into a running mean (Welford's update, as
optax), and every k-th call clips and steps AdamW once on that mean; the
k - 1 calls in between leave the parameters and AdamW's step counts as
they are. Under data parallelism (`dp`, core/mesh.py) each call first sums
the gradients over the data group, in one all-reduce, so the clip sees the
global batch's gradient, as in gd3d's step over its data axis. Under
tensor parallelism (parallel/sharding.py) the clip sees gd3d's global norm:
the squares of the sliced trainables' gradients (the lora_b_* slices)
summed over the model group, the replicated ones counted once.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Iterable, Optional

import torch

from gd3d_torch.core.config import TrainConfig
from gd3d_torch.parallel.sharding import clip_grad_norm_

if TYPE_CHECKING:
    from gd3d_torch.core.mesh import DataParallel


class ClippedAdamW:
    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: TrainConfig,
                 dp: Optional[DataParallel] = None):
        self.params = list(params)
        self.cfg = cfg
        self.dp = dp
        self.adamw = torch.optim.AdamW(
            self.params, lr=cfg.lr, betas=(cfg.adam_b1, cfg.adam_b2),
            eps=cfg.adam_eps, weight_decay=cfg.weight_decay)
        self.calls = 0      # step() calls: gd3d's TrainState.step
        self.mini_step = 0  # calls folded into acc since the last update
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if cfg.grad_accum > 1 else [])

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        # a trainable leaf the loss does not reach still decays, as under
        # optax, so it gets a zero gradient rather than being skipped
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.dp is not None:
            self.dp.sum_grads_(self.params)
        self.calls += 1
        k = self.cfg.grad_accum
        if k > 1:
            n = self.mini_step
            with torch.no_grad():
                for a, p in zip(self.acc, self.params):
                    a.add_((p.grad - a) / (n + 1))
            self.mini_step = (n + 1) % k
            if self.mini_step:
                return
            for a, p in zip(self.acc, self.params):
                p.grad = a.clone()
                a.zero_()
        clip_grad_norm_(self.params, self.cfg.grad_clip)
        self.adamw.step()

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "calls": self.calls,
                "mini_step": self.mini_step, "acc": [a.detach().clone() for a in self.acc]}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.calls, self.mini_step = int(state["calls"]), int(state["mini_step"])
        with torch.no_grad():
            for a, saved in zip(self.acc, state["acc"]):
                a.copy_(saved)


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.nn.Parameter],
                   dp: Optional[DataParallel] = None) -> ClippedAdamW:
    return ClippedAdamW(params, cfg, dp)
