"""Optimizer for adapter-only fine-tuning (counterpart of
gd3d/distill/train_state.py::make_optimizer).

Clip the global gradient norm at grad_clip, then AdamW, over the trainable
parameters only: the optax chain clip_by_global_norm + adamw that gd3d
builds (tests/test_optimizer_parity.py shows torch's AdamW tracks it).
"""
from __future__ import annotations

from typing import Iterable

import torch

from gd3d_torch.core.config import TrainConfig


class ClippedAdamW:
    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: TrainConfig):
        if cfg.grad_accum > 1:
            raise NotImplementedError("gradient accumulation is not ported yet")
        self.params = list(params)
        self.cfg = cfg
        self.adamw = torch.optim.AdamW(
            self.params, lr=cfg.lr, betas=(cfg.adam_b1, cfg.adam_b2),
            eps=cfg.adam_eps, weight_decay=cfg.weight_decay)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        # a trainable leaf the loss does not reach still decays, as under
        # optax, so it gets a zero gradient rather than being skipped
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch.nn.utils.clip_grad_norm_(self.params, self.cfg.grad_clip)
        self.adamw.step()


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.nn.Parameter]) -> ClippedAdamW:
    return ClippedAdamW(params, cfg)
