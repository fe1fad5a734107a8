"""Multiview-equivariance (ME) fine-tune step, the teacher-free baseline
(counterpart of gd3d/distill/me.py).

Per pair of rendered views with ground-truth keypoints: the student's
descriptors at the keypoints (through the refine conv, with the ME 14-px
interpolation quirk when the student has it), then the smooth-AP loss
with positives closer than thresh3d_pos in 3D and negatives farther than
thres3d_neg; then clip + AdamW on the trainable parameters. Attention runs
through K1, and through K2 in the LoRA blocks' backward.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from gd3d_torch.core.config import DistillConfig
from gd3d_torch.core.mesh import DataParallel
from gd3d_torch.distill.train_state import ClippedAdamW
from gd3d_torch.models.student import Student
from gd3d_torch.ops.losses import ap_loss_me


def me_loss(student: Student, cfg: DistillConfig, batch: Dict[str, torch.Tensor],
            dp: Optional[DataParallel] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: rgb_1/rgb_2 (B, H, W, 3) in [0, 1]; pts2d_1/2 (B, N, 2) as
    (x, y) pixels; pts3d_1/2 (B, N, 3); optional valid_1/2 (B, N) bool.
    ap_pos_overflow > 0 says the static positive cap truncated positives.
    Under `dp` the mean runs over the global batch's positives and the
    results are this rank's shares (core/mesh.py)."""
    kcfg = cfg.keypoints
    desc_1 = student.get_feature(batch["rgb_1"], batch["pts2d_1"], normalize=True)
    desc_2 = student.get_feature(batch["rgb_2"], batch["pts2d_2"], normalize=True)
    loss, overflow = ap_loss_me(
        desc_1, desc_2, batch["pts3d_1"], batch["pts3d_2"],
        valid_1=batch.get("valid_1"), valid_2=batch.get("valid_2"),
        thresh3d_pos=kcfg.thresh3d_pos, thres3d_neg=kcfg.thres3d_neg,
        temp=kcfg.ap_sigmoid_temp, return_overflow=True, dp=dp)
    return loss, {"loss": loss, "ap_pos_overflow": overflow}


def build_me_train_step(
    student: Student,
    cfg: DistillConfig,
    optimizer: ClippedAdamW,
    device="cuda",
    dp: Optional[DataParallel] = None,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Put the student on `device` (the card unless the caller asks for
    another) and return step(batch) -> detached metrics (the global batch's
    under `dp`), which updates the trainable parameters in place."""
    student.to(torch.device(device))
    dp = dp or DataParallel()

    def train_step(batch):
        optimizer.zero_grad()
        loss, metrics = me_loss(student, cfg, batch, dp)
        loss.backward()
        optimizer.step()
        return dp.sum_metrics({k: v.detach() for k, v in metrics.items()})

    return train_step
