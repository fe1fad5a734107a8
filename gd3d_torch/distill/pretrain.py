"""DUSt3R / MASt3R and CroCo pretraining steps (counterpart of
gd3d/distill/pretrain.py).

`pretrain_loss` is ConfLoss(MASt3R Regr3D(L21, '?avg_dis'), alpha 0.2) +
0.075 ConfMatchingLoss(InfoNCE 'proper', alpha 10, conf mean) over the
[img1 -> view1, img2 -> view2] half of the model's symmetrised 2B batch;
the CroCo step is MaskedMSE over the masked patches. Both steps clip the
global gradient norm and take one AdamW step: optax.chain(
clip_by_global_norm(clip), adamw(lr)) with optax's defaults (b1 0.9, b2
0.999, eps 1e-8, weight decay 1e-4 on every parameter), as gd3d's CLI
builds it. The step runs with TF32 off, so a card step computes what the
CPU's does.

Under data parallelism (core/mesh.py, one process a card) each rank holds
its rows of the global batch and computes its share of every masked mean
(its sum over the count summed over the ranks), the gradients are summed
before the clip, and the metrics are summed, so every rank steps and logs
what one process would on the whole batch.

Batch layout (tensors on the model's device, B pairs): img1, img2
(B, H, W, 3) in [-1, 1]; gt1 / gt2 with camera_pose (B, 4, 4) cam2world,
pts3d (B, H, W, 3) world, valid_mask and sky_mask (B, H, W), corres
(B, N, 2) integer (x, y); gt1 also valid_corres (B, N) and
is_metric_scale (B,); the CroCo batch has mask1 (B, N) instead of the gts.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from gd3d_torch.core.mesh import DataParallel
from gd3d_torch.models.croco_pretrain import masked_mse
from gd3d_torch.ops.matching_loss import conf_matching_loss
from gd3d_torch.ops.regr3d import mast3r_conf_regr3d_loss
from gd3d_torch.stereoflow import AdamW
from gd3d_torch.teachers.mast3r import no_tf32


def _count_fn(dp: Optional[DataParallel]):
    return dp.count if dp is not None and dp.world > 1 else None


def pretrain_loss(model: nn.Module, batch: Dict[str, Any], alpha_regr: float = 0.2,
                  alpha_match: float = 10.0, matching_weight: float = 0.075,
                  norm_mode: str = "?avg_dis", infonce_mode: str = "proper",
                  infonce_temperature: float = 0.07, sky_loss_value: float = 2.0,
                  count=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The two-view pretraining loss and its details. `count` maps a
    count of valid entries to the global batch's (data parallelism)."""
    B = batch["img1"].shape[0]
    out = model(batch["img1"], batch["img2"])
    # the direction where view1 = img1 is the second half of the 2B stack
    res1 = {k: v[B:] for k, v in out["res1"].items()}
    res2 = {k: v[B:] for k, v in out["res2"].items() if k != "tgt_attn_map"}

    gt1, gt2 = dict(batch["gt1"]), dict(batch["gt2"])
    H, W = batch["img1"].shape[1:3]
    dev = batch["img1"].device
    for g in (gt1, gt2):
        g.setdefault("sky_mask", torch.zeros((B, H, W), dtype=torch.bool, device=dev))
    gt1.setdefault("is_metric_scale", torch.zeros((B,), dtype=torch.bool, device=dev))

    regr, regr_details = mast3r_conf_regr3d_loss(
        gt1, gt2, res1, res2, alpha=alpha_regr, norm_mode=norm_mode,
        sky_loss_value=sky_loss_value, count=count)
    match, match_details = conf_matching_loss(
        gt1, gt2, res1, res2, alpha=alpha_match, confmode="mean",
        temperature=infonce_temperature, mode=infonce_mode, count=count)
    loss = regr + matching_weight * match
    details = {"loss": loss, "regr3d": regr, "matching": match}
    details.update({f"regr/{k}": v for k, v in regr_details.items()})
    details.update({f"match/{k}": v for k, v in match_details.items()})
    return loss, details


class PretrainOptimizer:
    """clip_by_global_norm(grad_clip) then optax.adamw(lr) with optax's
    defaults, over every parameter of `model`, in place. `lr(count)` is the
    schedule. A parameter the loss does not reach gets a zero gradient and
    still decays, as under optax."""

    def __init__(self, model: nn.Module, lr: Callable[[int], float], grad_clip: float = 1.0,
                 dp: Optional[DataParallel] = None):
        self.params = dict(model.named_parameters())
        self.adamw = AdamW(self.params.items(), lr, b1=0.9, b2=0.999, eps=1e-8,
                           weight_decay=1e-4)
        self.grad_clip = grad_clip
        self.dp = dp

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        ps = list(self.params.values())
        for p in ps:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.dp is not None:
            self.dp.sum_grads_(ps)
        # optax's global norm; above the limit each leaf becomes
        # (g / norm) * limit, on the device with no host sync
        norm = torch.sqrt(sum(torch.sum(p.grad * p.grad) for p in ps))
        keep = norm < self.grad_clip
        for p in ps:
            p.grad.copy_(torch.where(keep, p.grad, p.grad / norm * self.grad_clip))
        self.adamw.step()

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The moments by parameter name ('mu/...', 'nu/...') and the step
        count."""
        out = {f"mu/{k}": v for k, v in self.adamw.mu.items()}
        out.update({f"nu/{k}": v for k, v in self.adamw.nu.items()})
        out["count"] = torch.tensor(self.adamw.count)
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for k in self.params:
            self.adamw.mu[k].copy_(torch.as_tensor(state[f"mu/{k}"]))
            self.adamw.nu[k].copy_(torch.as_tensor(state[f"nu/{k}"]))
        self.adamw.count = int(state["count"])


def _finish(metrics: Dict[str, torch.Tensor], dp: Optional[DataParallel]):
    metrics = {k: v.detach() for k, v in metrics.items()}
    return dp.sum_metrics(metrics) if dp is not None else metrics


def build_croco_pretrain_step(model: nn.Module, optimizer: PretrainOptimizer,
                              norm_pix_loss: bool = False,
                              dp: Optional[DataParallel] = None):
    """step(batch) -> {"loss"}: the CroCo pretraining forward, backward and
    update; `model` is a models.croco_pretrain.CrocoPretrain."""
    count = _count_fn(dp)

    def step(batch):
        with no_tf32():
            optimizer.zero_grad()
            pred, target = model(batch["img1"], batch["img2"], batch["mask1"])
            loss = masked_mse(pred, batch["mask1"], target, norm_pix_loss=norm_pix_loss,
                              count=count)
            loss.backward()
            optimizer.step()
        return _finish({"loss": loss}, dp)

    return step


def build_mast3r_pretrain_step(model: nn.Module, optimizer: PretrainOptimizer,
                               loss_kwargs: Optional[Dict[str, Any]] = None,
                               dp: Optional[DataParallel] = None):
    """step(batch) -> the loss and its details: the MASt3R pretraining
    forward, backward and update; `model` is a models.mast3r.Mast3r."""
    kw = dict(loss_kwargs or {})
    count = _count_fn(dp)

    def step(batch):
        with no_tf32():
            optimizer.zero_grad()
            loss, details = pretrain_loss(model, batch, count=count, **kw)
            loss.backward()
            optimizer.step()
        return _finish(details, dp)

    return step
