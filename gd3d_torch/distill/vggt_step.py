"""VGGT -> CLIP-ViT distillation train step (counterpart of
gd3d/distill/vggt_step.py).

One step: the frozen VGGT teacher (aggregator in bf16 under the
finetune_timm_vggt_scannetpp config, heads fp32) gives cost volumes,
cameras, depth maps and world point maps; keypoints come from co-view
masks, NMS on view-1 confidence and the track head's view-2
correspondences; one fused student forward over both views plus a cost
pass at the teacher's /14 grid; four losses (depth L1, intra-depth ranking
through K4, cost-volume KL through K3, smooth-AP with the VGGT module's
legacy rpos1), then clip + AdamW on the trainable parameters. Attention
runs through K1 (and K2 in the student's backward), RoPE through K5.

build_vggt_train_multistep runs K steps over a (K, ...) batch stack, as
build_mast3r_train_multistep does; the NMS draws come from the one
generator in the order K single steps draw them.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from gd3d_torch.core.config import DistillConfig
from gd3d_torch.distill.group import stack_metrics, unstack
from gd3d_torch.distill.train_state import ClippedAdamW
from gd3d_torch.kernels.cost_kl import masked_softmax_kl_rows
from gd3d_torch.models.student import Student, resize_bilinear
from gd3d_torch.ops.basic import l2_normalize
from gd3d_torch.ops.geometry import extract_kp_depth
from gd3d_torch.ops.losses import _masked_mean, ap_loss_paired
from gd3d_torch.ops.masks import masked_patch_cost
from gd3d_torch.teachers.vggt import VggtTeacher


def _nearest_downsample_mask(mask: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """F.interpolate(mode='nearest') of a bool (H, W) mask to (ph, pw)."""
    H, W = mask.shape
    ys = (torch.arange(ph, dtype=torch.float32, device=mask.device) * (H / ph)).long()
    xs = (torch.arange(pw, dtype=torch.float32, device=mask.device) * (W / pw)).long()
    return mask[ys][:, xs]


def vggt_distill_loss(
    student: Student,
    teacher: VggtTeacher,
    cfg: DistillConfig,
    batch: Dict[str, torch.Tensor],
    temperature,
    priority: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: rgb_1/rgb_2 (B, Hr, Wr, 3) in [0, 1]; rgb_vggt (B, 2, H, W, 3)
    in [0, 1]. priority (B, H*W): the NMS tie-break draw, or None to draw
    it from `generator`."""
    kcfg = cfg.keypoints
    B, S, H, W, _ = batch["rgb_vggt"].shape
    vp = teacher.cfg.patch_size
    ph, pw = H // vp, W // vp

    # 1. frozen teacher: one aggregator pass gives the features and the
    #    tokens the track head reads
    tdtype = cfg.teacher_dtype if cfg.teacher_dtype != "float32" else None
    feats, track_tokens = teacher.extract_features(batch["rgb_vggt"], temperature,
                                                   dtype=tdtype, return_track_tokens=True)
    kp_1, kp_2, valid, mask_1, mask_2 = teacher.sample_keypoints(
        feats, batch["rgb_vggt"], track_tokens, num_keypoints=kcfg.nms_num,
        min_distance=kcfg.nms_min_distance, border=kcfg.border, priority=priority,
        generator=generator)

    rgb_resized = torch.cat([resize_bilinear(batch["rgb_1"], (H, W)),
                             resize_bilinear(batch["rgb_2"], (H, W))], dim=0)

    # 2. depth losses on the VGGT depth maps: one student forward, both views
    desc_all, kp_feat_all = student.get_feature_and_intermediates(
        rgb_resized, torch.cat([kp_1, kp_2], dim=0), n=(4, 5, 6, 7))
    desc_1, desc_2 = desc_all[:B], desc_all[B:]
    kp_feat_1, kp_feat_2 = kp_feat_all[:B], kp_feat_all[B:]
    kp_depth_1 = torch.stack([extract_kp_depth(feats["depth_pred_1"][b], kp_1[b][None],
                                               kcfg.depth_window)[0] for b in range(B)])
    kp_depth_2 = torch.stack([extract_kp_depth(feats["depth_pred_2"][b], kp_2[b][None],
                                               kcfg.depth_window)[0] for b in range(B)])
    pred_depth_diff = student.depth_diff(kp_feat_1 - kp_feat_2)
    gt_diff = torch.tanh(kp_depth_1 - kp_depth_2).detach()
    depth_loss = _masked_mean(torch.abs(pred_depth_diff - gt_diff), valid)

    intra_depth_loss = student.intra_depth_loss(
        kp_feat_all, torch.cat([kp_depth_1, kp_depth_2], dim=0),
        torch.cat([valid, valid], dim=0), kcfg.depth_rank_threshold)

    # 3. cost-volume KL at the /14 grid; the student side through K3
    fc_all = student.get_feature_cost_vggt(rgb_resized, vp)
    hw = ph * pw
    fc_1 = l2_normalize(fc_all[:B].reshape(B, hw, -1), axis=-1)
    fc_2 = l2_normalize(fc_all[B:].reshape(B, hw, -1), axis=-1)
    cost_12 = torch.einsum("bnc,bmc->bnm", fc_1, fc_2)
    cost_21 = torch.einsum("bnc,bmc->bnm", fc_2, fc_1)
    mp_1 = torch.stack([_nearest_downsample_mask(m, ph, pw).reshape(-1) for m in mask_1])
    mp_2 = torch.stack([_nearest_downsample_mask(m, ph, pw).reshape(-1) for m in mask_2])
    t_1 = torch.stack([masked_patch_cost(feats["cost_1"][b][None], mp_1[b])[0]
                       for b in range(B)])
    t_2 = torch.stack([masked_patch_cost(feats["cost_2"][b][None], mp_2[b])[0]
                       for b in range(B)])
    # a masked-out row contributes 0; the mean keeps the all-rows denominator
    kl_rows_1 = masked_softmax_kl_rows(t_1, cost_12, mp_1) * mp_1
    kl_rows_2 = masked_softmax_kl_rows(t_2, cost_21, mp_2) * mp_2
    kl_loss = (kl_rows_1.mean() + kl_rows_2.mean()) / 2.0

    # 4. matching AP on the world points
    def gather_pts(pts3d, kp):
        x = torch.clamp(kp[:, 0].long(), 0, W - 1)
        y = torch.clamp(kp[:, 1].long(), 0, H - 1)
        return pts3d[y, x]

    pts3d_1 = torch.stack([gather_pts(feats["point_map_view_1"][b], kp_1[b]) for b in range(B)])
    pts3d_2 = torch.stack([gather_pts(feats["point_map_view_2"][b], kp_2[b]) for b in range(B)])
    ap_loss = ap_loss_paired(desc_1, desc_2, pts3d_1, pts3d_2, valid,
                             thres3d_neg=kcfg.thres3d_neg, temp=kcfg.ap_sigmoid_temp,
                             legacy_rpos1=True)

    w = cfg.loss_weights
    loss = (w.ap * ap_loss + w.depth * depth_loss + w.intra_depth * intra_depth_loss
            + w.kl * kl_loss)
    metrics = {
        "loss": loss,
        "ap_loss": ap_loss,
        "depth_loss": depth_loss,
        "intra_depth_loss": intra_depth_loss,
        "kl_loss": kl_loss,
        "num_kps": valid.float().sum() / B,
    }
    return loss, metrics


def build_vggt_train_step(
    student: Student,
    teacher: VggtTeacher,
    cfg: DistillConfig,
    optimizer: ClippedAdamW,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Put the student and the teacher on `device` (the card unless the
    caller asks for another), and return
    step(batch, temperature, priority=None) -> detached metrics, which
    updates the trainable parameters in place. Without a priority the NMS
    tie-break draws from `generator`, or from a torch.Generator on `device`
    seeded with cfg.train.seed when none is given."""
    device = torch.device(device)
    student.to(device)
    teacher.to(device)

    def train_step(batch, temperature, priority=None):
        nonlocal generator
        if priority is None and generator is None:
            generator = torch.Generator(device=device).manual_seed(cfg.train.seed)
        optimizer.zero_grad()
        loss, metrics = vggt_distill_loss(student, teacher, cfg, batch, temperature,
                                          priority=priority, generator=generator)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def build_vggt_train_multistep(
    student: Student,
    teacher: VggtTeacher,
    cfg: DistillConfig,
    optimizer: ClippedAdamW,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """K optimizer steps over a (K, B, ...) batch stack:
    group(batches, temperature, priorities=None) -> metrics stacked to (K,),
    equal to K calls of the single step; priorities (K, B, H*W) or None (the
    draws then come from the generator, step after step)."""
    step = build_vggt_train_step(student, teacher, cfg, optimizer, device, generator)

    def multi_step(batches, temperature, priorities=None):
        return stack_metrics([
            step(b, temperature, None if priorities is None else priorities[i])
            for i, b in enumerate(unstack(batches))])

    return multi_step
