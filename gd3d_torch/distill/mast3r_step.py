"""MASt3R -> CLIP-ViT distillation train step, the flagship path
(counterpart of gd3d/distill/mast3r_step.py).

One step: frozen MASt3R symmetric inference (cost maps, descriptors,
pts3d); reciprocal-NN keypoints with border/confidence filtering; depth
maps rasterized from the teacher point cloud and post-processed; one fused
student forward over both views plus a cost pass; four losses (smooth-AP, depth L1, intra-depth ranking,
cost-volume KL through K3); then clip + AdamW on the trainable parameters.
Attention runs through K1/K2 in both the teacher and the student. On the
objaverse path (has_depth=True) the depth maps come from the batch instead
of the teacher's point cloud.

build_mast3r_train_multistep runs K steps over a (K, ...) batch stack, the
semantics of gd3d's lax.scan trainer: one step after another, the metrics
stacked to (K,) on the device.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from gd3d_torch.core.config import DistillConfig
from gd3d_torch.distill.group import stack_metrics, unstack
from gd3d_torch.distill.keypoints import filter_and_match_keypoints
from gd3d_torch.distill.train_state import ClippedAdamW
from gd3d_torch.kernels.cost_kl import masked_softmax_kl_rows
from gd3d_torch.models.student import Student, resize_bilinear
from gd3d_torch.ops.basic import l2_normalize
from gd3d_torch.ops.depth import post_process_depth
from gd3d_torch.ops.geometry import extract_kp_depth, point_cloud_to_depth
from gd3d_torch.ops.losses import _masked_mean, ap_loss_paired
from gd3d_torch.ops.masks import masked_patch_cost, patch_mask_from_kps
from gd3d_torch.teachers.mast3r import Mast3rTeacher


def mast3r_distill_loss(
    student: Student,
    teacher: Mast3rTeacher,
    cfg: DistillConfig,
    batch: Dict[str, torch.Tensor],
    temperature,
    has_depth: bool,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss for a batch of B pairs. Batch keys (NHWC float32): rgb_1/rgb_2
    (B, Hr, Wr, 3) in [0, 1]; rgb_mast3r_1/2 (B, H, W, 3) in [-1, 1] with
    W >= H; intrinsic (B, 3, 3); with has_depth (objaverse) also depth_1/2
    (B, Hd, Wd), bilinear-resized to (H, W) when their size differs.
    Without it (ScanNet++) the depth maps are rasterized from the teacher's
    point clouds."""
    kcfg = cfg.keypoints
    ps = cfg.student.patch_size
    B, H, W, _ = batch["rgb_mast3r_1"].shape

    # 1. frozen teacher
    feats = teacher.extract_features(batch["rgb_mast3r_1"], batch["rgb_mast3r_2"],
                                     temperature, dtype=cfg.teacher_dtype)

    # 2. keypoints, per pair
    kps = [
        filter_and_match_keypoints(
            {k: feats[k][b] for k in ("desc_1", "desc_2", "conf_1", "conf_2")},
            H, W, subsample=kcfg.nn_subsample, border=kcfg.border,
            min_conf_percent=kcfg.min_conf_percentile)
        for b in range(B)
    ]
    kp_1, kp_2, valid = (torch.stack(t) for t in zip(*kps))

    rgb_resized = torch.cat([resize_bilinear(batch["rgb_1"], (H, W)),
                             resize_bilinear(batch["rgb_2"], (H, W))], dim=0)

    if has_depth:
        depth_1, depth_2 = batch["depth_1"], batch["depth_2"]
        if tuple(depth_1.shape[-2:]) != (H, W):
            depth_1 = resize_bilinear(depth_1[..., None], (H, W))[..., 0]
            depth_2 = resize_bilinear(depth_2[..., None], (H, W))[..., 0]
    else:  # depth maps rasterized from the teacher's point clouds
        def raster(pts3d, K):
            return post_process_depth(
                point_cloud_to_depth(pts3d.reshape(-1, 3), K, W, H), kernel_size=3)

        depth_1 = torch.stack([raster(feats["pts3d_1"][b], batch["intrinsic"][b])
                               for b in range(B)])
        depth_2 = torch.stack([raster(feats["pts3d_2"][b], batch["intrinsic"][b])
                               for b in range(B)])

    # 3. depth losses: one student forward over both views
    desc_all, kp_feat_all = student.get_feature_and_intermediates(
        rgb_resized, torch.cat([kp_1, kp_2], dim=0), n=(4, 5, 6, 7))
    desc_1, desc_2 = desc_all[:B], desc_all[B:]
    kp_feat_1, kp_feat_2 = kp_feat_all[:B], kp_feat_all[B:]
    kp_depth_1 = torch.stack([extract_kp_depth(depth_1[b], kp_1[b][None],
                                               kcfg.depth_window)[0] for b in range(B)])
    kp_depth_2 = torch.stack([extract_kp_depth(depth_2[b], kp_2[b][None],
                                               kcfg.depth_window)[0] for b in range(B)])

    pred_depth_diff = student.depth_diff(kp_feat_1 - kp_feat_2)
    gt_diff = torch.tanh(kp_depth_1 - kp_depth_2).detach()
    depth_loss = _masked_mean(torch.abs(pred_depth_diff - gt_diff), valid)

    intra_depth_loss = student.intra_depth_loss(
        kp_feat_all, torch.cat([kp_depth_1, kp_depth_2], dim=0),
        torch.cat([valid, valid], dim=0), kcfg.depth_rank_threshold)

    # 4. cost-volume KL; both views in one cost forward
    fc_all = student.get_feature_cost(rgb_resized)
    hw = (H // ps) * (W // ps)
    fc_1 = l2_normalize(fc_all[:B].reshape(B, hw, -1), axis=-1)
    fc_2 = l2_normalize(fc_all[B:].reshape(B, hw, -1), axis=-1)
    cost_12 = torch.einsum("bnc,bmc->bnm", fc_1, fc_2)
    cost_21 = torch.einsum("bnc,bmc->bnm", fc_2, fc_1)

    mask_1 = torch.stack([patch_mask_from_kps(kp_1[b], H, W, ps, valid=valid[b])
                          for b in range(B)])
    mask_2 = torch.stack([patch_mask_from_kps(kp_2[b], H, W, ps, valid=valid[b])
                          for b in range(B)])
    mcost_t1 = torch.stack([masked_patch_cost(feats["cost_1"][b][None], mask_1[b])[0]
                            for b in range(B)])
    mcost_t2 = torch.stack([masked_patch_cost(feats["cost_2"][b][None], mask_2[b])[0]
                            for b in range(B)])
    # student side fused: masked softmax + per-row KL in one kernel (K3)
    kl_loss = (masked_softmax_kl_rows(mcost_t1, cost_12, mask_1).mean()
               + masked_softmax_kl_rows(mcost_t2, cost_21, mask_2).mean()) / 2.0

    # 5. matching AP loss
    def gather_pts(pts3d, kp):
        x = torch.clamp(kp[:, 0].long(), 0, W - 1)
        y = torch.clamp(kp[:, 1].long(), 0, H - 1)
        return pts3d[y, x]

    pts3d_1 = torch.stack([gather_pts(feats["pts3d_1"][b], kp_1[b]) for b in range(B)])
    pts3d_2 = torch.stack([gather_pts(feats["pts3d_2_from_1"][b], kp_2[b])
                           for b in range(B)])
    ap_loss = ap_loss_paired(desc_1, desc_2, pts3d_1, pts3d_2, valid,
                             thres3d_neg=kcfg.thres3d_neg, temp=kcfg.ap_sigmoid_temp)

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


def build_mast3r_train_step(
    student: Student,
    teacher: Mast3rTeacher,
    cfg: DistillConfig,
    optimizer: ClippedAdamW,
    has_depth: bool,
    device="cuda",
) -> Callable[[Dict[str, torch.Tensor], float], Dict[str, torch.Tensor]]:
    """Put the student and the teacher on `device` (the card unless the
    caller asks for another), and return step(batch, temperature) ->
    detached metrics, which updates the student's trainable parameters in
    place; the temperature is a runtime scalar."""
    device = torch.device(device)
    student.to(device)
    teacher.to(device)

    def train_step(batch, temperature):
        optimizer.zero_grad()
        loss, metrics = mast3r_distill_loss(student, teacher, cfg, batch,
                                            temperature, has_depth)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def build_mast3r_train_multistep(
    student: Student,
    teacher: Mast3rTeacher,
    cfg: DistillConfig,
    optimizer: ClippedAdamW,
    has_depth: bool,
    device="cuda",
) -> Callable[[Dict[str, torch.Tensor], float], Dict[str, torch.Tensor]]:
    """K optimizer steps over a (K, B, ...) batch stack:
    group(batches, temperature) -> metrics stacked to (K,), equal to K
    calls of the single step (gd3d's lax.scan over build_mast3r_train_step)."""
    step = build_mast3r_train_step(student, teacher, cfg, optimizer, has_depth, device)

    def multi_step(batches, temperature):
        return stack_metrics([step(b, temperature) for b in unstack(batches)])

    return multi_step


def temperature_schedule(cfg: DistillConfig, epoch: int) -> float:
    """init -> final, linear over max_epochs."""
    t = cfg.train
    ratio = min(epoch / max(t.max_epochs, 1), 1.0)
    return t.init_temperature * (1 - ratio) + t.final_temperature * ratio
