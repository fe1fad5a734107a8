"""DUSt3R / MASt3R pretraining criteria: Regr3D (+ shift / scale-invariant
variants) and ConfLoss (counterpart of gd3d/ops/regr3d.py).

Every map stays (B, H, W[, 3]) and every reduction is a masked sum or a
masked median, as in gd3d, so the sums run in gd3d's order and no boolean
indexing makes a shape depend on the data. Medians and scales are
detached exactly where gd3d has stop_gradient (the reference's `.detach()`
and @torch.no_grad() helpers). `masked_median` takes the lower middle
element, as torch.nanmedian does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Tensor = torch.Tensor


def _norm(x: Tensor, keepdim: bool = False) -> Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


# --------------------------------------------------------------- primitives
def geotrf(pose: Tensor, pts: Tensor) -> Tensor:
    """Apply (B, 4, 4) rigid / affine transforms to (B, ..., 3) points."""
    R = pose[:, :3, :3]
    t = pose[:, :3, 3]
    shape = pts.shape
    flat = pts.reshape(shape[0], -1, 3)
    out = torch.einsum("bij,bnj->bni", R, flat) + t[:, None]
    return out.reshape(shape)


def inv_pose(pose: Tensor) -> Tensor:
    """Invert (B, 4, 4) rigid poses: [R t]^-1 = [R^T, -R^T t]."""
    R = pose[..., :3, :3]
    t = pose[..., :3, 3]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -torch.einsum("...ij,...j->...i", Rt, t)[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=pose.dtype,
                          device=pose.device).expand(top[..., :1, :].shape)
    return torch.cat([top, bottom], dim=-2)


def masked_median(x: Tensor, mask: Tensor) -> Tensor:
    """Per-row median of x (B, N) over mask, the lower middle element for
    even counts (torch.nanmedian); rows with no valid entry give 0."""
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(mask, x, big), dim=-1).values
    n = mask.sum(dim=-1)
    idx = torch.clamp(n - 1, min=0) // 2
    med = torch.gather(xs, -1, idx[:, None])[:, 0]
    return torch.where(n > 0, med, torch.zeros_like(med))


def normalize_pointcloud(pts1: Tensor, pts2: Optional[Tensor], norm_mode: str,
                         valid1: Tensor, valid2: Optional[Tensor]
                         ) -> Tuple[Tensor, Optional[Tensor], Tensor]:
    """Joint renormalisation of two pointmaps, 'avg_dis' or 'median_dis'.
    Returns (pts1 / f, pts2 / f, f) with f (B,); the median factor is
    detached, the average carries gradient."""
    mode, dis = norm_mode.split("_")
    if dis != "dis":
        raise ValueError(f"unsupported dis mode {dis!r} (only 'dis')")
    B = pts1.shape[0]
    d1 = _norm(pts1).reshape(B, -1)
    m1 = valid1.reshape(B, -1)
    if pts2 is not None:
        d2 = _norm(pts2).reshape(B, -1)
        m2 = valid2.reshape(B, -1)
        dis_all = torch.cat([d1, d2], dim=1)
        mask_all = torch.cat([m1, m2], dim=1)
    else:
        dis_all, mask_all = d1, m1
    if mode == "avg":
        nnz = mask_all.sum(dim=1)
        factor = torch.where(mask_all, dis_all, 0.0).sum(dim=1) / (nnz + 1e-8)
    elif mode == "median":
        factor = masked_median(dis_all, mask_all).detach()
    else:
        raise ValueError(f"unsupported norm mode {mode!r}")
    factor = torch.clamp(factor, min=1e-8)[:, None, None, None]
    out2 = None if pts2 is None else pts2 / factor
    return pts1 / factor, out2, factor[:, 0, 0, 0]


def joint_pointcloud_depth(z1: Tensor, z2: Tensor, m1: Tensor, m2: Tensor) -> Tensor:
    """Masked joint median depth, no gradient."""
    B = z1.shape[0]
    z = torch.cat([z1.reshape(B, -1), z2.reshape(B, -1)], dim=1)
    m = torch.cat([m1.reshape(B, -1), m2.reshape(B, -1)], dim=1)
    return masked_median(z, m).detach()


def joint_pointcloud_center_scale(pts1: Tensor, pts2: Tensor, m1: Tensor, m2: Tensor
                                  ) -> Tuple[Tensor, Tensor]:
    """Masked joint median centre (B, 3) and median norm about it (B,), no
    gradient."""
    B = pts1.shape[0]
    p = torch.cat([pts1.reshape(B, -1, 3), pts2.reshape(B, -1, 3)], dim=1)
    m = torch.cat([m1.reshape(B, -1), m2.reshape(B, -1)], dim=1)
    center = torch.stack([masked_median(p[..., k], m) for k in range(3)], dim=-1)
    scale = masked_median(_norm(p - center[:, None]), m)
    return center.detach(), scale.detach()


def get_pred_pts3d(pred: Dict[str, Tensor], use_pose: bool) -> Tensor:
    """The predicted pointmap in view 1's frame: 'pts3d' (view 1) or
    'pts3d_in_other_view' (view 2, already in camera 1)."""
    if "pts3d_in_other_view" in pred:
        if not use_pose:
            raise ValueError("pts3d_in_other_view requires use_pose=True")
        return pred["pts3d_in_other_view"]
    pts = pred["pts3d"]
    if use_pose:
        pts = geotrf(pred["camera_pose"], pts)
    return pts


def _gt_in_cam1(gt1, gt2, dist_clip):
    in_cam1 = inv_pose(gt1["camera_pose"])
    gt_pts1 = geotrf(in_cam1, gt1["pts3d"])
    gt_pts2 = geotrf(in_cam1, gt2["pts3d"])
    valid1, valid2 = gt1["valid_mask"], gt2["valid_mask"]
    if dist_clip is not None:
        valid1 = valid1 & (_norm(gt_pts1) <= dist_clip)
        valid2 = valid2 & (_norm(gt_pts2) <= dist_clip)
    return gt_pts1, gt_pts2, valid1, valid2


# ----------------------------------------------------------------- criteria
def regr3d_pointmaps(gt1, gt2, pred1, pred2, norm_mode: Optional[str] = "avg_dis",
                     gt_scale: bool = False, shift_inv: bool = False,
                     scale_inv: bool = False, dist_clip: Optional[float] = None):
    """Both pointmaps in camera 1, optionally normalised, shift-centred
    (median z) and scale-normalised (median norm). Returns (gt_pts1,
    gt_pts2, pr_pts1, pr_pts2, valid1, valid2)."""
    gt_pts1, gt_pts2, valid1, valid2 = _gt_in_cam1(gt1, gt2, dist_clip)
    pr_pts1 = get_pred_pts3d(pred1, use_pose=False)
    pr_pts2 = get_pred_pts3d(pred2, use_pose=True)

    if norm_mode:
        pr_pts1, pr_pts2, _ = normalize_pointcloud(pr_pts1, pr_pts2, norm_mode, valid1, valid2)
        if not gt_scale:
            gt_pts1, gt_pts2, _ = normalize_pointcloud(gt_pts1, gt_pts2, norm_mode,
                                                       valid1, valid2)

    if shift_inv:
        gt_shift = joint_pointcloud_depth(gt_pts1[..., 2], gt_pts2[..., 2],
                                          valid1, valid2)[:, None, None]
        pr_shift = joint_pointcloud_depth(pr_pts1[..., 2], pr_pts2[..., 2],
                                          valid1, valid2)[:, None, None]
        zshift = lambda p, s: torch.cat([p[..., :2], (p[..., 2] - s)[..., None]], -1)  # noqa: E731
        gt_pts1, gt_pts2 = zshift(gt_pts1, gt_shift), zshift(gt_pts2, gt_shift)
        pr_pts1, pr_pts2 = zshift(pr_pts1, pr_shift), zshift(pr_pts2, pr_shift)

    if scale_inv:
        _, gt_s = joint_pointcloud_center_scale(gt_pts1, gt_pts2, valid1, valid2)
        _, pr_s = joint_pointcloud_center_scale(pr_pts1, pr_pts2, valid1, valid2)
        pr_s = torch.clamp(pr_s, 1e-3, 1e3)[:, None, None, None]
        gt_s = gt_s[:, None, None, None]
        if gt_scale:
            pr_pts1 = pr_pts1 * (gt_s / pr_s)
            pr_pts2 = pr_pts2 * (gt_s / pr_s)
        else:
            gt_pts1, gt_pts2 = gt_pts1 / gt_s, gt_pts2 / gt_s
            pr_pts1, pr_pts2 = pr_pts1 / pr_s, pr_pts2 / pr_s

    return gt_pts1, gt_pts2, pr_pts1, pr_pts2, valid1, valid2


def regr3d_loss(gt1, gt2, pred1, pred2, norm_mode: Optional[str] = "avg_dis",
                gt_scale: bool = False, shift_inv: bool = False, scale_inv: bool = False,
                dist_clip: Optional[float] = None):
    """Per-pixel L21 maps (l1_map, l2_map, valid1, valid2), each (B, H, W)."""
    gt_pts1, gt_pts2, pr_pts1, pr_pts2, valid1, valid2 = regr3d_pointmaps(
        gt1, gt2, pred1, pred2, norm_mode, gt_scale, shift_inv, scale_inv, dist_clip)
    return _norm(pr_pts1 - gt_pts1), _norm(pr_pts2 - gt_pts2), valid1, valid2


def masked_mean(x: Tensor, mask: Tensor, count=None) -> Tensor:
    """The mean of x over mask, 0 where mask is empty; `count` maps this
    batch's count to the global batch's (data parallelism)."""
    n = mask.sum() if count is None else count(mask.sum())
    mean = torch.where(mask, x, 0.0).sum() / torch.clamp(n, min=1)
    return torch.where(n > 0, mean, torch.zeros_like(mean))


def conf_regr3d_loss(gt1, gt2, pred1, pred2, alpha: float = 0.2,
                     norm_mode: Optional[str] = "avg_dis", gt_scale: bool = False,
                     shift_inv: bool = False, scale_inv: bool = False,
                     dist_clip: Optional[float] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """ConfLoss(Regr3D(L21, norm_mode), alpha): per pixel
    conf * l - alpha * log(conf), masked mean per view, summed; a view with
    no valid pixel adds 0."""
    l1, l2, valid1, valid2 = regr3d_loss(gt1, gt2, pred1, pred2, norm_mode, gt_scale,
                                         shift_inv, scale_inv, dist_clip)
    return _conf_weighted(l1, l2, valid1, valid2, pred1["conf"], pred2["conf"], alpha)


def _conf_weighted(l1, l2, mask1, mask2, c1, c2, alpha, count=None):
    cl1 = masked_mean(l1 * c1 - alpha * torch.log(c1), mask1, count)
    cl2 = masked_mean(l2 * c2 - alpha * torch.log(c2), mask2, count)
    return cl1 + cl2, {
        "conf_loss_1": cl1, "conf_loss2": cl2,
        "Regr3D_pts3d_1": masked_mean(l1, mask1, count),
        "Regr3D_pts3d_2": masked_mean(l2, mask2, count),
    }


def find_opt_scaling(gt_pts1: Tensor, gt_pts2: Optional[Tensor], pr_pts1: Tensor,
                     pr_pts2: Optional[Tensor] = None,
                     fit_mode: str = "weiszfeld_stop_grad",
                     valid1: Optional[Tensor] = None,
                     valid2: Optional[Tensor] = None) -> Tensor:
    """Per-sample scale s minimising |pr - s gt|: 'avg' closed form,
    'median' of per-point ratios, or 'weiszfeld' (10 fixed IRLS steps);
    *_stop_grad detaches; clipped at 1e-3."""
    B = gt_pts1.shape[0]

    def flat(p, v):
        if p is None:
            return None, None
        p = p.reshape(B, -1, 3)
        m = (torch.ones(p.shape[:2], dtype=torch.bool, device=p.device) if v is None
             else v.reshape(B, -1))
        return p, m

    g1, m1 = flat(gt_pts1, valid1)
    g2, m2 = flat(gt_pts2, valid2)
    p1, _ = flat(pr_pts1, None)
    p2, _ = flat(pr_pts2, None)
    if g2 is not None:
        gt, pr, m = torch.cat([g1, g2], 1), torch.cat([p1, p2], 1), torch.cat([m1, m2], 1)
    else:
        gt, pr, m = g1, p1, m1

    dot_gt_pr = (pr * gt).sum(dim=-1)
    dot_gt_gt = (gt ** 2).sum(dim=-1)
    n = torch.clamp(m.sum(dim=1), min=1)

    def mmean(x):
        return torch.where(m, x, 0.0).sum(dim=1) / n

    if fit_mode.startswith("avg"):
        scaling = mmean(dot_gt_pr) / mmean(dot_gt_gt)
    elif fit_mode.startswith("median"):
        scaling = masked_median(dot_gt_pr / torch.clamp(dot_gt_gt, min=1e-12), m)
    elif fit_mode.startswith("weiszfeld"):
        scaling = mmean(dot_gt_pr) / mmean(dot_gt_gt)
        for _ in range(10):
            w = 1.0 / torch.clamp(_norm(pr - scaling[:, None, None] * gt), min=1e-8)
            scaling = mmean(w * dot_gt_pr) / mmean(w * dot_gt_gt)
    else:
        raise ValueError(f"bad fit_mode {fit_mode!r}")
    if fit_mode.endswith("stop_grad"):
        scaling = scaling.detach()
    return torch.clamp(scaling, min=1e-3)


# ------------------------------------------- MASt3R fork of the criterion
def apply_log_to_norm(xyz: Tensor) -> Tensor:
    """Log-warp point norms: direction kept, |p| -> log1p(|p|)."""
    d = _norm(xyz, keepdim=True)
    return xyz / torch.clamp(d, min=1e-8) * torch.log1p(d)


def mast3r_regr3d_maps(gt1, gt2, pred1, pred2, norm_mode: str = "?avg_dis",
                       gt_scale: bool = False, dist_clip: Optional[float] = None,
                       sky_loss_value: float = 2.0, max_metric_scale: float = 0.0,
                       loss_in_log=False):
    """The MASt3R fork of Regr3D, per pixel: a leading '?' in norm_mode
    exempts metric-scale samples (gt1['is_metric_scale']) from the
    prediction's self-normalisation (they are divided by the GT factor);
    max_metric_scale demotes metric samples whose farthest valid point
    exceeds it; sky pixels (sky_mask & ~valid) join the mask with the
    constant loss sky_loss_value; loss_in_log 'before' log-warps the GT
    first, any other truthy value both maps before the L21. Returns
    (l1_map, l2_map, mask1, mask2)."""
    gt_pts1, gt_pts2, valid1, valid2 = _gt_in_cam1(gt1, gt2, dist_clip)
    norm_all = not norm_mode.startswith("?")
    mode = norm_mode.lstrip("?")

    if loss_in_log == "before":
        gt_pts1 = apply_log_to_norm(gt_pts1)
        gt_pts2 = apply_log_to_norm(gt_pts2)

    pr_pts1 = get_pred_pts3d(pred1, use_pose=False)
    pr_pts2 = get_pred_pts3d(pred2, use_pose=True)

    B = valid1.shape[0]
    if norm_all:
        norm_sel = torch.ones((B,), dtype=torch.bool, device=valid1.device)
    else:
        is_metric = gt1["is_metric_scale"]
        if max_metric_scale:
            d1 = torch.where(valid1, _norm(gt_pts1), 0.0).reshape(B, -1)
            d2 = torch.where(valid2, _norm(gt_pts2), 0.0).reshape(B, -1)
            is_metric = (is_metric & (d1.amax(dim=-1) < max_metric_scale)
                         & (d2.amax(dim=-1) < max_metric_scale))
        norm_sel = ~is_metric

    if mode:
        # per-sample factors: the whole batch's, then a choice per row
        n1, n2, _ = normalize_pointcloud(pr_pts1, pr_pts2, mode, valid1, valid2)
        sel = norm_sel[:, None, None, None]
        pr_pts1 = torch.where(sel, n1, pr_pts1)
        pr_pts2 = torch.where(sel, n2, pr_pts2)
        if not gt_scale:
            gt_pts1, gt_pts2, gt_f = normalize_pointcloud(gt_pts1, gt_pts2, mode,
                                                          valid1, valid2)
            gt_f4 = gt_f[:, None, None, None]
            pr_pts1 = torch.where(sel, pr_pts1, pr_pts1 / gt_f4)
            pr_pts2 = torch.where(sel, pr_pts2, pr_pts2 / gt_f4)

    if loss_in_log and loss_in_log != "before":
        pr_pts1, gt_pts1 = apply_log_to_norm(pr_pts1), apply_log_to_norm(gt_pts1)
        pr_pts2, gt_pts2 = apply_log_to_norm(pr_pts2), apply_log_to_norm(gt_pts2)

    l1 = _norm(pr_pts1 - gt_pts1)
    l2 = _norm(pr_pts2 - gt_pts2)
    mask1, mask2 = valid1, valid2
    if sky_loss_value > 0:
        sky1 = gt1["sky_mask"] & ~valid1
        sky2 = gt2["sky_mask"] & ~valid2
        mask1, mask2 = valid1 | sky1, valid2 | sky2
        l1 = torch.where(sky1, sky_loss_value, l1)
        l2 = torch.where(sky2, sky_loss_value, l2)
    return l1, l2, mask1, mask2


def mast3r_conf_regr3d_loss(gt1, gt2, pred1, pred2, alpha: float = 0.2,
                            norm_mode: str = "?avg_dis", gt_scale: bool = False,
                            dist_clip: Optional[float] = None, sky_loss_value: float = 2.0,
                            max_metric_scale: float = 0.0, loss_in_log=False,
                            count=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """ConfLoss(MASt3R Regr3D(L21, '?avg_dis'), alpha 0.2): the regression
    term of MASt3R pretraining. `count` as in masked_mean."""
    l1, l2, mask1, mask2 = mast3r_regr3d_maps(gt1, gt2, pred1, pred2, norm_mode, gt_scale,
                                              dist_clip, sky_loss_value, max_metric_scale,
                                              loss_in_log)
    return _conf_weighted(l1, l2, mask1, mask2, pred1["conf"], pred2["conf"], alpha, count)
