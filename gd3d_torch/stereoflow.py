"""CroCo-Stereo / CroCo-Flow runtime: losses, metrics, tiled inference and
training (counterpart of gd3d/stereoflow.py; stereoflow/criterion.py,
engine.py, train.py:50-75).

Conventions as in gd3d: NHWC tensors; ground truth holds +inf at invalid
pixels (datasets_stereo.py:551-556) and the losses and metrics mask on
isfinite(gt), through double wheres so no inf or nan reaches a gradient.

`resize_bicubic_torch` is F.interpolate(mode="bicubic", align_corners=False)
itself, which gd3d emulates with Keys' A = -0.75 interpolation matrices.
`tiled_pred` runs the tiles through the model `tile_batch` tiles of the
batch at a time (all of them when it is None, as gd3d's one batched
forward) and accumulates each tile's weighted prediction in gd3d's order.

Training is gd3d's optax chain written out (`AdamW`): the learning rate of
optax.warmup_cosine_decay_schedule read at the count before the increment,
then adamw(b1 0.9, b2 0.95, eps 1e-8, weight decay on every parameter):
the moments (1 - b) * g + b * m, the bias correction 1 - b ** count at the
count after the increment, the update m_hat / (sqrt(v_hat) + eps) + wd * p
scaled by the negative learning rate. The step runs with TF32 off, as gd3d
trains in fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gd3d_torch.align import _host
from gd3d_torch.teachers.mast3r import no_tf32

f32 = np.float32


# ---------------------------------------------------------------------------
# losses (criterion.py): gt and pred (B, H, W, C), conf (B, H, W)
# ---------------------------------------------------------------------------


def _gtnorm(gt: torch.Tensor) -> torch.Tensor:
    """criterion.py:12-16: stereo -> the gt channel itself, flow -> its L2
    norm. (B, H, W, 1)."""
    if gt.shape[-1] == 1:
        return gt
    return torch.sqrt(torch.sum(torch.square(gt), dim=-1, keepdim=True))


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = torch.sum(mask)
    return torch.sum(torch.where(mask, x, torch.zeros_like(x))) / torch.clamp(n, min=1)


def l1_loss(pred, gt, max_gtnorm: Optional[float] = None):
    """criterion.py:21-37 (the mask covers every channel)."""
    mask = torch.isfinite(gt)
    if max_gtnorm is not None:
        mask = mask & (_gtnorm(gt) < max_gtnorm)
    safe_gt = torch.where(mask, gt, torch.zeros_like(gt))
    return _masked_mean(torch.abs(safe_gt - pred), mask)


def _conf_pixel_loss(pred, gt, elem_fn, max_gtnorm):
    """The Laplacian losses' common part: the pixel mask from channel 0,
    the per-pixel L1 summed over the channels, elem_fn adds the confidence
    terms."""
    mask = torch.isfinite(gt)
    pix_mask = mask[..., 0]
    if max_gtnorm is not None:
        pix_mask = pix_mask & (_gtnorm(gt)[..., 0] < max_gtnorm)
    safe_gt = torch.where(mask, gt, torch.zeros_like(gt))
    err = torch.sum(torch.abs(safe_gt - pred), dim=-1)  # (B, H, W)
    return _masked_mean(elem_fn(err), pix_mask)


def laplacian_loss(pred, gt, conf, max_gtnorm: Optional[float] = None):
    """criterion.py:41-54: |err| / exp(conf) + conf."""
    return _conf_pixel_loss(pred, gt, lambda err: err / torch.exp(conf) + conf, max_gtnorm)


def laplacian_loss_bounded(pred, gt, conf, max_gtnorm: float = 10000.0, a: float = 0.25,
                           b: float = 4.0):
    """criterion.py:56-69 (CroCo-Flow): c = (b - a) * sigmoid(conf) + a;
    |err| / c + log(c)."""
    c = (b - a) * torch.sigmoid(conf) + a
    return _conf_pixel_loss(pred, gt, lambda err: err / c + torch.log(c), max_gtnorm)


def laplacian_loss_bounded2(pred, gt, conf, max_gtnorm: Optional[float] = None, a: float = 3.0,
                            b: float = 3.0):
    """criterion.py:71-85 (CroCo-Stereo): c = 2a * (sigmoid(conf / b) - 0.5);
    |err| / exp(c) + c."""
    c = 2.0 * a * (torch.sigmoid(conf / b) - 0.5)
    return _conf_pixel_loss(pred, gt, lambda err: err / torch.exp(c) + c, max_gtnorm)


@dataclasses.dataclass(frozen=True)
class Criterion:
    """A named reference criterion: fn(pred, gt[, conf]) and whether it
    takes a confidence channel (test.py:60-62 sizes the model's head by it)."""

    name: str
    fn: Callable
    with_conf: bool


CRITERIA: Dict[str, Criterion] = {
    "L1Loss()": Criterion("L1Loss()", l1_loss, False),
    "LaplacianLoss()": Criterion("LaplacianLoss()", laplacian_loss, True),
    "LaplacianLossBounded()": Criterion("LaplacianLossBounded()", laplacian_loss_bounded, True),
    "LaplacianLossBounded2()": Criterion("LaplacianLossBounded2()", laplacian_loss_bounded2,
                                         True),
}
# train.py:52's task defaults
DEFAULT_CRITERION = {"stereo": "LaplacianLossBounded2()", "flow": "LaplacianLossBounded()"}
DEFAULT_TILE_CONF_MODE = {"stereo": "conf_expsigmoid_15_3", "flow": "conf_expsigmoid_10_5"}
DEFAULT_CROP = {"stereo": (352, 704), "flow": (320, 384)}


# ---------------------------------------------------------------------------
# per-batch metrics (criterion.py:88-133)
# ---------------------------------------------------------------------------


def stereo_metrics(pred, gt) -> Dict[str, torch.Tensor]:
    """criterion.py:88-110: avgerr, rmse, bad@{0.5,1,2,3} (percent)."""
    B = pred.shape[0]
    mask = torch.isfinite(gt)
    gtc = torch.where(mask, gt, torch.full_like(gt, 999999.0))
    npx = torch.clamp(mask.reshape(B, -1).sum(dim=1), min=1)
    l1 = (torch.abs(gtc - pred) * mask).reshape(B, -1)
    l2 = (torch.square(gtc - pred) * mask).reshape(B, -1)
    out = {"avgerr": torch.mean(l1.sum(dim=1) / npx),
           "rmse": torch.mean(torch.sqrt(l2.sum(dim=1) / npx))}
    for th in (0.5, 1.0, 2.0, 3.0):
        bad = ((l1 > th) & mask.reshape(B, -1)).sum(dim=1) / npx
        out[f"bad@{th:.1f}"] = torch.mean(bad) * 100.0
    return out


def flow_metrics(pred, gt) -> Dict[str, torch.Tensor]:
    """criterion.py:113-133: L1err, EPE, bad@{1,3,5} (percent, on EPE)."""
    B = pred.shape[0]
    mask = torch.isfinite(gt[..., 0])
    gtc = torch.where(torch.isfinite(gt), gt, torch.full_like(gt, 999999.0))
    npx = torch.clamp(mask.reshape(B, -1).sum(dim=1), min=1)
    l1 = (torch.sum(torch.abs(gtc - pred), dim=-1) * mask).reshape(B, -1)
    l2 = (torch.sqrt(torch.sum(torch.square(gtc - pred), dim=-1)) * mask).reshape(B, -1)
    out = {"L1err": torch.mean(l1.sum(dim=1) / npx), "EPE": torch.mean(l2.sum(dim=1) / npx)}
    for th in (1.0, 3.0, 5.0):
        bad = ((l2 > th) & mask.reshape(B, -1)).sum(dim=1) / npx
        out[f"bad@{th:.1f}"] = torch.mean(bad) * 100.0
    return out


# ---------------------------------------------------------------------------
# per-dataset running metrics (criterion.py:140-250): gd3d's host numpy
# ---------------------------------------------------------------------------


def _spring_min_subsample(err_fn, gt, pred):
    """The Spring case (criterion.py:237-245 / :199-205): gt at twice the
    prediction's resolution; the least error of the 4 subsamples."""
    cands = [err_fn(gt[:, 0::2, 0::2], pred), err_fn(gt[:, 1::2, 0::2], pred),
             err_fn(gt[:, 0::2, 1::2], pred), err_fn(gt[:, 1::2, 1::2], pred)]
    return np.minimum.reduce(cands)


class StereoDatasetMetrics:
    """criterion.py:140-182: the running L1err mean and bad@th counts."""

    bad_ths = (0.5, 1.0, 2.0, 3.0)

    def __init__(self):
        self.reset()

    def reset(self):
        self.agg_n = 0
        self.agg_l1 = 0.0
        self.agg_nbad = [0 for _ in self.bad_ths]

    def add_batch(self, pred, gt):
        pred, gt = _host(pred), _host(gt)
        assert pred.shape[-1] == 1 and gt.shape[-1] == 1
        if gt.shape[1] == pred.shape[1] * 2 and gt.shape[2] == pred.shape[2] * 2:  # Spring
            l1 = _spring_min_subsample(lambda g, p: np.sum(np.abs(g - p), axis=-1), gt, pred)
            valid = np.isfinite(l1)
        else:
            valid = np.isfinite(gt[..., 0])
            l1 = np.sum(np.abs(gt - pred), axis=-1)
        n = int(valid.sum())
        if n == 0:
            return
        nnew = self.agg_n + n
        self.agg_l1 = self.agg_n / nnew * self.agg_l1 + float(l1[valid].mean()) * n / nnew
        self.agg_n = nnew
        for i, th in enumerate(self.bad_ths):
            self.agg_nbad[i] += int((l1[valid] > th).sum())

    def get_results(self) -> Dict[str, float]:
        out = {"L1err": self.agg_l1}
        for i, th in enumerate(self.bad_ths):
            out[f"bad@{th:.1f}"] = self.agg_nbad[i] / max(self.agg_n, 1) * 100.0
        return out


class FlowDatasetMetrics:
    """criterion.py:184-250: the running L1 and EPE means, bad@th, and the
    EPE of each speed bin."""

    bad_ths = (0.5, 1.0, 3.0, 5.0)
    speed_ths = ((0, 10), (10, 40), (40, np.inf))

    def __init__(self):
        self.reset()

    def reset(self):
        self.agg_n = 0
        self.agg_l1 = 0.0
        self.agg_l2 = 0.0
        self.agg_nbad = [0 for _ in self.bad_ths]
        self.agg_epespeed = [0.0 for _ in self.speed_ths]
        self.agg_nspeed = [0 for _ in self.speed_ths]

    def add_batch(self, pred, gt):
        pred, gt = _host(pred), _host(gt)
        assert pred.shape[-1] == 2 and gt.shape[-1] == 2
        if gt.shape[1] == pred.shape[1] * 2 and gt.shape[2] == pred.shape[2] * 2:  # Spring
            l1 = _spring_min_subsample(lambda g, p: np.sum(np.abs(g - p), axis=-1), gt, pred)
            l2 = _spring_min_subsample(
                lambda g, p: np.sqrt(np.sum(np.square(g - p), axis=-1)), gt, pred)
            valid = np.isfinite(l1)
            gtspeed = (np.sqrt(np.sum(np.square(gt[:, 0::2, 0::2]), axis=-1))
                       + np.sqrt(np.sum(np.square(gt[:, 0::2, 1::2]), axis=-1))
                       + np.sqrt(np.sum(np.square(gt[:, 1::2, 0::2]), axis=-1))
                       + np.sqrt(np.sum(np.square(gt[:, 1::2, 1::2]), axis=-1))) / 4.0
        else:
            valid = np.isfinite(gt[..., 0])
            l1 = np.sum(np.abs(gt - pred), axis=-1)
            l2 = np.sqrt(np.sum(np.square(gt - pred), axis=-1))
            gtspeed = np.sqrt(np.sum(np.square(gt), axis=-1))
        n = int(valid.sum())
        if n == 0:
            return
        nnew = self.agg_n + n
        self.agg_l1 = self.agg_n / nnew * self.agg_l1 + float(l1[valid].mean()) * n / nnew
        self.agg_l2 = self.agg_n / nnew * self.agg_l2 + float(l2[valid].mean()) * n / nnew
        self.agg_n = nnew
        for i, th in enumerate(self.bad_ths):
            self.agg_nbad[i] += int((l2[valid] > th).sum())
        for i, (t1, t2) in enumerate(self.speed_ths):
            vv = (gtspeed[valid] >= t1) & (gtspeed[valid] < t2)
            ns = int(vv.sum())
            if ns == 0:
                continue
            nn_ = self.agg_nspeed[i] + ns
            self.agg_epespeed[i] = (self.agg_nspeed[i] / nn_ * self.agg_epespeed[i]
                                    + ns / nn_ * float(l2[valid][vv].mean()))
            self.agg_nspeed[i] = nn_

    def get_results(self) -> Dict[str, float]:
        out = {"L1err": self.agg_l1, "EPE": self.agg_l2}
        for i, th in enumerate(self.bad_ths):
            out[f"bad@{th:.1f}"] = self.agg_nbad[i] / max(self.agg_n, 1) * 100.0
        for i, (t1, t2) in enumerate(self.speed_ths):
            key = f"s{int(t1):d}" + (f"-{int(t2):d}" if np.isfinite(t2) else "+")
            out[key] = self.agg_epespeed[i]
        return out


# ---------------------------------------------------------------------------
# tiled inference (engine.py:179-271)
# ---------------------------------------------------------------------------


def overlapping_starts(total: int, window: int, overlap: float) -> np.ndarray:
    """engine.py:267-271."""
    assert total >= window and 0 <= overlap < 1, (total, window, overlap)
    num_windows = 1 + int(np.ceil((total - window) / ((1 - overlap) * window)))
    return np.linspace(0, total - window, num_windows).round().astype(int)


def resize_bicubic_torch(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """NHWC F.interpolate(mode='bicubic', align_corners=False)
    (engine.py:163-164)."""
    if tuple(out_hw) == tuple(x.shape[1:3]):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bicubic",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def resize_stereo_or_flow(data: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """engine.py:165-175: the bicubic resize and the values rescaled (x by
    the width ratio, y by the height ratio). data (B, H, W, C <= 2)."""
    B, H, W, C = data.shape
    out = resize_bicubic_torch(data, out_hw)
    chans = [out[..., 0] * (out_hw[1] / float(W))]
    if C == 2:
        chans.append(out[..., 1] * (out_hw[0] / float(H)))
    return torch.stack(chans, dim=-1)


def tile_conf_weight(predconf: torch.Tensor, conf_mode: str) -> torch.Tensor:
    """engine.py:239-242: the aggregation weight of the confidence channel."""
    if conf_mode.startswith("conf_expsigmoid_"):
        beta, betasigmoid = map(float, conf_mode[len("conf_expsigmoid_"):].split("_"))
        return torch.exp(-beta * 2.0 * (torch.sigmoid(predconf / betasigmoid) - 0.5))
    if conf_mode.startswith("conf_expbeta"):
        beta = float(conf_mode[len("conf_expbeta"):])
        return torch.exp(-beta * predconf)
    raise NotImplementedError(f"conf_mode {conf_mode} is not implemented")


def tiled_pred(apply_fn: Callable, img1: torch.Tensor, img2: torch.Tensor,
               gt: Optional[torch.Tensor] = None, *, crop: Tuple[int, int] = (352, 704),
               overlap: float = 0.5, conf_mode: str = "conf_expsigmoid_10_5",
               criterion: Optional[Criterion] = None, tile_batch: Optional[int] = None):
    """engine.py:179-264. apply_fn(img1_tiles, img2_tiles) -> (pred (T, h,
    w, C), conf (T, h, w) or None: a model without a confidence channel
    weighs every tile alike). The tiles of the batch (tile-major, B each)
    go through apply_fn `tile_batch` at a time (all at once when None).

    Returns (pred (B, H, W, C), the mean tile loss (nan without gt or
    criterion), the confidence map (B, H, W))."""
    B, H, W, _ = img1.shape
    win_h, win_w = crop

    # up-scale to cover the crop (engine.py:194-204; both ratios against W,
    # as the reference computes them)
    original_hw = None
    if H < win_h or W < win_w:
        upscale = max(win_w / W, win_h / W)
        original_hw = (H, W)
        new_hw = (round(H * upscale), round(W * upscale))
        img1 = resize_bicubic_torch(img1, new_hw)
        img2 = resize_bicubic_torch(img2, new_hw)
        if gt is not None:
            gt = resize_stereo_or_flow(gt, new_hw)
        H, W = new_hw

    tiles = [(int(sy), int(sx)) for sy in overlapping_starts(H, win_h, overlap)
             for sx in overlapping_starts(W, win_w, overlap)]
    per_call = len(tiles) if tile_batch is None else max(1, tile_batch // B)
    preds, confs = [], []
    for c0 in range(0, len(tiles), per_call):
        chunk = tiles[c0:c0 + per_call]
        t1 = torch.cat([img1[:, sy:sy + win_h, sx:sx + win_w] for sy, sx in chunk], dim=0)
        t2 = torch.cat([img2[:, sy:sy + win_h, sx:sx + win_w] for sy, sx in chunk], dim=0)
        p, c = apply_fn(t1, t2)
        preds.append(p)
        confs.append(c)
    pred_t = torch.cat(preds, dim=0)
    C = pred_t.shape[-1]
    if confs[0] is None:
        conf_t = torch.zeros(pred_t.shape[:-1], dtype=pred_t.dtype, device=pred_t.device)
    else:
        conf_t = torch.cat(confs, dim=0)

    accu_pred = torch.zeros((B, H, W, C), dtype=pred_t.dtype, device=pred_t.device)
    accu_conf = torch.full((B, H, W), 1e-16, dtype=pred_t.dtype, device=pred_t.device)
    accu_c = torch.zeros((B, H, W), dtype=pred_t.dtype, device=pred_t.device)
    losses = []
    w_t = tile_conf_weight(conf_t, conf_mode)
    for i, (sy, sx) in enumerate(tiles):
        p = pred_t[i * B:(i + 1) * B]
        pc = conf_t[i * B:(i + 1) * B]
        w = w_t[i * B:(i + 1) * B]
        if criterion is not None and gt is not None:
            gtc = gt[:, sy:sy + win_h, sx:sx + win_w]
            losses.append(criterion.fn(p, gtc, pc) if criterion.with_conf
                          else criterion.fn(p, gtc))
        accu_pred[:, sy:sy + win_h, sx:sx + win_w] += p * w[..., None]
        accu_conf[:, sy:sy + win_h, sx:sx + win_w] += w
        accu_c[:, sy:sy + win_h, sx:sx + win_w] += pc * w

    pred = accu_pred / accu_conf[..., None]
    c = accu_c / accu_conf
    loss = (torch.mean(torch.stack(losses)) if losses
            else torch.tensor(float("nan"), device=pred.device))
    if original_hw is not None:
        pred = resize_stereo_or_flow(pred, original_hw)
    return pred, loss, c


# ---------------------------------------------------------------------------
# training (train.py:50-75: AdamW betas (0.9, 0.95), wd 0.05, warmup + cosine)
# ---------------------------------------------------------------------------


def warmup_cosine_lr(count: int, peak: float, warmup_steps: int, decay_steps: int,
                     end: float = 0.0) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps, end)(count) in float32, as optax computes it."""
    if count < warmup_steps:
        c = f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
        return float(f32(0.0 - peak) * (f32(1) - c) + f32(peak))
    total = decay_steps - warmup_steps
    alpha = 0.0 if peak == 0.0 else end / peak
    c = f32(min(count - warmup_steps, total))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(total)))
    return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))


class AdamW:
    """optax.adamw(schedule, b1, b2, eps, weight_decay) on a module's
    parameters, in place (see the module docstring); `lr(count)` is the
    schedule. The state is `mu`, `nu` (by parameter name) and `count`."""

    def __init__(self, named_params, lr: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.05):
        self.params = dict(named_params)
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, weight_decay
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' .grad."""
        b1, b2 = self.b1, self.b2
        step_size = -self.lr(self.count)
        self.count += 1
        bc1 = float(f32(1) - f32(b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(b2) ** f32(self.count))
        for k, p in self.params.items():
            g = p.grad
            self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
            self.nu[k] = (1 - b2) * (g * g) + b2 * self.nu[k]
            update = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps)
            p.add_(step_size * (update + self.wd * p))


def make_stereoflow_optimizer(model: torch.nn.Module, lr: float, total_steps: int,
                              warmup_steps: int, weight_decay: float = 0.05,
                              min_lr: float = 0.0) -> AdamW:
    """gd3d's make_stereoflow_optimizer on the model's trainable
    parameters."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1)
    return AdamW(((k, p) for k, p in model.named_parameters() if p.requires_grad),
                 lambda count: warmup_cosine_lr(count, lr, warmup, decay, min_lr),
                 weight_decay=weight_decay)


def build_stereoflow_train_step(model: torch.nn.Module, criterion: Criterion,
                                optimizer: AdamW):
    """step(img1, img2, gt) -> loss: one forward, backward and update,
    TF32 off. Inputs ImageNet-normalized NHWC, on the model's device."""

    def step(img1, img2, gt):
        with no_tf32():
            for p in optimizer.params.values():
                p.grad = None
            pred, conf = model(img1, img2)
            loss = (criterion.fn(pred, gt, conf) if criterion.with_conf
                    else criterion.fn(pred, gt))
            loss.backward()
            optimizer.step()
        return loss.detach()

    return step
