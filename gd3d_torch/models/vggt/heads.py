"""VGGT heads: camera (adaLN-modulated iterative trunk) and DPT (depth,
point and track features), plus the pose decoding and depth unprojection
(counterpart of gd3d/models/vggt/heads.py).

The DPT heads compute in NCHW, as torch convolutions do, and return NHWC
like gd3d. Names follow vggt's CameraHead (`trunk.{i}`,
`poseLN_modulation.1`, `pose_branch.{fc1,fc2}`) and DPTHead (`projects.{i}`,
`resize_layers.{0,1,3}`, `scratch.layer{1..4}_rn`,
`scratch.refinenet{1..4}`, `scratch.output_conv1`,
`scratch.output_conv2.{0,2}`).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gd3d_torch.models.dpt import resize_bilinear_ac
from gd3d_torch.models.vggt.config import VggtConfig
from gd3d_torch.models.vggt.layers import VggtBlock, VggtMlp


# ----------------------------------------------------------- activations
def inverse_log_transform(y):
    return torch.sign(y) * torch.expm1(torch.abs(y))


def activate_head(out_nhwc, activation: str):
    """Split the last channel off as confidence, 1 + exp(c) (vggt's
    "expp1"), and activate the rest: "exp" (depth) or "inv_log" (points)."""
    xyz = out_nhwc[..., :-1]
    if activation == "exp":
        pts = torch.exp(xyz)
    elif activation == "inv_log":
        pts = inverse_log_transform(xyz)
    else:
        raise ValueError(f"activation must be exp or inv_log, got {activation!r}")
    return pts, 1.0 + torch.exp(out_nhwc[..., -1])


# --------------------------------------------------------------- camera
class CameraHead(nn.Module):
    """Iterative adaLN trunk on the camera token -> 9-d pose encoding. The
    trunk attends over the S frames at width 2C with cfg.num_heads heads
    (head dim 128 at full width: K1's D=128 variant)."""

    def __init__(self, cfg: VggtConfig):
        super().__init__()
        dim = 2 * cfg.embed_dim
        self.token_norm = nn.LayerNorm(dim, eps=1e-5)
        self.trunk = nn.ModuleList([
            VggtBlock(dim, cfg.num_heads, 4.0, init_values=0.01, eps=1e-5)
            for _ in range(cfg.camera_trunk_depth)])
        self.trunk_norm = nn.LayerNorm(dim, eps=1e-5)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, 9))
        self.embed_pose = nn.Linear(9, dim)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(dim, 3 * dim))
        self.adaln_norm = nn.LayerNorm(dim, eps=1e-6, elementwise_affine=False)
        self.pose_branch = VggtMlp(dim, dim // 2, 9)

    def forward(self, last_tokens: torch.Tensor, num_iterations: int = 4) -> torch.Tensor:
        """last_tokens (B, S, P, 2C) -> (B, S, 9) from the last iteration."""
        pose_tokens = self.token_norm(last_tokens[:, :, 0])
        B, S, _ = pose_tokens.shape
        pred = None
        for _ in range(num_iterations):
            if pred is None:
                module_input = self.embed_pose(self.empty_pose_tokens.expand(B, S, 9))
            else:
                module_input = self.embed_pose(pred.detach())
            shift, scale, gate = self.poseLN_modulation(module_input).chunk(3, dim=-1)
            h = gate * (self.adaln_norm(pose_tokens) * (1 + scale) + shift) + pose_tokens
            for blk in self.trunk:
                h, _ = blk(h)
            delta = self.pose_branch(self.trunk_norm(h))
            pred = delta if pred is None else pred + delta
        T, quat, fl = pred[..., :3], pred[..., 3:7], pred[..., 7:]
        return torch.cat([T, quat, F.relu(fl)], dim=-1)


# ----------------------------------------------------------------- DPT
def _sincos_embed(embed_dim: int, pos: torch.Tensor, omega_0: float = 100.0) -> torch.Tensor:
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = torch.from_numpy((1.0 / omega_0 ** omega).astype(np.float32)).to(pos.device)
    out = pos.reshape(-1)[:, None] * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def uv_pos_embed(gh: int, gw: int, aspect: float, dim: int, device=None) -> torch.Tensor:
    """(dim, gh, gw) UV-grid sincos embedding (vggt heads/utils.py)."""
    diag = (aspect ** 2 + 1.0) ** 0.5
    span_x, span_y = aspect / diag, 1.0 / diag
    xs = np.linspace(-span_x * (gw - 1) / gw, span_x * (gw - 1) / gw, gw)
    ys = np.linspace(-span_y * (gh - 1) / gh, span_y * (gh - 1) / gh, gh)
    uu, vv = np.meshgrid(xs, ys)
    grid = torch.from_numpy(np.stack([uu, vv], -1).astype(np.float32)).to(device)
    emb = torch.cat([_sincos_embed(dim // 2, grid[..., 0]),
                     _sincos_embed(dim // 2, grid[..., 1])], dim=-1)
    return emb.reshape(gh, gw, dim).permute(2, 0, 1)


class VggtResidualConvUnit(nn.Module):
    """relu -> conv -> relu -> conv, plus relu(x): the reference's in-place
    ReLU makes the skip add relu(x), not x (kept)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        xr = F.relu(x)
        return self.conv2(F.relu(self.conv1(xr))) + xr


class VggtFusionBlock(nn.Module):
    def __init__(self, features: int, has_residual: bool = True):
        super().__init__()
        self.resConfUnit1 = VggtResidualConvUnit(features) if has_residual else None
        self.resConfUnit2 = VggtResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, out_hw: Optional[Tuple[int, int]] = None):
        if self.resConfUnit1 is not None and skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        target = out_hw if out_hw is not None else (2 * x.shape[2], 2 * x.shape[3])
        return self.out_conv(resize_bilinear_ac(x, tuple(target)))


class VggtDPTHead(nn.Module):
    """DPT over the aggregator hooks. forward(tokens_list, (H, W)) ->
    activated (pts (B, S, H/dr, W/dr, out-1), conf (B, S, H/dr, W/dr)), or
    raw NHWC features (B, S, H/dr, W/dr, features) when feature_only (the
    track head's extractor)."""

    def __init__(self, cfg: VggtConfig, output_dim: int = 4, activation: str = "inv_log",
                 features: int = 256, feature_only: bool = False, down_ratio: int = 1,
                 use_pos_embed: bool = True):
        super().__init__()
        self.cfg = cfg
        self.activation = activation
        self.feature_only, self.down_ratio, self.use_pos_embed = (
            feature_only, down_ratio, use_pos_embed)
        dim_in = 2 * cfg.embed_dim
        oc = cfg.dpt_out_channels
        self.norm = nn.LayerNorm(dim_in, eps=1e-5)
        self.projects = nn.ModuleList([nn.Conv2d(dim_in, c, 1) for c in oc])
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        scratch = nn.Module()
        for i, c in enumerate(oc):
            setattr(scratch, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(scratch, f"refinenet{i}", VggtFusionBlock(features, has_residual=i != 4))
        scratch.output_conv1 = nn.Conv2d(features, features if feature_only else features // 2,
                                         3, padding=1)
        if not feature_only:
            scratch.output_conv2 = nn.Sequential(
                nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
                nn.Conv2d(32, output_dim, 1))
        self.scratch = scratch

    def forward(self, tokens_list: List[torch.Tensor], image_hw: Tuple[int, int]):
        cfg = self.cfg
        H, W = image_hw
        gh, gw = H // cfg.patch_size, W // cfg.patch_size
        psi = cfg.patch_start_idx
        feats = []
        for idx, hook in enumerate(cfg.dpt_hooks):
            t = tokens_list[hook][:, :, psi:]
            B, S, P, C2 = t.shape
            x = self.norm(t.reshape(B * S, P, C2))
            x = x.transpose(1, 2).reshape(B * S, C2, gh, gw)
            x = self.projects[idx](x)
            if self.use_pos_embed:
                x = x + 0.1 * uv_pos_embed(x.shape[2], x.shape[3], W / H, x.shape[1],
                                           x.device)[None]
            feats.append(self.resize_layers[idx](x))
        s = self.scratch
        rn = [getattr(s, f"layer{i + 1}_rn")(f) for i, f in enumerate(feats)]
        out = s.refinenet4(rn[3], out_hw=rn[2].shape[2:])
        out = s.refinenet3(out, rn[2], out_hw=rn[1].shape[2:])
        out = s.refinenet2(out, rn[1], out_hw=rn[0].shape[2:])
        out = s.refinenet1(out, rn[0])
        out = s.output_conv1(out)
        out = resize_bilinear_ac(out, (H // self.down_ratio, W // self.down_ratio))
        if self.use_pos_embed:
            out = out + 0.1 * uv_pos_embed(out.shape[2], out.shape[3], W / H, out.shape[1],
                                           out.device)[None]
        S = out.shape[0] // B
        if self.feature_only:
            out = out.permute(0, 2, 3, 1)
            return out.reshape(B, S, *out.shape[1:])
        out = s.output_conv2(out).permute(0, 2, 3, 1)
        pts, conf = activate_head(out, self.activation)
        return pts.reshape(B, S, *pts.shape[1:]), conf.reshape(B, S, *conf.shape[1:])


# ---------------------------------------------------- pose enc / geometry
def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Scalar-last (x, y, z, w) quaternion -> rotation matrix."""
    i, j, k, r = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(q.shape[:-1] + (3, 3))


def pose_encoding_to_extri_intri(pose_enc: torch.Tensor, image_hw: Tuple[int, int]):
    """(..., 9) absT_quaR_FoV -> ((..., 3, 4) extrinsic, (..., 3, 3)
    intrinsic)."""
    T, quat = pose_enc[..., :3], pose_enc[..., 3:7]
    fov_h, fov_w = pose_enc[..., 7], pose_enc[..., 8]
    extr = torch.cat([quat_to_mat(quat), T[..., None]], dim=-1)
    H, W = image_hw
    fy = (H / 2.0) / torch.tan(fov_h / 2.0)
    fx = (W / 2.0) / torch.tan(fov_w / 2.0)
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    intr = torch.stack([
        torch.stack([fx, zeros, ones * (W / 2)], -1),
        torch.stack([zeros, fy, ones * (H / 2)], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], dim=-2)
    return extr, intr


def closed_form_inverse_se3(extr: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) [R|t] world->cam -> (..., 3, 4) cam->world."""
    R, t = extr[..., :3, :3], extr[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    return torch.cat([Rt, -Rt @ t], dim=-1)


def unproject_depth_to_world(depth: torch.Tensor, extrinsic: torch.Tensor,
                             intrinsic: torch.Tensor) -> torch.Tensor:
    """Depth (..., H, W) + OpenCV [R|t] (..., 3, 4) + K (..., 3, 3) ->
    (..., H, W, 3) world points, on the device."""
    H, W = depth.shape[-2:]
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=depth.device),
                          torch.arange(W, dtype=torch.float32, device=depth.device),
                          indexing="ij")
    fx, fy = intrinsic[..., 0, 0, None, None], intrinsic[..., 1, 1, None, None]
    cx, cy = intrinsic[..., 0, 2, None, None], intrinsic[..., 1, 2, None, None]
    cam = torch.stack([(u - cx) / fx * depth, (v - cy) / fy * depth, depth], dim=-1)
    inv = closed_form_inverse_se3(extrinsic)
    return (torch.einsum("...hwc,...dc->...hwd", cam, inv[..., :3, :3])
            + inv[..., None, None, :3, 3])
