"""VGGT track head: a DPT feature extractor and the CoTracker-style
iterative predictor (counterpart of gd3d/models/vggt/track.py).

The multi-head attentions are plain torch (packed in_proj as in
nn.MultiheadAttention), as gd3d computes them with einsums outside any
kernel. The correlation sampling is a bilinear gather with zero padding in
the align_corners=True pixel convention (pixel centres at integers), which
is what gd3d's `bilinear_sample_zero` computes; grid_sample is not used.
Names follow vggt's TrackHead / BaseTrackerPredictor / EfficientUpdateFormer
(`updateformer.virual_tracks` keeps upstream's spelling).
"""
from __future__ import annotations

import math
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gd3d_torch.models.vggt.config import VggtConfig
from gd3d_torch.models.vggt.heads import VggtDPTHead


# ------------------------------------------------------------ embeddings
def get_2d_embedding(xy: torch.Tensor, C: int) -> torch.Tensor:
    """(B, N, 2) -> (B, N, 2C): sin/cos interleaved per coordinate."""
    B, N, _ = xy.shape
    div = (torch.arange(0, C, 2, dtype=torch.float32, device=xy.device)
           * (1000.0 / C)).reshape(1, 1, C // 2)

    def emb(v):
        return torch.stack([torch.sin(v * div), torch.cos(v * div)], dim=-1).reshape(B, N, C)

    return torch.cat([emb(xy[:, :, 0:1]), emb(xy[:, :, 1:2])], dim=2)


def get_2d_sincos_pos_embed_grid(embed_dim: int, gh: int, gw: int, device=None) -> torch.Tensor:
    """(gh, gw, D) sincos embed, in float64 on the host, as gd3d."""
    def emb1d(pos):
        omega = np.arange(embed_dim // 4, dtype=np.float64) / (embed_dim / 4.0)
        omega = 1.0 / 10000.0 ** omega
        out = pos.reshape(-1)[:, None] * omega[None, :]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gw_grid, gh_grid = np.meshgrid(np.arange(gw), np.arange(gh))
    emb = np.concatenate([emb1d(gw_grid.astype(np.float64)),
                          emb1d(gh_grid.astype(np.float64))], axis=1)
    return torch.from_numpy(emb.reshape(gh, gw, embed_dim).astype(np.float32)).to(device)


def _bilinear_taps(H: int, W: int, coords: torch.Tensor):
    """Four taps of (x, y) pixel coords (..., 2): flat indices, in-bounds
    masks and weights."""
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = x - x0, y - y0
    taps = []
    for dy, dx, w in ((0, 0, (1 - tx) * (1 - ty)), (0, 1, tx * (1 - ty)),
                      (1, 0, (1 - tx) * ty), (1, 1, tx * ty)):
        yi, xi = y0 + dy, x0 + dx
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = torch.clamp(yi, 0, H - 1).long() * W + torch.clamp(xi, 0, W - 1).long()
        taps.append((idx, inb, w))
    return taps


def bilinear_sample_zero(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img (M, H, W) sampled at coords (M, K, 2) -> (M, K), zero outside."""
    M, H, W = img.shape
    flat = img.reshape(M, H * W)
    out = 0.0
    for idx, inb, w in _bilinear_taps(H, W, coords):
        out = out + torch.where(inb, torch.gather(flat, 1, idx), 0.0) * w
    return out


def sample_features4d(fmap: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """fmap (B, H, W, C) sampled at coords (B, N, 2) -> (B, N, C), zero
    outside."""
    B, H, W, C = fmap.shape
    flat = fmap.reshape(B, H * W, C)
    out = 0.0
    for idx, inb, w in _bilinear_taps(H, W, coords):
        val = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        out = out + torch.where(inb[..., None], val, 0.0) * w[..., None]
    return out


# --------------------------------------------------------------- modules
class TorchMHA(nn.Module):
    """nn.MultiheadAttention's parameters (packed in_proj, out_proj) and
    math, in plain torch."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q, k, v):
        E, H = self.in_proj_weight.shape[1], self.num_heads
        D = E // H
        w, b = self.in_proj_weight, self.in_proj_bias
        qp = q @ w[:E].T + b[:E]
        kp = k @ w[E:2 * E].T + b[E:2 * E]
        vp = v @ w[2 * E:].T + b[2 * E:]
        B, Nq, _ = qp.shape
        Nk = kp.shape[1]
        qh = qp.reshape(B, Nq, H, D).transpose(1, 2)
        kh = kp.reshape(B, Nk, H, D).transpose(1, 2)
        vh = vp.reshape(B, Nk, H, D).transpose(1, 2)
        attn = torch.softmax(torch.einsum("bhnd,bhmd->bhnm", qh * D ** -0.5, kh), dim=-1)
        out = torch.einsum("bhnm,bhmd->bhnd", attn, vh).transpose(1, 2).reshape(B, Nq, E)
        return self.out_proj(out)


class TrackMlp(nn.Module):
    def __init__(self, dim_in: int, hidden: int, dim_out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim_in, hidden)
        self.fc2 = nn.Linear(hidden, dim_out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class AttnBlock(nn.Module):
    """The residual runs from norm1(x), not x: upstream reassigns x (kept)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = TorchMHA(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = TrackMlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x):
        x = self.norm1(x)
        x = x + self.attn(x, x, x)
        return x + self.mlp(self.norm2(x))


class CrossAttnBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int = 1, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm_context = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn = TorchMHA(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = TrackMlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, context):
        x = self.norm1(x)
        context = self.norm_context(context)
        x = x + self.cross_attn(x, context, context)
        return x + self.mlp(self.norm2(x))


class EfficientUpdateFormer(nn.Module):
    def __init__(self, cfg: VggtConfig, input_dim: int, output_dim: int):
        super().__init__()
        self.cfg = cfg
        hs = cfg.track_hidden_size
        self.input_norm = nn.LayerNorm(input_dim, eps=1e-5)
        self.input_transform = nn.Linear(input_dim, hs)
        self.virual_tracks = nn.Parameter(torch.zeros(1, cfg.num_virtual_tracks, 1, hs))
        self.time_blocks = nn.ModuleList([AttnBlock(hs, 8) for _ in range(cfg.track_depth)])
        self.space_virtual_blocks = nn.ModuleList(
            [AttnBlock(hs, 8) for _ in range(cfg.track_depth)])
        self.space_point2virtual_blocks = nn.ModuleList(
            [CrossAttnBlock(hs, 8) for _ in range(cfg.track_depth)])
        self.space_virtual2point_blocks = nn.ModuleList(
            [CrossAttnBlock(hs, 8) for _ in range(cfg.track_depth)])
        self.output_norm = nn.LayerNorm(hs, eps=1e-5)
        self.flow_head = nn.Linear(hs, output_dim)

    def forward(self, x):
        cfg = self.cfg
        hs, nv = cfg.track_hidden_size, cfg.num_virtual_tracks
        B, N, T, _ = x.shape
        tokens = self.input_transform(self.input_norm(x))
        init_tokens = tokens
        tokens = torch.cat([tokens, self.virual_tracks.expand(B, nv, T, hs)], dim=1)
        Nv = tokens.shape[1]
        for i in range(cfg.track_depth):
            tokens = self.time_blocks[i](tokens.reshape(B * Nv, T, hs)).reshape(B, Nv, T, hs)
            st = tokens.transpose(1, 2).reshape(B * T, Nv, hs)
            pt, vt = st[:, :Nv - nv], st[:, Nv - nv:]
            vt = self.space_virtual2point_blocks[i](vt, pt)
            vt = self.space_virtual_blocks[i](vt)
            pt = self.space_point2virtual_blocks[i](pt, vt)
            tokens = torch.cat([pt, vt], dim=1).reshape(B, T, Nv, hs).transpose(1, 2)
        tokens = tokens[:, :Nv - nv] + init_tokens
        return self.flow_head(self.output_norm(tokens))


class BaseTrackerPredictor(nn.Module):
    def __init__(self, cfg: VggtConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.track_features
        self.fmap_norm = nn.LayerNorm(C, eps=1e-5)
        self.corr_mlp = TrackMlp(cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2,
                                 cfg.track_hidden_size, C)
        self.updateformer = EfficientUpdateFormer(cfg, 3 * C + 4, C + 2)
        self.query_ref_token = nn.Parameter(torch.zeros(1, 2, 3 * C + 4))
        self.ffeat_norm = nn.GroupNorm(1, C, eps=1e-5)
        self.ffeat_updater = nn.Sequential(nn.Linear(C, C), nn.GELU())
        self.vis_predictor = nn.Sequential(nn.Linear(C, 1))
        self.conf_predictor = nn.Sequential(nn.Linear(C, 1))

    def forward(self, query_points: torch.Tensor, fmaps: torch.Tensor):
        """query_points (B, N, 2) full-resolution pixels; fmaps
        (B, S, Hf, Wf, C) at /stride. Returns (coords list, vis, conf)."""
        cfg = self.cfg
        B, N, _ = query_points.shape
        _, S, HH, WW, C = fmaps.shape
        r = cfg.corr_radius

        fmaps = self.fmap_norm(fmaps)
        coords = (query_points / float(cfg.track_stride))[:, None].expand(B, S, N, 2)
        track_feats = sample_features4d(fmaps[:, 0], coords[:, 0])[:, None].expand(B, S, N, C)
        coords_backup = coords

        pyramid = [fmaps]
        cur = fmaps
        for _ in range(cfg.corr_levels - 1):
            Bc, Sc, Hc, Wc, Cc = cur.shape
            pooled = F.avg_pool2d(cur.reshape(Bc * Sc, Hc, Wc, Cc).permute(0, 3, 1, 2), 2, 2)
            cur = pooled.permute(0, 2, 3, 1).reshape(Bc, Sc, pooled.shape[2], pooled.shape[3], Cc)
            pyramid.append(cur)

        lin = torch.linspace(-r, r, 2 * r + 1, device=fmaps.device)
        ga, gb = torch.meshgrid(lin, lin, indexing="ij")
        # the window's row index drives the x offset, as upstream's order
        delta = torch.stack([ga, gb], dim=-1).reshape(-1, 2)

        pos_grid = get_2d_sincos_pos_embed_grid(3 * C + 4, HH, WW, fmaps.device)
        sampled_pos = sample_features4d(pos_grid[None].expand(B, -1, -1, -1), coords[:, 0])

        def corr_sample(track_feats, coords):
            outs = []
            for lvl, fm in enumerate(pyramid):
                Hl, Wl = fm.shape[2], fm.shape[3]
                corr = torch.einsum("bsnc,bshwc->bsnhw", track_feats, fm) / math.sqrt(C)
                pts = (coords / (2.0 ** lvl)).reshape(B * S * N, 1, 2) + delta[None]
                sampled = bilinear_sample_zero(corr.reshape(B * S * N, Hl, Wl), pts)
                outs.append(sampled.reshape(B, S, N, -1))
            return torch.cat(outs, dim=-1)

        qrt = torch.cat([self.query_ref_token[:, 0:1],
                         self.query_ref_token[:, 1:2].expand(1, S - 1, -1)], dim=1)
        coord_preds = []
        for _ in range(cfg.track_iters):
            coords = coords.detach()
            fcorrs = corr_sample(track_feats, coords)
            fcorrs_ = self.corr_mlp(fcorrs.transpose(1, 2).reshape(B * N, S, -1))
            flows = (coords - coords[:, 0:1]).transpose(1, 2).reshape(B * N, S, 2)
            flows_emb = torch.cat([get_2d_embedding(flows, C // 2),
                                   flows / cfg.track_max_scale,
                                   flows / cfg.track_max_scale], dim=-1)
            track_feats_ = track_feats.transpose(1, 2).reshape(B * N, S, C)
            x = torch.cat([flows_emb, fcorrs_, track_feats_], dim=2)
            x = x + sampled_pos.reshape(B * N, 1, -1) + qrt
            delta_out = self.updateformer(x.reshape(B, N, S, -1)).reshape(B * N, S, -1)
            d_coords = delta_out[:, :, :2]
            d_feats = delta_out[:, :, 2:].reshape(B * N * S, C)
            tf_flat = (self.ffeat_updater(self.ffeat_norm(d_feats))
                       + track_feats_.reshape(B * N * S, C))
            track_feats = tf_flat.reshape(B, N, S, C).transpose(1, 2)
            coords = coords + d_coords.reshape(B, N, S, 2).transpose(1, 2)
            coords = torch.cat([coords_backup[:, :1], coords[:, 1:]], dim=1)
            coord_preds.append(coords * cfg.track_stride)

        tf = track_feats.reshape(B * S * N, C)
        vis = torch.sigmoid(self.vis_predictor(tf).reshape(B, S, N))
        conf = torch.sigmoid(self.conf_predictor(tf).reshape(B, S, N))
        return coord_preds, vis, conf


class TrackHead(nn.Module):
    def __init__(self, cfg: VggtConfig):
        super().__init__()
        self.feature_extractor = VggtDPTHead(cfg, features=cfg.track_features,
                                             feature_only=True, down_ratio=2,
                                             use_pos_embed=False)
        self.tracker = BaseTrackerPredictor(cfg)

    def forward(self, tokens_list, image_hw, query_points):
        fmaps = self.feature_extractor(tokens_list, image_hw)
        return self.tracker(query_points, fmaps)
