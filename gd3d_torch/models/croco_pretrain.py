"""CroCo pretraining: masked cross-view completion (counterpart of
gd3d/models/croco_pretrain.py).

`CrocoPretrain(img1, img2, mask1)` embeds both views, keeps img1's visible
patches (those where mask1 is False, in patch order: one stable argsort of
the mask), runs the shared encoder on them and then on all of img2's
patches, scatters the visible tokens into a canvas of mask tokens, decodes
the canvas against img2's tokens (one direction: the memory is not
updated) and predicts each patch's pixels. `masked_mse` is the loss over
the masked patches. The blocks are the MASt3R trunk's (models/croco.py),
so self-attention runs on K1 / K2 and RoPE on K5, and `croco_to_dust3r`
turns a pretrained state dict into a Mast3r trunk by duplicating the
decoder into `dec_blocks2`. Parameter names follow naver's CroCoNet:
`patch_embed.proj`, `enc_blocks.i`, `enc_norm`, `decoder_embed`,
`mask_token`, `dec_blocks.i`, `dec_norm`, `prediction_head`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from gd3d_torch.models.croco import (
    CrocoConfig,
    CrocoDecoderBlock,
    CrocoEncoderBlock,
    PatchEmbed,
)
from gd3d_torch.ops.rope2d import grid_positions


def random_mask(rng: np.random.RandomState, batch: int, num_patches: int,
                mask_ratio: float) -> np.ndarray:
    """RandomMask's rule, `argsort(noise) < num_mask` on iid uniform noise:
    exactly int(mask_ratio * num_patches) True a row. The noise is the
    host RandomState's, as gd3d's pretraining CLI draws it."""
    num_mask = int(mask_ratio * num_patches)
    noise = rng.rand(batch, num_patches)
    return np.argsort(noise, axis=1, kind="stable") < num_mask


def masked_mse(pred: torch.Tensor, mask: torch.Tensor, target: torch.Tensor,
               norm_pix_loss: bool = False, masked: bool = True,
               count=None) -> torch.Tensor:
    """MaskedMSE: pred / target (B, N, p*p*3), mask (B, N) bool; the mean
    over masked patches (all patches with masked False). With
    norm_pix_loss each target patch is standardised first. `count` maps
    this batch's count of masked patches to the global batch's (data
    parallelism)."""
    if norm_pix_loss:
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, correction=0)
        target = (target - mean) / (var + 1.0e-6) ** 0.5
    loss = ((pred - target) ** 2).mean(dim=-1)
    if masked:
        m = mask.to(loss.dtype)
        n = m.sum() if count is None else count(m.sum())
        return (loss * m).sum() / n
    return loss.mean()


class CrocoPretrain(nn.Module):
    """CroCoNet in pretraining mode: forward(img1, img2, mask1) ->
    (pred, target), images NHWC in [-1, 1], mask1 (B, N) bool with exactly
    int(mask_ratio * N) True a row."""

    def __init__(self, cfg: CrocoConfig, mask_ratio: float = 0.9):
        super().__init__()
        self.cfg = cfg
        self.mask_ratio = mask_ratio
        ps = cfg.patch_size
        self.patch_embed = PatchEmbed(cfg)
        self.enc_blocks = nn.ModuleList([CrocoEncoderBlock(cfg) for _ in range(cfg.enc_depth)])
        self.enc_norm = nn.LayerNorm(cfg.enc_embed_dim, eps=cfg.layernorm_eps)
        self.decoder_embed = nn.Linear(cfg.enc_embed_dim, cfg.dec_embed_dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, cfg.dec_embed_dim))
        self.dec_blocks = nn.ModuleList([CrocoDecoderBlock(cfg) for _ in range(cfg.dec_depth)])
        self.dec_norm = nn.LayerNorm(cfg.dec_embed_dim, eps=cfg.layernorm_eps)
        self.prediction_head = nn.Linear(cfg.dec_embed_dim, ps * ps * 3)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                mask1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        ps = cfg.patch_size
        B, H, W, _ = img1.shape
        gh, gw = H // ps, W // ps
        N = gh * gw
        n_vis = N - int(self.mask_ratio * N)

        x = self.patch_embed(torch.cat([img1, img2], dim=0)).flatten(2).transpose(1, 2)
        x1, x2 = x[:B], x[B:]
        pos = grid_positions(gh, gw, B, device=img1.device)

        # img1's visible tokens in patch order: the False entries first
        order = torch.argsort(mask1.to(torch.int32), dim=1, stable=True)
        vis_idx = order[:, :n_vis]
        bidx = torch.arange(B, device=img1.device)[:, None]
        f1, pos1v = x1[bidx, vis_idx], pos[bidx, vis_idx]
        for blk in self.enc_blocks:  # the masked view, n_vis tokens
            f1 = blk(f1, pos1v)
        f2 = x2
        for blk in self.enc_blocks:  # the full second view, same weights
            f2 = blk(f2, pos)
        v1 = self.decoder_embed(self.enc_norm(f1))
        g2 = self.decoder_embed(self.enc_norm(f2))

        D = cfg.dec_embed_dim
        canvas = self.mask_token.to(v1.dtype).expand(B, N, D)
        out = torch.scatter(canvas, 1, vis_idx[..., None].expand(B, n_vis, D), v1)
        for blk in self.dec_blocks:
            out, _ = blk(out, g2, pos, pos)
        pred = self.prediction_head(self.dec_norm(out))

        # the target patchified in (p, q, c) raster order
        target = img1.reshape(B, gh, ps, gw, ps, 3).permute(0, 1, 3, 2, 4, 5)
        return pred, target.reshape(B, N, ps * ps * 3)


TRUNK_PREFIXES = ("patch_embed.", "enc_blocks.", "enc_norm.", "decoder_embed.", "dec_norm.")


def croco_to_dust3r(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A CrocoPretrain state dict -> the Mast3r / DUSt3R trunk's keys:
    encoder, decoder_embed, dec_norm, and `dec_blocks` duplicated into
    `dec_blocks2`, as the reference loads a CroCo checkpoint into
    AsymmetricCroCo3DStereo. The heads are not in it; mask_token and
    prediction_head are dropped."""
    out = {k: v for k, v in state.items() if k.startswith(TRUNK_PREFIXES)}
    for k, v in state.items():
        if k.startswith("dec_blocks."):
            out[k] = v
            out["dec_blocks2." + k[len("dec_blocks."):]] = v.clone()
    return out
