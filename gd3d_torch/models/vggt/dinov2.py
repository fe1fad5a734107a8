"""DINOv2-L/14 with registers, the VGGT aggregator's patchifier
(counterpart of gd3d/models/vggt/dinov2.py).

cls token + 4 register tokens, an absolute pos embed resized bicubically
with antialias, LayerScale 1.0, exact GELU, final LayerNorm; the output is
the normalized patch tokens. Names follow DinoVisionTransformer
(`patch_embed.proj`, `cls_token`, `pos_embed`, `register_tokens`,
`mask_token`, `blocks.{i}`, `norm`); `mask_token` is in the checkpoint and
unused by the forward.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from gd3d_torch.models.vggt.config import VggtConfig
from gd3d_torch.models.vggt.layers import VggtBlock
from gd3d_torch.models.vit import _bicubic_resize_matrix


def interp_pos_embed(pos_embed: torch.Tensor, grid_hw, num_prefix: int = 1) -> torch.Tensor:
    """pos_embed (1, 1 + M*M, C) -> (1, 1 + gh*gw, C).

    DINOv2's two quirks (the (w, h) unpack in prepare_tokens and the
    (w0, h0) size in interpolate_pos_encoding) cancel, so the grid is
    resized to the plain (gh, gw) layout, with torch's antialiased bicubic.
    A resize runs in fp32 and returns fp32, as gd3d's fp32 matrices promote
    it."""
    gh, gw = grid_hw
    n = pos_embed.shape[1] - num_prefix
    M = int(round(n ** 0.5))
    if (gh, gw) == (M, M):
        return pos_embed
    prefix = pos_embed[:, :num_prefix].float()
    grid = pos_embed[:, num_prefix:].float().reshape(M, M, -1)
    Wh = torch.from_numpy(_bicubic_resize_matrix(M, gh, True)).to(grid.device)
    Ww = torch.from_numpy(_bicubic_resize_matrix(M, gw, True)).to(grid.device)
    grid = torch.einsum("oi,ijc->ojc", Wh, grid)
    grid = torch.einsum("oj,ijc->ioc", Ww, grid)
    return torch.cat([prefix, grid.reshape(1, gh * gw, -1)], dim=1)


class _PatchProj(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class DinoV2(nn.Module):
    def __init__(self, cfg: VggtConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.embed_dim
        self.patch_embed = _PatchProj(C, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed = nn.Parameter(torch.zeros(1, (cfg.img_size // cfg.patch_size) ** 2 + 1, C))
        self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, C))
        self.mask_token = nn.Parameter(torch.zeros(1, C))
        self.blocks = nn.ModuleList([
            VggtBlock(C, cfg.dino_num_heads, 4.0, init_values=cfg.dino_init_values,
                      eps=cfg.layernorm_eps)
            for _ in range(cfg.dino_depth)])
        self.norm = nn.LayerNorm(C, eps=cfg.layernorm_eps)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        """imgs (B, H, W, 3) -> patch tokens (B, gh*gw, C) after the norm."""
        B = imgs.shape[0]
        x = self.patch_embed.proj(imgs.permute(0, 3, 1, 2))
        gh, gw = x.shape[2], x.shape[3]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        # a resized pos-embed is fp32; with the aggregator's weights in bf16
        # (teacher_dtype bfloat16) the tokens stay bf16, where gd3d's would be
        # promoted to fp32 (non-square frames, e.g. ScanNet++'s 350x518)
        x = x + interp_pos_embed(self.pos_embed, (gh, gw)).to(x.dtype)
        # registers go in after the pos-embed add
        x = torch.cat([x[:, :1], self.register_tokens.expand(B, -1, -1).to(x.dtype),
                       x[:, 1:]], dim=1)
        for blk in self.blocks:
            x, _ = blk(x)
        x = self.norm(x)
        return x[:, 1 + self.cfg.num_register_tokens:]
