"""VGGT aggregator: 24 alternating (frame, global) attention layers with the
cross-frame cost-volume export (counterpart of
gd3d/models/vggt/aggregator.py).

DINOv2 patchify; one camera and 4 register tokens per frame (slot 0 for the
first frame, slot 1 for the rest); RoPE positions are the patch grid
shifted by +1, with 0 for the special tokens; frame attention over
(B*S, P), global attention over (B, S*P). At S == 2 every global block
exports its cross-frame map, and the layer mean accumulates in one
(2B, Pp, Pp) fp32 buffer: no per-layer maps are kept.

`sp`, a ring transport (parallel/sequence.py; MeshConfig.sequence_parallel
through VggtTeacher), makes the global blocks' attention ring attention
over the S*P token axis; the frame blocks keep the whole-frame kernel.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch
import torch.nn as nn

from gd3d_torch.models.vggt.config import VggtConfig
from gd3d_torch.models.vggt.dinov2 import DinoV2
from gd3d_torch.models.vggt.layers import VggtBlock
from gd3d_torch.ops.rope2d import grid_positions

_RESNET_MEAN = (0.485, 0.456, 0.406)
_RESNET_STD = (0.229, 0.224, 0.225)


class Aggregator(nn.Module):
    def __init__(self, cfg: VggtConfig, sp=None):
        super().__init__()
        self.cfg = cfg
        C = cfg.embed_dim
        self.patch_embed = DinoV2(cfg)
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, C))
        self.register_token = nn.Parameter(torch.zeros(1, 2, cfg.num_register_tokens, C))

        def block(sp=None):
            return VggtBlock(C, cfg.num_heads, cfg.mlp_ratio, cfg.init_values,
                             qk_norm=cfg.qk_norm, use_rope=True, rope_freq=cfg.rope_freq,
                             eps=cfg.agg_layernorm_eps, sp=sp)

        self.frame_blocks = nn.ModuleList([block() for _ in range(cfg.depth)])
        self.global_blocks = nn.ModuleList([block(sp) for _ in range(cfg.depth)])

    def forward(
        self,
        images: torch.Tensor,
        temperature=1.0,
        keep_layers: Optional[Iterable[int]] = None,
    ) -> Tuple[List[Optional[torch.Tensor]], torch.Tensor]:
        """images (B, S, H, W, 3) in [0, 1]. Returns (tokens_list, attn_mean):
        `depth` entries (B, S, P, 2C), None for layers outside keep_layers
        (all are kept by default), and the (2B, Pp, Pp) head- and
        layer-mean cross-frame attention (zeros unless S == 2)."""
        cfg = self.cfg
        B, S, H, W, _ = images.shape
        C = cfg.embed_dim
        gh, gw = H // cfg.patch_size, W // cfg.patch_size
        mean = torch.tensor(_RESNET_MEAN, dtype=images.dtype, device=images.device)
        std = torch.tensor(_RESNET_STD, dtype=images.dtype, device=images.device)
        x = ((images - mean) / std).reshape(B * S, H, W, 3)
        patch_tokens = self.patch_embed(x)  # (B*S, Pp, C)
        P_patch = patch_tokens.shape[1]

        def slice_expand_flatten(tok):
            first = tok[:, 0:1].expand(B, 1, *tok.shape[2:])
            rest = tok[:, 1:2].expand(B, S - 1, *tok.shape[2:])
            return torch.cat([first, rest], dim=1).reshape(B * S, *tok.shape[2:])

        tokens = torch.cat([
            slice_expand_flatten(self.camera_token).to(patch_tokens.dtype),
            slice_expand_flatten(self.register_token).to(patch_tokens.dtype),
            patch_tokens,
        ], dim=1)
        P = tokens.shape[1]
        psi = cfg.patch_start_idx
        pos_patch = grid_positions(gh, gw, B * S, device=images.device) + 1
        pos_special = torch.zeros((B * S, psi, 2), dtype=pos_patch.dtype, device=images.device)
        pos = torch.cat([pos_special, pos_patch], dim=1)  # (B*S, P, 2)
        gpos = pos.reshape(B, S * P, 2)

        share = torch.tensor(1.0 / cfg.depth, dtype=torch.float32).item()
        keep = set(range(cfg.depth)) if keep_layers is None else set(keep_layers)
        export = S == 2  # the cross-frame map is a pair construct
        attn_mean = torch.zeros((2 * B, P_patch, P_patch), dtype=torch.float32,
                                device=images.device)
        outputs: List[Optional[torch.Tensor]] = [None] * cfg.depth
        for i in range(cfg.depth):
            tokens, _ = self.frame_blocks[i](tokens, pos=pos)
            frame_inter = tokens.reshape(B, S, P, C)
            gtokens, amap = self.global_blocks[i](
                tokens.reshape(B, S * P, C), pos=gpos, return_attn=export,
                temperature=temperature)
            tokens = gtokens.reshape(B * S, P, C)
            if export:
                attn_mean = attn_mean + share * amap.float()
            if i in keep:
                outputs[i] = torch.cat([frame_inter, gtokens.reshape(B, S, P, C)], dim=-1)
        return outputs, attn_mean
