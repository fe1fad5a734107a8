"""CroCo-Stereo / CroCo-Flow: the binocular downstream model with a DPT head
(counterpart of gd3d/models/stereoflow.py; croco_downstream.py:69-122,
head_downstream.py:20-60).

Parameter names follow naver's CroCoDownstreamBinocular state dict
(`patch_embed`, `enc_blocks`, `enc_norm`, `decoder_embed`, `dec_blocks`,
`dec_norm`, `head.dpt.*`), so the released crocostereo.pth / crocoflow.pth
load as they are (`convert_stereoflow`). The pair is encoded as one batch of
2B through the CroCo blocks of gd3d_torch/models/croco.py (K1 forward and
K2 backward through FlashAttention, K5 forward and backward through
RoPE2DQK); every encoder and decoder block's output is kept, and four of
them feed the DPT. The decoder's cross attention stays a plain product, as
in gd3d. Inputs are ImageNet-normalized NHWC images, not dust3r's +-0.5.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch
import torch.nn as nn

from gd3d_torch.models.croco import CrocoConfig, CrocoDecoderBlock, CrocoEncoder
from gd3d_torch.models.dpt import DustDPT
from gd3d_torch.ops.rope2d import grid_positions

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class StereoFlowConfig:
    """Defaults: the released CroCo v2 ViT-L/16 encoder and Base decoder
    (CroCo_V2_ViTLarge_BaseDecoder) that the stereo and flow checkpoints
    fine-tune."""

    croco: CrocoConfig = dataclasses.field(default_factory=CrocoConfig)
    task: str = "stereo"            # 'stereo' (1 channel of disparity) | 'flow' (2)
    with_conf: bool = True          # criterion.with_conf: one more output channel
    hooks: Optional[Tuple[int, int, int, int]] = None  # None: the formula below
    dpt_layer_dims: Tuple[int, int, int, int] = (96, 192, 384, 768)
    dpt_feature_dim: int = 256
    dpt_last_dim: int = 32          # dpt_block.py:319-323

    @property
    def task_channels(self) -> int:
        return {"stereo": 1, "flow": 2}[self.task]

    @property
    def num_out_channels(self) -> int:
        return self.task_channels + int(self.with_conf)

    @property
    def resolved_hooks(self) -> Tuple[int, int, int, int]:
        """head_downstream.py:40-46: 4 hooks over the concatenated
        [enc_blocks..., dec_blocks...] output list."""
        if self.hooks is not None:
            return tuple(self.hooks)
        c = self.croco
        step = {8: 3, 12: 4, 24: 8}[c.dec_depth]
        return tuple(c.dec_depth + c.enc_depth - 1 - i * step for i in range(3, -1, -1))

    @property
    def hook_dims(self) -> Tuple[int, ...]:
        c = self.croco
        return tuple(c.enc_embed_dim if h < c.enc_depth else c.dec_embed_dim
                     for h in self.resolved_hooks)


def normalize_imagenet(img_01: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> ImageNet-normalized (datasets_stereo.py:44)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img_01.dtype, device=img_01.device)
    std = torch.tensor(IMAGENET_STD, dtype=img_01.dtype, device=img_01.device)
    return (img_01 - mean) / std


class PixelwiseTaskWithDPT(nn.Module):
    """head_downstream.py's head: the DPT under `dpt`."""

    def __init__(self, cfg: StereoFlowConfig):
        super().__init__()
        self.dpt = DustDPT(cfg.hook_dims, layer_dims=cfg.dpt_layer_dims,
                           feature_dim=cfg.dpt_feature_dim, last_dim=cfg.dpt_last_dim,
                           out_channels=cfg.num_out_channels)

    def forward(self, hooked, grid_hw):
        return self.dpt(hooked, grid_hw)


class StereoFlow(CrocoEncoder):
    """forward(img1, img2) with (B, H, W, 3) ImageNet-normalized inputs ->
    (pred (B, H, W, task_channels), conf (B, H, W) or None)."""

    def __init__(self, cfg: StereoFlowConfig = StereoFlowConfig()):
        super().__init__(cfg.croco)
        self.cfg = cfg
        c = cfg.croco
        self.decoder_embed = nn.Linear(c.enc_embed_dim, c.dec_embed_dim)
        self.dec_blocks = nn.ModuleList([CrocoDecoderBlock(c) for _ in range(c.dec_depth)])
        self.dec_norm = nn.LayerNorm(c.dec_embed_dim, eps=c.layernorm_eps)
        self.head = PixelwiseTaskWithDPT(cfg)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor):
        cfg = self.cfg
        c = cfg.croco
        B, H, W, _ = img1.shape
        gh, gw = H // c.patch_size, W // c.patch_size

        # encode_image_pairs (croco_downstream.py:94-107): one batch of 2B,
        # every block's output kept, the last one normed (croco.py:160-165)
        x = self.patch_embed(torch.cat([img1, img2], dim=0))
        x = x.flatten(2).transpose(1, 2)
        pos = grid_positions(gh, gw, 2 * B, device=x.device)
        enc_outs = []
        for blk in self.enc_blocks:
            x = blk(x, pos)
            enc_outs.append(x[:B])
        f = self.enc_norm(x)
        enc_outs[-1] = f[:B]
        f1, f2 = f[:B], f[B:]
        p1, p2 = pos[:B], pos[B:]

        # the decoder: img1's stream evolves, img2's stays the projection of
        # its encoder output (the upstream DecoderBlock passes y through)
        g1, g2 = self.decoder_embed(f1), self.decoder_embed(f2)
        dec_outs = []
        for blk in self.dec_blocks:
            g1, _ = blk(g1, g2, p1, p2)
            dec_outs.append(g1)
        dec_outs[-1] = self.dec_norm(dec_outs[-1])

        all_tokens = enc_outs + dec_outs
        out = self.head([all_tokens[h] for h in cfg.resolved_hooks], (gh, gw))
        if cfg.with_conf:
            return out[..., : cfg.task_channels], out[..., cfg.task_channels]
        return out, None


def convert_stereoflow(state: Mapping, cfg: StereoFlowConfig = StereoFlowConfig()):
    """A CroCoDownstreamBinocular state dict (the released crocostereo.pth /
    crocoflow.pth layout, a checkpoint's 'model' entry) as the port's state
    dict: the keys the model has, as float32 tensors. The upstream keys the
    model lacks (refinenet4's resConfUnit1, whose skip input is never given;
    a checkpoint's mask token) are left out; a missing one raises."""
    model_keys = state_keys(cfg)
    missing = [k for k in model_keys if k not in state]
    if missing:
        raise KeyError(f"the state dict lacks {len(missing)} parameters of the model: "
                       f"{missing[:8]}")
    return {k: torch.as_tensor(state[k]).float() for k in model_keys}


def state_keys(cfg: StereoFlowConfig):
    """The model's state-dict keys, from a model on the meta device."""
    with torch.device("meta"):
        return list(StereoFlow(cfg).state_dict())
