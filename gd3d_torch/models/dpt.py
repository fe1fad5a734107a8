"""DPT output adapter of the DUSt3R/MASt3R pixelwise heads (counterpart of
gd3d/models/dpt.py).

Names follow naver's dpt_block / dpt_head: `act_postprocess.{i}.{0,1}`,
`scratch.layer{1..4}_rn`, `scratch.refinenet{1..4}.{resConfUnit1,
resConfUnit2,out_conv}`, `head.{0,2,4}`. refinenet4 is called without a skip
input, so its resConfUnit1 is dead upstream and not built here (as in gd3d).
Inputs are token lists, the output is NHWC.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def resize_bilinear_ac(x_nchw: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True."""
    if tuple(x_nchw.shape[-2:]) == tuple(out_hw):
        return x_nchw
    return F.interpolate(x_nchw, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


class ResidualConvUnit(nn.Module):
    """relu-conv-relu-conv + skip."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """Optional skip merge, residual unit, x2 upsample, 1x1 out conv."""

    def __init__(self, features: int, has_skip: bool = True):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features) if has_skip else None
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = resize_bilinear_ac(x, (2 * x.shape[2], 2 * x.shape[3]))
        return self.out_conv(x)


class _Scratch(nn.Module):
    def __init__(self, layer_dims: Sequence[int], features: int):
        super().__init__()
        for i, d in enumerate(layer_dims):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(d, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features, has_skip=i != 4))


class DustDPT(nn.Module):
    """4 token taps -> multiscale pyramid -> fused regression.

    forward(layers: 4 x (B, N, C_i), grid_hw) -> (B, H, W, out_channels)
    with H = grid_h * 16. Hooks carry dims (enc_dim, dec_dim, dec_dim,
    dec_dim); act_postprocess scales x4, x2, x1, /2."""

    def __init__(self, in_dims: Sequence[int], layer_dims: Sequence[int] = (96, 192, 384, 768),
                 feature_dim: int = 256, last_dim: int = 128, out_channels: int = 4):
        super().__init__()
        l0, l1, l2, l3 = layer_dims
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(in_dims[0], l0, 1), nn.ConvTranspose2d(l0, l0, 4, stride=4)),
            nn.Sequential(nn.Conv2d(in_dims[1], l1, 1), nn.ConvTranspose2d(l1, l1, 2, stride=2)),
            nn.Sequential(nn.Conv2d(in_dims[2], l2, 1)),
            nn.Sequential(nn.Conv2d(in_dims[3], l3, 1),
                          nn.Conv2d(l3, l3, 3, stride=2, padding=1)),
        ])
        self.scratch = _Scratch(layer_dims, feature_dim)
        # Identity and ReLU fill the Interpolate / ReLU slots of the upstream
        # Sequential so the conv keys stay head.0, head.2, head.4
        self.head = nn.Sequential(
            nn.Conv2d(feature_dim, feature_dim // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(feature_dim // 2, last_dim, 3, padding=1), nn.ReLU(),
            nn.Conv2d(last_dim, out_channels, 1))

    def forward(self, layers, grid_hw):
        gh, gw = grid_hw
        grids = [t.transpose(1, 2).reshape(t.shape[0], t.shape[-1], gh, gw) for t in layers]
        pyr = [post(g) for post, g in zip(self.act_postprocess, grids)]
        s = self.scratch
        rn = [s.layer1_rn(pyr[0]), s.layer2_rn(pyr[1]), s.layer3_rn(pyr[2]),
              s.layer4_rn(pyr[3])]
        path4 = s.refinenet4(rn[3])[:, :, : rn[2].shape[2], : rn[2].shape[3]]
        path3 = s.refinenet3(path4, rn[2])
        path2 = s.refinenet2(path3, rn[1])
        path1 = s.refinenet1(path2, rn[0])
        x = self.head[0](path1)
        x = resize_bilinear_ac(x, (2 * x.shape[2], 2 * x.shape[3]))
        x = self.head[3](self.head[2](x))
        return self.head[4](x).permute(0, 2, 3, 1)
