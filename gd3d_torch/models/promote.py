"""Linear and LayerNorm layers that compute in the promotion of their
input's and their weights' dtypes, as flax's Dense and LayerNorm (with no
dtype set) do in gd3d, whatever autocast's lists say on the device.

Where gd3d's bf16 weights meet fp32 activations (the VGGT teacher on
non-square frames) the layer runs in fp32 on the bf16-rounded weights;
where bf16 activations meet fp32 LayerNorm weights (the student's bf16
residual stream) the norm computes and emits fp32. With equal dtypes they
are nn.Linear and nn.LayerNorm.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Linear):
    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.layer_norm(x.to(dt), self.normalized_shape, self.weight.to(dt),
                            self.bias.to(dt), self.eps)
