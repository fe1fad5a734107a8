"""ViT-B/16 student backbone with LoRA and bottleneck adapters (counterpart
of gd3d/models/vit.py).

Module and parameter names follow timm's VisionTransformer
(`patch_embed.proj`, `cls_token`, `pos_embed`, `norm_pre`,
`blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}`, `norm`), so
a timm state dict loads as it is. The blocks from `lora_start_block` on add
`attn.lora_{a,b}_{q,v}` and `adapter.{down,up}`. LayerNorm eps 1e-5, exact
GELU, a bias-free patch embed and a `norm_pre` LayerNorm (timm's CLIP
variant). The forward takes NHWC images, like gd3d.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gd3d_torch.core.config import StudentConfig
from gd3d_torch.models.promote import LayerNorm
from gd3d_torch.ops.attention import scaled_dot_attention


def init_params_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in the style of torch's defaults: Linear and conv weights
    and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), LayerNorms at identity.
    ViT specifics as in gd3d: zero cls token and LoRA B, pos embed
    N(0, 0.02). The generator's device must be the parameters' device."""
    with torch.no_grad():
        for name, mod in module.named_modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = nn.init._calculate_fan_in_and_fan_out(mod.weight)[0]
                bound = 1.0 / math.sqrt(fan_in)
                mod.weight.uniform_(-bound, bound, generator=generator)
                if mod.bias is not None:
                    mod.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(mod, nn.LayerNorm) and mod.weight is not None:
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "cls_token" or ".lora_b_" in name:
                p.zero_()
            elif leaf == "pos_embed":
                p.normal_(0.0, 0.02, generator=generator)


def _cubic_kernel(x: float, a: float = -0.75) -> float:
    ax = abs(x)
    if ax <= 1.0:
        return (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0
    if ax < 2.0:
        return a * ax ** 3 - 5.0 * a * ax ** 2 + 8.0 * a * ax - 4.0 * a
    return 0.0


@functools.lru_cache(maxsize=32)
def _bicubic_resize_matrix(in_size: int, out_size: int, antialias: bool = False) -> np.ndarray:
    """(out, in) matrix of F.interpolate(bicubic, align_corners=False):
    half-pixel sampling, a = -0.75, border taps replicated. With antialias
    and a downscale, torch's antialiased filter instead: cubic with
    a = -0.5, support stretched by the scale, taps clamped to the valid
    range and renormalized (as gd3d's matrix)."""
    W = np.zeros((out_size, in_size), np.float32)
    scale = in_size / out_size
    if antialias and scale > 1.0:
        support = 2.0 * scale
        for o in range(out_size):
            center = scale * (o + 0.5)
            lo = max(0, int(center - support + 0.5))
            hi = min(in_size, int(center + support + 0.5))
            ws = np.array([_cubic_kernel((t + 0.5 - center) / scale, a=-0.5)
                           for t in range(lo, hi)])
            if ws.sum() > 0:
                ws = ws / ws.sum()
            W[o, lo:hi] = ws
        return W
    for o in range(out_size):
        src = (o + 0.5) * scale - 0.5
        f = int(np.floor(src))
        t = src - f
        for tap in range(f - 1, f + 3):
            W[o, min(max(tap, 0), in_size - 1)] += _cubic_kernel(t - (tap - f))
    return W


def resample_pos_embed(
    pos_embed: torch.Tensor,
    new_grid: Tuple[int, int],
    num_prefix_tokens: int = 1,
) -> torch.Tensor:
    """Bicubic-resample the (1, prefix + P, C) pos embed to a new patch grid
    (timm resample_abs_pos_embed); prefix tokens pass through."""
    prefix = pos_embed[:, :num_prefix_tokens]
    patch = pos_embed[:, num_prefix_tokens:]
    old = int(round(patch.shape[1] ** 0.5))
    gh, gw = new_grid
    if (gh, gw) == (old, old):
        return pos_embed
    grid = patch.reshape(old, old, -1)
    Wh = torch.from_numpy(_bicubic_resize_matrix(old, gh)).to(pos_embed)
    Ww = torch.from_numpy(_bicubic_resize_matrix(old, gw)).to(pos_embed)
    grid = torch.einsum("oi,ijc->ojc", Wh, grid)
    grid = torch.einsum("oj,ijc->ioc", Ww, grid)
    return torch.cat([prefix, grid.reshape(1, gh * gw, -1)], dim=1)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    """timm attention with optional LoRA deltas on the q and v thirds."""

    def __init__(self, dim: int, num_heads: int, lora_rank: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.lora_rank = lora_rank
        if lora_rank > 0:
            self.lora_a_q = nn.Linear(dim, lora_rank, bias=False)
            self.lora_b_q = nn.Linear(lora_rank, dim, bias=False)
            self.lora_a_v = nn.Linear(dim, lora_rank, bias=False)
            self.lora_b_v = nn.Linear(lora_rank, dim, bias=False)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x)
        if self.lora_rank > 0:
            new_q = self.lora_b_q(self.lora_a_q(x))
            new_v = self.lora_b_v(self.lora_a_v(x))
            qkv = torch.cat([qkv[..., :C] + new_q, qkv[..., C: 2 * C],
                             qkv[..., 2 * C:] + new_v], dim=-1)
        H = self.num_heads
        qkv = qkv.reshape(B, N, 3, H, C // H)
        # (B, N, H, D) strided views: the flash kernel reads them in place
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = scaled_dot_attention(q, k, v, scale=(C // H) ** -0.5)
        return self.proj(out.reshape(B, N, C))


class Adapter(nn.Module):
    """Serial bottleneck adapter: up(relu(down(x)))."""

    def __init__(self, dim: int, bottleneck: int):
        super().__init__()
        self.down = nn.Linear(dim, bottleneck, bias=False)
        self.up = nn.Linear(bottleneck, dim, bias=False)

    def forward(self, x):
        return self.up(F.relu(self.down(x)))


class Block(nn.Module):
    def __init__(self, cfg: StudentConfig, lora: bool = False, adapter: bool = False):
        super().__init__()
        C = cfg.embed_dim
        self.norm1 = LayerNorm(C, eps=cfg.layernorm_eps)
        self.attn = Attention(C, cfg.num_heads, cfg.lora_rank if lora else 0)
        self.norm2 = LayerNorm(C, eps=cfg.layernorm_eps)
        self.mlp = Mlp(C, int(C * cfg.mlp_ratio))
        self.adapter = Adapter(C, cfg.adapter_bottleneck) if adapter else None

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        x = x + self.mlp(self.norm2(x))
        if self.adapter is not None:
            x = x + self.adapter(x)
        return x


class PatchEmbed(nn.Module):
    def __init__(self, cfg: StudentConfig):
        super().__init__()
        ps = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.embed_dim, ps, stride=ps, bias=not cfg.pre_norm)

    def forward(self, imgs_nhwc, stride: Optional[int] = None):
        """The patch conv at `stride` (default: the patch size; the eval's
        tracking features take patch / 2, overlapping patches)."""
        x = imgs_nhwc.permute(0, 3, 1, 2)
        if stride is None or stride == self.proj.stride[0]:
            return self.proj(x)
        return F.conv2d(x, self.proj.weight, self.proj.bias, stride=stride)


class ViT(nn.Module):
    """ViT-B/16 trunk. forward(imgs NHWC, channel-normalized) -> dict with
    'tokens' (B, 1+P, C) after the final LayerNorm (when final_tokens) and
    'intermediates', the raw block outputs at take_indices. `stride` is the
    patch conv's (default the patch size); the position embedding is
    resampled to whatever grid it gives.

    n_layers runs only the first n_layers blocks (the caller's truncation
    when it taps intermediates only).

    cfg.remat recomputes each block's activations in the backward
    (torch.utils.checkpoint around each block call, gd3d's nn.remat of the
    scanned block): K1 then runs twice for a block that takes a gradient.
    cfg.bf16_stream with compute_dtype "bfloat16" carries the residual
    stream, and so the residual adds and the tapped intermediates, in bf16
    after norm_pre; the LayerNorms still compute and emit fp32, promoting
    their input to their fp32 weights as gd3d's do (models/promote.py)."""

    def __init__(self, cfg: StudentConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.pos_grid ** 2 + cfg.num_prefix_tokens, C))
        self.norm_pre = (LayerNorm(C, eps=cfg.layernorm_eps)
                         if cfg.pre_norm else None)
        n_plain = min(cfg.lora_start_block, cfg.depth)
        self.blocks = nn.ModuleList(
            [Block(cfg, lora=i >= n_plain, adapter=i >= n_plain and cfg.use_adapters)
             for i in range(cfg.depth)])
        self.norm = LayerNorm(C, eps=cfg.layernorm_eps)

    def forward(
        self,
        imgs: torch.Tensor,
        take_indices: Sequence[int] = (),
        final_tokens: bool = True,
        n_layers: Optional[int] = None,
        stride: Optional[int] = None,
    ) -> dict:
        cfg = self.cfg
        B = imgs.shape[0]
        x = self.patch_embed(imgs, stride)
        gh, gw = x.shape[2], x.shape[3]
        x = x.flatten(2).transpose(1, 2)
        pos = resample_pos_embed(self.pos_embed, (gh, gw), cfg.num_prefix_tokens)
        # the residual stream is fp32 whatever the compute dtype, unless
        # bf16_stream asks for bf16 after norm_pre
        x = torch.cat([self.cls_token.expand(B, -1, -1), x.float()], dim=1)
        x = x + pos
        if self.norm_pre is not None:
            x = self.norm_pre(x)
        if cfg.bf16_stream and cfg.compute_dtype == "bfloat16":
            x = x.to(torch.bfloat16)
        n_layers = cfg.depth if n_layers is None else n_layers
        want = {int(i) % cfg.depth for i in take_indices}
        taps = {}
        remat = cfg.remat and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks[:n_layers]):
            x = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
            if i in want:
                taps[i] = x
        out = {"intermediates": tuple(taps[int(i) % cfg.depth] for i in take_indices)}
        if final_tokens:
            out["tokens"] = self.norm(x)
        return out


class DepthDiffHead(nn.Module):
    """DepthAwareFeatureFusion: fusion Linear(C->hidden) -> LayerNorm(1e-5)
    -> GELU -> Linear(hidden->1), optional tanh. Reference key names:
    depth_attention.{0,2}, fusion_layer.{0,1,3}. The depth_attention
    parameters exist for the checkpoint layout only: the training pipeline
    always calls the feature-only path, so they receive no gradient (AdamW
    still decays them, as optax does)."""

    def __init__(self, input_dim: int, hidden_dim: int = 128, use_tanh: bool = True):
        super().__init__()
        self.use_tanh = use_tanh
        self.depth_attention = nn.Sequential(
            nn.Linear(1, hidden_dim), nn.GELU(), nn.Linear(hidden_dim, input_dim))
        self.fusion_layer = nn.Sequential(
            nn.Linear(input_dim, hidden_dim), nn.LayerNorm(hidden_dim, eps=1e-5),
            nn.GELU(), nn.Linear(hidden_dim, 1))

    def _fusion_tail(self, h):
        h = F.gelu(self.fusion_layer[1](h))
        out = self.fusion_layer[3](h)[..., 0].float()
        return torch.tanh(out) if self.use_tanh else out

    def forward(self, features):
        return self._fusion_tail(self.fusion_layer[0](features))

    def pairwise_score_diff(self, features: torch.Tensor) -> torch.Tensor:
        """score[b, i, j] = head(features_j - features_i). The first Linear
        commutes with the subtraction, so each point is projected once and
        the differences are formed in the hidden dim."""
        fusion_in = self.fusion_layer[0]
        u = fusion_in(features)
        bias = fusion_in.bias.to(u.dtype)
        diff = u[:, None, :, :] - u[:, :, None, :] + bias
        return self._fusion_tail(diff)
