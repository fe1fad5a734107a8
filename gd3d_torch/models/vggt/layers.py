"""VGGT transformer layers: DINOv2-style blocks with LayerScale, qk-norm,
RoPE2D and the cross-frame attention export (counterpart of
gd3d/models/vggt/layers.py).

Attention goes through the flash dispatch (K1, and K2 under autograd);
RoPE through K5. The cross-frame map export stays a plain einsum, as in
gd3d, where it is not Pallas either.

The Linear and LayerNorm layers compute in the promotion of their input's
and their weights' dtypes (models/promote.py): under the bf16 teacher (bf16
weights) fp32 tokens run in fp32 against the bf16-rounded weights, which is
gd3d's route on non-square frames (dinov2.py).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from gd3d_torch.models.promote import LayerNorm, Linear
from gd3d_torch.ops.attention import scaled_dot_attention
from gd3d_torch.ops.rope2d import rope2d_qk


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x):
        return x * self.gamma


class VggtMlp(nn.Module):
    """fc1 -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, out_dim: Optional[int] = None):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim if out_dim is None else out_dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class VggtAttention(nn.Module):
    """Attention with optional qk-norm and RoPE, and the cross-frame map
    export: scores between frame-1 patch queries (tokens s:N/2) and frame-2
    patch keys (N/2+s:) and back, softmaxed at `temperature`, head-meaned,
    concatenated on the batch axis."""

    def __init__(self, dim: int, num_heads: int, qk_norm: bool = False,
                 use_rope: bool = False, rope_freq: float = 100.0, eps: float = 1e-6,
                 special_tokens: int = 5):
        super().__init__()
        self.num_heads = num_heads
        self.use_rope = use_rope
        self.rope_freq = rope_freq
        self.special_tokens = special_tokens
        D = dim // num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.q_norm = LayerNorm(D, eps=eps) if qk_norm else None
        self.k_norm = LayerNorm(D, eps=eps) if qk_norm else None

    def forward(self, x, pos=None, return_attn: bool = False, temperature=1.0):
        B, N, C = x.shape
        H = self.num_heads
        D = C // H
        qkv = self.qkv(x).reshape(B, N, 3, H, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, N, H, D) views
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if self.use_rope and pos is not None:
            q, k = rope2d_qk(q.transpose(1, 2), pos, k.transpose(1, 2), pos, self.rope_freq)
            q, k = q.transpose(1, 2), k.transpose(1, 2)
        scale = D ** -0.5
        out = self.proj(scaled_dot_attention(q, k, v, scale=scale).reshape(B, N, C))

        attn_export = None
        if return_attn:
            s, half = self.special_tokens, N // 2
            qh = (q * scale).transpose(1, 2)  # (B, H, N, D)
            kh = k.transpose(1, 2)
            s1 = torch.einsum("bhnd,bhmd->bhnm", qh[:, :, s:half], kh[:, :, half + s:])
            s2 = torch.einsum("bhnd,bhmd->bhnm", qh[:, :, half + s:], kh[:, :, s:half])
            a1 = torch.softmax(s1 / temperature, dim=-1)
            a2 = torch.softmax(s2 / temperature, dim=-1)
            attn_export = torch.cat([a1.mean(1), a2.mean(1)], dim=0).detach()
        return out, attn_export


class VggtBlock(nn.Module):
    """Pre-norm block with LayerScale. Returns (x, attn map or None)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 init_values: float = 1.0, qk_norm: bool = False,
                 use_rope: bool = False, rope_freq: float = 100.0, eps: float = 1e-6):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=eps)
        self.attn = VggtAttention(dim, num_heads, qk_norm=qk_norm, use_rope=use_rope,
                                  rope_freq=rope_freq, eps=eps)
        self.ls1 = LayerScale(dim, init_values)
        self.norm2 = LayerNorm(dim, eps=eps)
        self.mlp = VggtMlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim, init_values)

    def forward(self, x, pos=None, return_attn: bool = False, temperature=1.0):
        a, attn_map = self.attn(self.norm1(x), pos=pos, return_attn=return_attn,
                                temperature=temperature)
        x = x + self.ls1(a)
        return x + self.ls2(self.mlp(self.norm2(x))), attn_map
