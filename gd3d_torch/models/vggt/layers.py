"""VGGT transformer layers: DINOv2-style blocks with LayerScale, qk-norm,
RoPE2D and the cross-frame attention export (counterpart of
gd3d/models/vggt/layers.py).

Attention goes through the flash dispatch (K1, and K2 under autograd);
RoPE through K5. The cross-frame map export stays a plain einsum, as in
gd3d, where it is not Pallas either.

Under tensor parallelism (parallel/sharding.py) qkv is sliced by head,
fc1 is column- and proj and fc2 row-parallel; the export is this rank's
head sum, summed over the model group and divided by the global H. With
an `sp` transport (the aggregator's global blocks under
MeshConfig.sequence_parallel) attention is ring attention over the token
axis (parallel/sequence.py). The export needs the whole sequence: the
ring is handed the global q and k, and the export is computed from them as
in the plain run.

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
from gd3d_torch.parallel.sharding import (
    copy_to_model, gather_heads, model_sum, row_parallel, split_heads)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x):
        return x * self.gamma


class VggtMlp(nn.Module):
    """fc1 -> exact GELU -> fc2."""

    TP_KIND = "mlp"
    tp = None

    def __init__(self, dim: int, hidden: int, out_dim: Optional[int] = None):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim if out_dim is None else out_dim)

    def forward(self, x):
        return row_parallel(self.fc2, F.gelu(self.fc1(copy_to_model(x, self.tp))), self.tp)


class VggtAttention(nn.Module):
    """Attention with optional qk-norm and RoPE, and the cross-frame map
    export: scores between frame-1 patch queries (tokens s:N/2) and frame-2
    patch keys (N/2+s:) and back, softmaxed at `temperature`, head-meaned,
    concatenated on the batch axis. `sp`, a ring transport
    (parallel/sequence.py), makes the attention ring attention."""

    TP_KIND = "attention"
    tp = None

    def __init__(self, dim: int, num_heads: int, qk_norm: bool = False,
                 use_rope: bool = False, rope_freq: float = 100.0, eps: float = 1e-6,
                 special_tokens: int = 5, sp=None):
        super().__init__()
        self.num_heads = num_heads
        self.sp = sp
        self.use_rope = use_rope
        self.rope_freq = rope_freq
        self.special_tokens = special_tokens
        D = dim // num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.q_norm = LayerNorm(D, eps=eps) if qk_norm else None
        self.k_norm = LayerNorm(D, eps=eps) if qk_norm else None

    def forward(self, x, pos=None, return_attn: bool = False, temperature=1.0):
        B, N, _ = x.shape
        H, tp = self.num_heads, self.tp
        qkv = self.qkv(copy_to_model(x, tp))
        C = qkv.shape[-1] // 3  # this rank's heads' width
        D = C // H
        qkv = qkv.reshape(B, N, 3, H, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, N, H, D) views
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if self.use_rope and pos is not None:
            q, k = rope2d_qk(q.transpose(1, 2), pos, k.transpose(1, 2), pos, self.rope_freq)
            q, k = q.transpose(1, 2), k.transpose(1, 2)
        scale = D ** -0.5
        if self.sp is not None:
            from gd3d_torch.parallel.sequence import ring_attention

            # the ring rides the model group, which holds the heads apart
            att = split_heads(ring_attention(*(gather_heads(t, tp) for t in (q, k, v)),
                                             self.sp, scale), tp)
        else:
            att = scaled_dot_attention(q, k, v, scale=scale)
        out = row_parallel(self.proj, att.reshape(B, N, C), tp)

        attn_export = None
        if return_attn:
            s, half = self.special_tokens, N // 2
            qh = (q * scale).transpose(1, 2)  # (B, H, N, D)
            kh = k.transpose(1, 2)
            s1 = torch.einsum("bhnd,bhmd->bhnm", qh[:, :, s:half], kh[:, :, half + s:])
            s2 = torch.einsum("bhnd,bhmd->bhnm", qh[:, :, half + s:], kh[:, :, s:half])
            a1 = torch.softmax(s1 / temperature, dim=-1)
            a2 = torch.softmax(s2 / temperature, dim=-1)
            if tp is None:
                attn_export = torch.cat([a1.mean(1), a2.mean(1)], dim=0).detach()
            else:
                heads = torch.cat([a1.sum(1), a2.sum(1)], dim=0).detach()
                attn_export = model_sum(heads, tp) / (H * tp.size)
        return out, attn_export


class VggtBlock(nn.Module):
    """Pre-norm block with LayerScale. Returns (x, attn map or None)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 init_values: float = 1.0, qk_norm: bool = False,
                 use_rope: bool = False, rope_freq: float = 100.0, eps: float = 1e-6,
                 sp=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=eps)
        self.attn = VggtAttention(dim, num_heads, qk_norm=qk_norm, use_rope=use_rope,
                                  rope_freq=rope_freq, eps=eps, sp=sp)
        self.ls1 = LayerScale(dim, init_values)
        self.norm2 = LayerNorm(dim, eps=eps)
        self.mlp = VggtMlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim, init_values)

    def forward(self, x, pos=None, return_attn: bool = False, temperature=1.0):
        a, attn_map = self.attn(self.norm1(x), pos=pos, return_attn=return_attn,
                                temperature=temperature)
        x = x + self.ls1(a)
        return x + self.ls2(self.mlp(self.norm2(x))), attn_map
