"""CroCo ViT encoder and decoder blocks with RoPE2D, the MASt3R trunk
(counterpart of gd3d/models/croco.py).

Names follow the naver dust3r/croco modules (`attn.qkv`, `attn.proj`,
`cross_attn.proj{q,k,v}`, `norm_y`, ...). Self-attention goes through the
flash dispatch (K1); the decoder cross-attention stays a plain einsum
because its head-mean pre-softmax map feeds the distillation cost volume
(as in gd3d, where it is not Pallas either). LayerNorm eps 1e-6, exact GELU.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from gd3d_torch.ops.attention import scaled_dot_attention
from gd3d_torch.parallel.sharding import copy_to_model, model_sum, row_parallel
from gd3d_torch.ops.rope2d import grid_positions, rope2d_qk


@dataclasses.dataclass(frozen=True)
class CrocoConfig:
    """ViT-L/16 encoder + Base decoder (MASt3R_ViTLarge_BaseDecoder_512)."""

    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    mlp_ratio: float = 4.0
    rope_base: float = 100.0
    layernorm_eps: float = 1e-6
    norm_im2_in_dec: bool = True


class CrocoMlp(nn.Module):
    """fc1 -> GELU -> fc2 (column- and row-parallel under tensor
    parallelism, parallel/sharding.py)."""

    TP_KIND = "mlp"
    tp = None

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return row_parallel(self.fc2, F.gelu(self.fc1(copy_to_model(x, self.tp))), self.tp)


class RopeSelfAttention(nn.Module):
    """Fused qkv, RoPE on q and k, flash attention. Under tensor
    parallelism this rank holds num_heads of the heads (qkv sliced by head,
    proj row-parallel)."""

    TP_KIND = "attention"
    tp = None

    def __init__(self, dim: int, num_heads: int, rope_base: float):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, pos):
        B, N, _ = x.shape
        H = self.num_heads
        qkv = self.qkv(copy_to_model(x, self.tp))
        C = qkv.shape[-1] // 3  # this rank's heads' width
        qkv = qkv.reshape(B, N, 3, H, C // H)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        # rope runs on (B, H, N, D); its outputs go back as strided views
        q, k = rope2d_qk(q.transpose(1, 2), pos, k.transpose(1, 2), pos, self.rope_base)
        q, k = q.transpose(1, 2), k.transpose(1, 2)
        out = scaled_dot_attention(q, k, v, scale=(C // H) ** -0.5)
        return row_parallel(self.proj, out.reshape(B, N, C), self.tp)


class RopeCrossAttention(nn.Module):
    """Cross-attention that also exports the head-mean pre-softmax map.
    Under tensor parallelism projq, projk and projv are sliced by head and
    proj is row-parallel; the map is this rank's head sum, summed over the
    model group and divided by the global head count."""

    TP_KIND = "cross_attention"
    tp = None

    def __init__(self, dim: int, num_heads: int, rope_base: float):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, query, key, value, qpos, kpos):
        B, Nq, _ = query.shape
        Nk = key.shape[1]
        H, tp = self.num_heads, self.tp
        q = self.projq(copy_to_model(query, tp))
        C = q.shape[-1]  # this rank's heads' width
        D = C // H
        q = q.reshape(B, Nq, H, D).transpose(1, 2)
        k = self.projk(copy_to_model(key, tp)).reshape(B, Nk, H, D).transpose(1, 2)
        v = self.projv(copy_to_model(value, tp)).reshape(B, Nk, H, D).transpose(1, 2)
        q, k = rope2d_qk(q, qpos, k, kpos, self.rope_base)
        attn = torch.einsum("bhnd,bhmd->bhnm", q * D ** -0.5, k)
        if tp is None:
            attn_map = attn.mean(dim=1).detach()
        else:
            attn_map = model_sum(attn.detach().sum(dim=1), tp) / (H * tp.size)
        out = torch.einsum("bhnm,bhmd->bnhd", torch.softmax(attn, dim=-1), v)
        return row_parallel(self.proj, out.reshape(B, Nq, C), tp), attn_map


class CrocoEncoderBlock(nn.Module):
    def __init__(self, cfg: CrocoConfig):
        super().__init__()
        C = cfg.enc_embed_dim
        self.norm1 = nn.LayerNorm(C, eps=cfg.layernorm_eps)
        self.attn = RopeSelfAttention(C, cfg.enc_num_heads, cfg.rope_base)
        self.norm2 = nn.LayerNorm(C, eps=cfg.layernorm_eps)
        self.mlp = CrocoMlp(C, int(C * cfg.mlp_ratio))

    def forward(self, x, pos):
        x = x + self.attn(self.norm1(x), pos)
        return x + self.mlp(self.norm2(x))


class CrocoDecoderBlock(nn.Module):
    """Self-attention, cross-attention (map exported), MLP."""

    def __init__(self, cfg: CrocoConfig):
        super().__init__()
        C = cfg.dec_embed_dim
        eps = cfg.layernorm_eps
        self.norm1 = nn.LayerNorm(C, eps=eps)
        self.attn = RopeSelfAttention(C, cfg.dec_num_heads, cfg.rope_base)
        self.cross_attn = RopeCrossAttention(C, cfg.dec_num_heads, cfg.rope_base)
        self.norm2 = nn.LayerNorm(C, eps=eps)
        self.norm3 = nn.LayerNorm(C, eps=eps)
        self.norm_y = nn.LayerNorm(C, eps=eps) if cfg.norm_im2_in_dec else None
        self.mlp = CrocoMlp(C, int(C * cfg.mlp_ratio))

    def forward(self, x, y, xpos, ypos):
        x = x + self.attn(self.norm1(x), xpos)
        y_ = self.norm_y(y) if self.norm_y is not None else y
        x_tmp, attn_map = self.cross_attn(self.norm2(x), y_, y_, xpos, ypos)
        x = x + x_tmp
        return x + self.mlp(self.norm3(x)), attn_map


class PatchEmbed(nn.Module):
    def __init__(self, cfg: CrocoConfig):
        super().__init__()
        ps = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.enc_embed_dim, ps, stride=ps)

    def forward(self, imgs_nhwc):
        return self.proj(imgs_nhwc.permute(0, 3, 1, 2))


class CrocoEncoder(nn.Module):
    """Patch embed + RoPE encoder stack + final norm. The modules sit at the
    top level (`patch_embed`, `enc_blocks`, `enc_norm`) as in naver's
    AsymmetricCroCo3DStereo, which subclasses it."""

    def __init__(self, cfg: CrocoConfig):
        super().__init__()
        self.croco_cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.enc_blocks = nn.ModuleList(
            [CrocoEncoderBlock(cfg) for _ in range(cfg.enc_depth)])
        self.enc_norm = nn.LayerNorm(cfg.enc_embed_dim, eps=cfg.layernorm_eps)

    def encode(self, imgs: torch.Tensor):
        """imgs (B, H, W, 3) in [-1, 1] -> (tokens (B, N, C), pos (B, N, 2))."""
        x = self.patch_embed(imgs)
        B, C, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)
        pos = grid_positions(gh, gw, B, device=x.device)
        for blk in self.enc_blocks:
            x = blk(x, pos)
        return self.enc_norm(x), pos
