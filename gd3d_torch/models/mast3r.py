"""AsymmetricMASt3R: siamese CroCo encoder, dual cross-decoders and the
catmlp+dpt heads (counterpart of gd3d/models/mast3r.py).

Parameter names follow naver's AsymmetricMASt3R state dict: `patch_embed`,
`enc_blocks`, `enc_norm`, `decoder_embed`, `dec_blocks`, `dec_blocks2`,
`dec_norm`, `downstream_head{1,2}.{dpt,head_local_features}`.

The shared encoder runs once over both images; the two decoder directions
run as one batch of 2B, element order [img2->img1, img1->img2] per pair, as
in gd3d. Landscape frames (W >= H) are assumed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gd3d_torch.models.croco import CrocoConfig, CrocoDecoderBlock, CrocoEncoder
from gd3d_torch.models.dpt import DustDPT
from gd3d_torch.ops.basic import l2_normalize


@dataclasses.dataclass(frozen=True)
class Mast3rConfig:
    croco: CrocoConfig = dataclasses.field(default_factory=CrocoConfig)
    local_feat_dim: int = 24
    two_confs: bool = True
    conf_vmin: float = 1.0
    desc_conf_vmin: float = 0.0
    dpt_feature_dim: int = 256
    dpt_last_dim: int = 128

    @property
    def head_hooks(self) -> Tuple[int, int, int, int]:
        l2 = self.croco.dec_depth
        return (0, l2 * 2 // 4, l2 * 3 // 4, l2)


def pixel_shuffle_nhwc(x: torch.Tensor, r: int) -> torch.Tensor:
    """F.pixel_shuffle on NHWC: channel d*r*r + i*r + j -> pixel
    (h*r + i, w*r + j), channel d."""
    B, h, w, C = x.shape
    d = C // (r * r)
    x = x.reshape(B, h, w, d, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, h * r, w * r, d)


class LocalFeatureMlp(nn.Module):
    def __init__(self, idim: int, hidden: int, odim: int):
        super().__init__()
        self.fc1 = nn.Linear(idim, hidden)
        self.fc2 = nn.Linear(hidden, odim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Mast3rHead(nn.Module):
    """DPT for pts3d + conf, pixel-shuffled MLP for the local features."""

    def __init__(self, cfg: Mast3rConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.croco
        enc, dec = c.enc_embed_dim, c.dec_embed_dim
        self.dpt = DustDPT((enc, dec, dec, dec), feature_dim=cfg.dpt_feature_dim,
                           last_dim=cfg.dpt_last_dim, out_channels=4)
        idim = enc + dec
        nch = (cfg.local_feat_dim + int(cfg.two_confs)) * c.patch_size ** 2
        self.head_local_features = LocalFeatureMlp(idim, 4 * idim, nch)

    def forward(self, hooked_tokens, enc_out, dec_out, grid_hw):
        cfg = self.cfg
        gh, gw = grid_hw
        dpt_out = self.dpt(hooked_tokens, grid_hw)
        lf = self.head_local_features(torch.cat([enc_out, dec_out], dim=-1))
        lf = pixel_shuffle_nhwc(lf.reshape(lf.shape[0], gh, gw, -1), cfg.croco.patch_size)
        out = torch.cat([dpt_out, lf], dim=-1)

        xyz = out[..., 0:3]
        d = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
        pts3d = xyz / torch.clamp(d, min=1e-8) * torch.expm1(d)
        conf = cfg.conf_vmin + torch.exp(out[..., 3])
        desc = l2_normalize(out[..., 4: 4 + cfg.local_feat_dim], axis=-1, eps=0.0)
        # the desc_conf channel (two_confs) feeds nothing in the step
        return {"pts3d": pts3d, "conf": conf, "desc": desc}


class Mast3r(CrocoEncoder):
    """Two-view symmetric inference with cost-volume export."""

    def __init__(self, cfg: Mast3rConfig):
        super().__init__(cfg.croco)
        self.cfg = cfg
        c = cfg.croco
        self.decoder_embed = nn.Linear(c.enc_embed_dim, c.dec_embed_dim)
        self.dec_blocks = nn.ModuleList([CrocoDecoderBlock(c) for _ in range(c.dec_depth)])
        self.dec_blocks2 = nn.ModuleList([CrocoDecoderBlock(c) for _ in range(c.dec_depth)])
        self.dec_norm = nn.LayerNorm(c.dec_embed_dim, eps=c.layernorm_eps)
        self.downstream_head1 = Mast3rHead(cfg)
        self.downstream_head2 = Mast3rHead(cfg)

    def _decoder(self, f1, pos1, f2, pos2):
        """Dual cross decoder: per-layer outputs and head-meaned maps."""
        g1, g2 = self.decoder_embed(f1), self.decoder_embed(f2)
        out1, out2, cams1, cams2 = [f1], [f2], [], []
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            n1, m1 = blk1(g1, g2, pos1, pos2)
            n2, m2 = blk2(g2, g1, pos2, pos1)
            out1.append(n1)
            out2.append(n2)
            cams1.append(m1)
            cams2.append(m2)
            g1, g2 = n1, n2
        out1[-1] = self.dec_norm(out1[-1])
        out2[-1] = self.dec_norm(out2[-1])
        return out1, out2, cams1, cams2

    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                temperature=1.0) -> Dict[str, Dict[str, torch.Tensor]]:
        """img1, img2 (B, H, W, 3) in [-1, 1], W >= H. Returns res1/res2 over
        the symmetrized batch of 2B."""
        B, H, W, _ = img1.shape
        ps = self.cfg.croco.patch_size
        gh, gw = H // ps, W // ps
        feats, pos = self.encode(torch.cat([img1, img2], dim=0))
        f1, f2 = feats[:B], feats[B:]
        p1, p2 = pos[:B], pos[B:]
        v1 = torch.cat([f2, f1], dim=0)
        v2 = torch.cat([f1, f2], dim=0)
        pv1 = torch.cat([p2, p1], dim=0)
        pv2 = torch.cat([p1, p2], dim=0)
        out1, out2, cams1, cams2 = self._decoder(v1, pv1, v2, pv2)

        hooks = self.cfg.head_hooks
        res1 = self.downstream_head1([out1[h] for h in hooks], out1[0], out1[-1], (gh, gw))
        res2 = self.downstream_head2([out2[h] for h in hooks], out2[0], out2[-1], (gh, gw))

        # reciprocity + temperature softmax over the stacked layers; column 0
        # is set to each layer's global min
        m = (torch.stack(cams1, 0) + torch.stack(cams2, 0).transpose(-1, -2)) / 2.0
        m = torch.softmax(m / temperature, dim=-1)
        layer_min = m.amin(dim=(1, 2, 3))
        m[:, :, :, 0] = layer_min[:, None, None]
        res2["tgt_attn_map"] = m.mean(0)
        res2["pts3d_in_other_view"] = res2.pop("pts3d")
        return {"res1": res1, "res2": res2}
