"""gd3d param trees (numpy leaves) -> gd3d_torch state dicts.

The inverse of gd3d's torch -> flax converters (gd3d/teachers/convert.py
convert_timm_vit, gd3d/teachers/mast3r.py convert_mast3r), extended to the
student leaves those leave out (LoRA, adapters, refine conv, depth head):

  Dense kernel (in, out)                -> Linear weight (out, in)
  Conv kernel (kh, kw, in, out)         -> Conv2d weight (out, in, kh, kw)
  ConvTranspose kernel, spatially flipped -> ConvTranspose2d weight
                                           (in, out, kh, kw), flipped back
  LayerNorm {scale, bias}               -> {weight, bias}
  scan-stacked blocks (leading layer axis: blocks_plain / blocks_adapt,
  enc_blocks, dec_pairs/blk1|blk2)       -> blocks.{i} / enc_blocks.{i} /
                                           dec_blocks.{i}, dec_blocks2.{i}

With them one seeded gd3d init loads into both packages, which is how the
parity tests share weights.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from gd3d_torch.core.config import StudentConfig
from gd3d_torch.models.mast3r import Mast3rConfig


def _leaf(node: Mapping, transpose_conv: bool) -> Dict[str, np.ndarray]:
    if "scale" in node:
        return {"weight": node["scale"], "bias": node["bias"]}
    k = np.asarray(node["kernel"])
    if k.ndim == 2:
        w = k.T
    elif transpose_conv:
        w = k[::-1, ::-1].transpose(2, 3, 0, 1)
    else:
        w = k.transpose(3, 2, 0, 1)
    out = {"weight": w}
    if "bias" in node:
        out["bias"] = node["bias"]
    return out


def _emit(sd: dict, prefix: str, node: Mapping, transpose_conv: bool = False) -> None:
    """Flatten a flax subtree under `prefix`, converting each module leaf.
    Submodule names inside blocks already match the torch names."""
    if "kernel" in node or "scale" in node:
        for k, v in _leaf(node, transpose_conv).items():
            sd[f"{prefix}.{k}"] = v
        return
    for name, child in node.items():
        _emit(sd, f"{prefix}.{name}", child, transpose_conv)


def _index(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _to_torch(sd: dict) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.array(v, np.float32)) for k, v in sd.items()}


def vit_state_dict(vit: Mapping, cfg: StudentConfig, prefix: str = "") -> Dict[str, torch.Tensor]:
    """gd3d ViT tree -> timm-named ViT state dict. Leaves the tree lacks
    (LoRA and adapters in a converted timm checkpoint) are left out."""
    sd: dict = {}
    sd[f"{prefix}cls_token"] = vit["cls_token"]
    sd[f"{prefix}pos_embed"] = vit["pos_embed"]
    _emit(sd, f"{prefix}patch_embed.proj", vit["patch_embed"])
    if "norm_pre" in vit:
        _emit(sd, f"{prefix}norm_pre", vit["norm_pre"])
    _emit(sd, f"{prefix}norm", vit["norm"])
    n_plain = min(cfg.lora_start_block, cfg.depth)
    for i in range(cfg.depth):
        group, j = ("blocks_plain", i) if i < n_plain else ("blocks_adapt", i - n_plain)
        _emit(sd, f"{prefix}blocks.{i}", _index(vit[group], j))
    return _to_torch(sd)


_DEPTH_HEAD = {
    "depth_attn_fc1": "depth_attention.0",
    "depth_attn_fc2": "depth_attention.2",
    "fusion_in": "fusion_layer.0",
    "fusion_ln": "fusion_layer.1",
    "fusion_out": "fusion_layer.3",
}


def student_state_dict(params: Mapping, cfg: StudentConfig) -> Dict[str, torch.Tensor]:
    """gd3d Student.init tree -> gd3d_torch Student state dict."""
    sd = dict(vit_state_dict(params["vit"], cfg, prefix="vit."))
    rest: dict = {}
    _emit(rest, "refine_conv", params["refine_conv"]["conv"])
    for src, dst in _DEPTH_HEAD.items():
        _emit(rest, f"depth_diff_head.{dst}", params["depth_diff_head"][src])
    sd.update(_to_torch(rest))
    return sd


_DPT_ACT = {
    "act_0_proj": ("act_postprocess.0.0", False),
    "act_0_up": ("act_postprocess.0.1", True),
    "act_1_proj": ("act_postprocess.1.0", False),
    "act_1_up": ("act_postprocess.1.1", True),
    "act_2_proj": ("act_postprocess.2.0", False),
    "act_3_proj": ("act_postprocess.3.0", False),
    "act_3_down": ("act_postprocess.3.1", False),
    "head_0": ("head.0", False),
    "head_2": ("head.2", False),
    "head_4": ("head.4", False),
}


def mast3r_state_dict(params: Mapping, cfg: Mast3rConfig = Mast3rConfig()) -> Dict[str, torch.Tensor]:
    """gd3d Mast3rTeacher.init_params tree -> naver-named Mast3r state dict."""
    c = cfg.croco
    sd: dict = {}
    enc = params["encoder"]
    _emit(sd, "patch_embed.proj", enc["patch_embed"])
    _emit(sd, "enc_norm", enc["enc_norm"])
    for i in range(c.enc_depth):
        _emit(sd, f"enc_blocks.{i}", _index(enc["enc_blocks"], i))
    _emit(sd, "decoder_embed", params["decoder_embed"])
    _emit(sd, "dec_norm", params["dec_norm"])
    for i in range(c.dec_depth):
        _emit(sd, f"dec_blocks.{i}", _index(params["dec_pairs"]["blk1"], i))
        _emit(sd, f"dec_blocks2.{i}", _index(params["dec_pairs"]["blk2"], i))
    for hid in (1, 2):
        head = params[f"head{hid}"]
        p = f"downstream_head{hid}"
        dpt = head["dpt"]
        for src, (dst, transposed) in _DPT_ACT.items():
            _emit(sd, f"{p}.dpt.{dst}", dpt[src], transpose_conv=transposed)
        for i in range(4):
            _emit(sd, f"{p}.dpt.scratch.layer{i + 1}_rn", dpt[f"layer_{i}_rn"])
        for i in range(1, 5):
            _emit(sd, f"{p}.dpt.scratch.refinenet{i}", dpt[f"refinenet{i}"])
        _emit(sd, f"{p}.head_local_features.fc1", head["lf_fc1"])
        _emit(sd, f"{p}.head_local_features.fc2", head["lf_fc2"])
    return _to_torch(sd)
