"""gd3d param trees (numpy leaves) -> gd3d_torch state dicts.

The inverse of gd3d's torch -> flax converters (gd3d/teachers/convert.py
convert_timm_vit, gd3d/teachers/mast3r.py convert_mast3r,
gd3d/teachers/vggt.py convert_vggt and convert_vggt_tracker), extended to
the student leaves those leave out (LoRA, adapters, refine conv, depth
head):

  Dense kernel (in, out)                -> Linear weight (out, in)
  Conv kernel (kh, kw, in, out)         -> Conv2d weight (out, in, kh, kw)
  ConvTranspose kernel, spatially flipped -> ConvTranspose2d weight
                                           (in, out, kh, kw), flipped back
  LayerNorm {scale, bias}               -> {weight, bias}
  scan-stacked blocks (leading layer axis: blocks_plain / blocks_adapt,
  enc_blocks, dec_pairs/blk1|blk2,       -> blocks.{i} / enc_blocks.{i} /
  VGGT blocks, aa_pairs/frame|global)      dec_blocks.{i}, dec_blocks2.{i} /
                                           frame_blocks.{i}, global_blocks.{i}

With them one seeded gd3d init loads into both packages, which is how the
parity tests share weights.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from gd3d_torch.core.config import StudentConfig
from gd3d_torch.models.mast3r import Mast3rConfig
from gd3d_torch.models.vggt.config import VggtConfig


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
    Submodule names inside blocks already match the torch names; a bare
    array (a LayerScale gamma, a packed MHA in_proj) is copied as it is."""
    if not isinstance(node, Mapping):
        sd[prefix] = node
        return
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


def _vggt_dpt(sd: dict, prefix: str, tree: Mapping) -> None:
    _emit(sd, f"{prefix}.norm", tree["norm"])
    for i in range(4):
        _emit(sd, f"{prefix}.projects.{i}", tree[f"project_{i}"])
        _emit(sd, f"{prefix}.scratch.layer{i + 1}_rn", tree[f"layer_{i}_rn"])
        _emit(sd, f"{prefix}.scratch.refinenet{i + 1}", tree[f"refinenet{i + 1}"])
    _emit(sd, f"{prefix}.resize_layers.0", tree["resize_0"], transpose_conv=True)
    _emit(sd, f"{prefix}.resize_layers.1", tree["resize_1"], transpose_conv=True)
    _emit(sd, f"{prefix}.resize_layers.3", tree["resize_3"])
    _emit(sd, f"{prefix}.scratch.output_conv1", tree["output_conv1"])
    if "output_conv2_0" in tree:
        _emit(sd, f"{prefix}.scratch.output_conv2.0", tree["output_conv2_0"])
        _emit(sd, f"{prefix}.scratch.output_conv2.2", tree["output_conv2_2"])


def _vggt_dinov2(sd: dict, prefix: str, pe: Mapping, cfg: VggtConfig) -> None:
    for name in ("cls_token", "pos_embed", "register_tokens"):
        sd[f"{prefix}.{name}"] = pe[name]
    sd[f"{prefix}.mask_token"] = np.zeros((1, cfg.embed_dim), np.float32)
    _emit(sd, f"{prefix}.patch_embed.proj", pe["patch_embed"])
    _emit(sd, f"{prefix}.norm", pe["norm"])
    for i in range(cfg.dino_depth):
        _emit(sd, f"{prefix}.blocks.{i}", _index(pe["blocks"], i))


_TRACKER_BLOCKS = (("time_", "time_blocks"), ("space_", "space_virtual_blocks"),
                   ("v2p_", "space_virtual2point_blocks"),
                   ("p2v_", "space_point2virtual_blocks"))


def vggt_state_dict(params: Mapping, cfg: VggtConfig = VggtConfig()) -> Dict[str, torch.Tensor]:
    """gd3d Vggt param tree -> the port's Vggt state dict in the
    facebook/VGGT-1B layout: the inverse of gd3d's convert_vggt and
    convert_vggt_tracker. Unstacks the scanned DINOv2 `blocks` and
    `aa_pairs/frame|global`, keeps the packed MHA in_proj and writes the
    update-former's `virual_tracks`. DINOv2's `mask_token`, which gd3d does
    not carry and no forward reads, is written as zeros."""
    sd: dict = {}
    agg = params["aggregator"]
    sd["aggregator.camera_token"] = agg["camera_token"]
    sd["aggregator.register_token"] = agg["register_token"]
    _vggt_dinov2(sd, "aggregator.patch_embed", agg["patch_embed"], cfg)
    for i in range(cfg.depth):
        _emit(sd, f"aggregator.frame_blocks.{i}", _index(agg["aa_pairs"]["frame"], i))
        _emit(sd, f"aggregator.global_blocks.{i}", _index(agg["aa_pairs"]["global"], i))

    ch = params["camera_head"]
    sd["camera_head.empty_pose_tokens"] = ch["empty_pose_tokens"]
    for name in ("token_norm", "trunk_norm", "embed_pose", "pose_branch"):
        _emit(sd, f"camera_head.{name}", ch[name])
    _emit(sd, "camera_head.poseLN_modulation.1", ch["poseLN_modulation"])
    for i in range(cfg.camera_trunk_depth):
        _emit(sd, f"camera_head.trunk.{i}", ch[f"trunk_{i}"])
    for head in ("depth_head", "point_head"):
        _vggt_dpt(sd, head, params[head])

    _vggt_dpt(sd, "track_head.feature_extractor", params["track_head"]["feature_extractor"])
    tr, p = params["track_head"]["tracker"], "track_head.tracker"
    sd[f"{p}.query_ref_token"] = tr["query_ref_token"]
    for name in ("fmap_norm", "ffeat_norm", "corr_mlp"):
        _emit(sd, f"{p}.{name}", tr[name])
    for name in ("ffeat_updater", "vis_predictor", "conf_predictor"):
        _emit(sd, f"{p}.{name}.0", tr[name])
    uf = tr["updateformer"]
    sd[f"{p}.updateformer.virual_tracks"] = uf["virtual_tracks"]
    for name in ("input_norm", "input_transform", "output_norm", "flow_head"):
        _emit(sd, f"{p}.updateformer.{name}", uf[name])
    for i in range(cfg.track_depth):
        for src, dst in _TRACKER_BLOCKS:
            _emit(sd, f"{p}.updateformer.{dst}.{i}", uf[f"{src}{i}"])
    return _to_torch(sd)
