"""Checkpoints: the adapters in the reference's key layout, and the full
restart state (counterpart of gd3d/core/checkpoint.py; torch.save files
where gd3d writes orbax directories).

The reference persists only the adapter state, with the keys
  w_a_%03d / w_b_%03d      LoRA A / B weights (r, dim) / (dim, r)
  state_dict.refine_conv   {'weight', 'bias'}
  depth_diff_head          DepthAwareFeatureFusion.state_dict()
  adapter_%03d             {'down.weight', 'up.weight'}
at the top level of its Lightning checkpoint (refine_conv under
'state_dict'). save_checkpoint writes that nesting, so
load_reference_checkpoint reads the port's own files as well as the
reference's. `trainable` is the student's name -> parameter dict
(models/student.py::split_params), whose names are timm's. Under
data-parallel training (cli/train.py --multihost) every rank holds the same
state: rank 0 alone writes these files, and --resume restores the same file
on every rank.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from gd3d_torch.core.config import StudentConfig
from gd3d_torch.distill.train_state import ClippedAdamW


def _atomic_save(obj, path: str) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _lora_blocks(cfg: StudentConfig):
    return list(range(cfg.lora_start_block, cfg.depth))


def _reference_names(cfg: StudentConfig) -> Dict[str, str]:
    """Reference key -> the student's parameter name. LoRA order is the
    reference's append order (finetune_timm_mast3r.py:118-136): w_a_{2k} is
    the k-th LoRA block's A_q, w_a_{2k+1} its A_v."""
    names = {}
    for k, blk in enumerate(_lora_blocks(cfg)):
        attn = f"vit.blocks.{blk}.attn"
        names[f"w_a_{2 * k:03d}"] = f"{attn}.lora_a_q.weight"
        names[f"w_b_{2 * k:03d}"] = f"{attn}.lora_b_q.weight"
        names[f"w_a_{2 * k + 1:03d}"] = f"{attn}.lora_a_v.weight"
        names[f"w_b_{2 * k + 1:03d}"] = f"{attn}.lora_b_v.weight"
        if cfg.use_adapters:
            for part in ("down", "up"):
                names[f"adapter_{k:03d}.{part}.weight"] = f"vit.blocks.{blk}.adapter.{part}.weight"
    for leaf in ("weight", "bias"):
        names[f"refine_conv.{leaf}"] = f"refine_conv.{leaf}"
    for mod in ("depth_attention.0", "depth_attention.2", "fusion_layer.0",
                "fusion_layer.1", "fusion_layer.3"):
        for leaf in ("weight", "bias"):
            names[f"depth_diff_head.{mod}.{leaf}"] = f"depth_diff_head.{mod}.{leaf}"
    return names


def export_reference_layout(trainable: Mapping[str, torch.Tensor],
                            cfg: StudentConfig) -> Dict[str, np.ndarray]:
    """The trainable tensors under the reference's flat keys (torch layouts:
    Linear (out, in), conv (out, in, kh, kw), which the student keeps)."""
    return {ref: trainable[name].detach().cpu().numpy().copy()
            for ref, name in _reference_names(cfg).items()}


@torch.no_grad()
def import_reference_layout(trainable: Mapping[str, torch.Tensor],
                            flat: Mapping[str, np.ndarray], cfg: StudentConfig):
    """Copy reference-layout tensors into the trainable parameters, in
    place (the inverse of export_reference_layout). Returns `trainable`."""
    for ref, name in _reference_names(cfg).items():
        p = trainable[name]
        p.copy_(torch.as_tensor(np.asarray(flat[ref])).to(p))
    return trainable


def save_checkpoint(path: str, trainable: Mapping[str, torch.Tensor],
                    cfg: StudentConfig) -> None:
    """The adapters alone, nested as the reference's Lightning checkpoint."""
    out: dict = {"state_dict": {"refine_conv": {}}, "depth_diff_head": {}}
    for ref, arr in export_reference_layout(trainable, cfg).items():
        t = torch.from_numpy(arr)
        if ref.startswith(("w_a_", "w_b_")):
            out[ref] = t
        elif ref.startswith("adapter_"):
            block, leaf = ref.split(".", 1)
            out.setdefault(block, {})[leaf] = t
        elif ref.startswith("refine_conv."):
            out["state_dict"]["refine_conv"][ref.split(".", 1)[1]] = t
        else:
            out["depth_diff_head"][ref.split(".", 1)[1]] = t
    _atomic_save(out, path)


def restore_checkpoint(path: str, trainable: Mapping[str, torch.Tensor],
                       cfg: StudentConfig):
    """Load an adapter checkpoint (the port's or the reference's) into the
    trainable parameters, in place."""
    return import_reference_layout(trainable, load_reference_checkpoint(path), cfg)


def load_reference_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference Lightning .ckpt flattened to the reference key layout
    that import_reference_layout consumes: w_a_/w_b_/adapter_/
    depth_diff_head at the top level, refine_conv under 'state_dict'."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    flat: Dict[str, np.ndarray] = {}

    def to_np(t):
        return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)

    def emit(prefix, obj):
        if hasattr(obj, "numpy"):
            flat[prefix] = to_np(obj)
        elif isinstance(obj, dict):
            for k, v in obj.items():
                emit(f"{prefix}.{k}" if prefix else k, v)

    for key, val in ckpt.items():
        if key.startswith(("w_a_", "w_b_")):
            flat[key] = to_np(val)
        elif key.startswith("adapter_"):
            emit(key, val)
        elif key == "depth_diff_head":
            emit("depth_diff_head", val)
        elif key == "state_dict" and isinstance(val, dict) and "refine_conv" in val:
            emit("refine_conv", val["refine_conv"])
    return flat


def save_train_state(path: str, trainable: Mapping[str, torch.Tensor],
                     optimizer: ClippedAdamW, epoch: int,
                     generator: Optional[torch.Generator] = None) -> None:
    """The full restart state: the trainable tensors, AdamW's state with its
    step counts, the accumulation buffer and the step count (inside the
    optimizer's state), the epoch just finished, and the NMS generator's
    state where the step has one."""
    _atomic_save({
        "trainable": {k: p.detach().cpu() for k, p in trainable.items()},
        "optimizer": optimizer.state_dict(),
        "epoch": int(epoch),
        "generator": None if generator is None else generator.get_state(),
    }, path)


@torch.no_grad()
def restore_train_state(path: str, trainable: Mapping[str, torch.Tensor],
                        optimizer: ClippedAdamW,
                        generator: Optional[torch.Generator] = None) -> int:
    """Restore a save_train_state file in place. Returns the next epoch."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    for k, p in trainable.items():
        p.copy_(state["trainable"][k])
    optimizer.load_state_dict(state["optimizer"])
    if generator is not None and state["generator"] is not None:
        generator.set_state(state["generator"])
    return state["epoch"] + 1
