"""Typed configuration of the ported train step.

Counterpart of gd3d/core/config.py: the same dataclasses with the same field
names and defaults. They are copied rather than imported because importing
gd3d pulls in JAX. The mesh and eval sections of DistillConfig arrive with
the parts of the port that read them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class StudentConfig:
    """timm ViT-B/16 CLIP student with LoRA and adapters (gd3d StudentConfig)."""

    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    patch_size: int = 16
    mlp_ratio: float = 4.0
    pretrain_img_size: int = 384  # pos-embed grid 24x24 (+1 cls)
    num_prefix_tokens: int = 1
    pre_norm: bool = True
    layernorm_eps: float = 1e-5

    lora_rank: int = 4
    lora_start_block: int = 4
    use_adapters: bool = True
    adapter_bottleneck: int = 64

    downsample_factor: int = 8
    target_res: int = 640

    depth_head_hidden: int = 128
    depth_head_tanh: bool = True

    remat: bool = False

    # matmul/conv compute dtype ("float32" | "bfloat16"): bf16 runs the ViT
    # trunk and the depth head under autocast; params, LayerNorms, the
    # residual stream and the losses stay fp32.
    compute_dtype: str = "float32"
    bf16_stream: bool = False

    @property
    def dtype(self) -> torch.dtype:
        if self.compute_dtype == "bfloat16":
            return torch.bfloat16
        if self.compute_dtype == "float32":
            return torch.float32
        raise ValueError(
            f"compute_dtype must be 'float32' or 'bfloat16', got "
            f"{self.compute_dtype!r}"
        )

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def pos_grid(self) -> int:
        return self.pretrain_img_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class LossWeights:
    ap: float = 1.0
    depth: float = 0.0
    intra_depth: float = 1.0
    kl: float = 1.0


@dataclasses.dataclass(frozen=True)
class KeypointConfig:
    capacity: int = 512
    nn_subsample: int = 16
    nn_max_iters: int = 10
    border: int = 3
    min_conf_percentile: float = 10.0
    thres3d_neg: float = 0.1
    thresh3d_pos: float = 5e-3
    nms_num: int = 300
    nms_min_distance: int = 5
    depth_window: int = 3
    depth_rank_threshold: float = 0.05
    ap_sigmoid_temp: float = 0.01


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-5
    weight_decay: float = 1e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip: float = 1.0
    max_epochs: int = 500
    batch_per_device: int = 1
    grad_accum: int = 1
    seed: int = 42
    init_temperature: float = 1.0
    final_temperature: float = 0.5
    ckpt_every_epochs: int = 1
    eval_every_epochs: int = 10


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    teacher: str = "mast3r"
    dataset: str = "scannetpp"
    evaluation_methods: Tuple[str, ...] = (
        "semantic_transfer", "tracking", "pose",
    )
    student: StudentConfig = dataclasses.field(default_factory=StudentConfig)
    loss_weights: LossWeights = dataclasses.field(default_factory=LossWeights)
    keypoints: KeypointConfig = dataclasses.field(default_factory=KeypointConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    teacher_dtype: str = "float32"

    @property
    def student_dtype(self) -> str:
        return self.student.compute_dtype

    def replace(self, **kw) -> "DistillConfig":
        return dataclasses.replace(self, **kw)
