"""Typed configuration of the ported train step.

Counterpart of gd3d/core/config.py: the same dataclasses with the same field
names and defaults, the named configs and the bundled YAML files
(gd3d_torch/configs/*.yaml). They are copied rather than imported because
importing gd3d pulls in JAX. The mesh and eval sections are kept for field
parity; the port runs on one card and refuses the options that need more
(gd3d_torch/cli/train.py).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import torch

from gd3d_torch.core.yaml_reader import read_yaml


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
class MeshConfig:
    """gd3d's device-mesh fields, as gd3d's train CLI reads them: the ranks
    of torch.distributed form a data x model mesh (gd3d_torch/core/mesh.py;
    `data` is world // model there, as in gd3d); fsdp_teacher shards the
    frozen teacher over the data group (gd3d_torch/parallel/fsdp.py), after
    slicing it tensor-parallel over the model group when model > 1
    (parallel/sharding.py); sequence_parallel runs the VGGT teacher's global
    attention as ring attention over the model group (parallel/sequence.py)."""

    data: int = -1
    model: int = 1
    sequence_parallel: bool = False
    fsdp_teacher: bool = False


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """gd3d's eval-harness constants, which gd3d_torch/eval reads."""

    pck_img_size: int = 640
    pck_alphas: Tuple[float, ...] = (0.10, 0.05, 0.15)
    tracking_size: Tuple[int, int] = (476, 854)
    tracking_stride: int = 8
    tracking_num_videos: int = 30
    anchor_cos_threshold: float = 0.7
    cos_threshold: float = 0.6
    argmax_radius: int = 35
    pose_reproj_px: float = 8.0
    pose_ransac_iters: int = 10000
    pose_grid_stride: int = 4
    pose_template_cap: int = 120_000
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    teacher: str = "mast3r"  # mast3r | vggt | me
    dataset: str = "scannetpp"
    evaluation_methods: Tuple[str, ...] = (
        "semantic_transfer", "tracking", "pose",
    )
    student: StudentConfig = dataclasses.field(default_factory=StudentConfig)
    loss_weights: LossWeights = dataclasses.field(default_factory=LossWeights)
    keypoints: KeypointConfig = dataclasses.field(default_factory=KeypointConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    teacher_dtype: str = "float32"

    @property
    def student_dtype(self) -> str:
        return self.student.compute_dtype

    def replace(self, **kw) -> "DistillConfig":
        return dataclasses.replace(self, **kw)


def me_objaverse() -> DistillConfig:
    """finetune_timm_me_objaverse: LoRA on the last 4 blocks, no adapters,
    the AP loss alone."""
    return DistillConfig(
        teacher="me",
        dataset="objaverse",
        student=StudentConfig(lora_start_block=8, use_adapters=False),
        loss_weights=LossWeights(ap=1.0, depth=0.0, intra_depth=0.0, kl=0.0),
    )


def mast3r_scannetpp() -> DistillConfig:
    return DistillConfig(teacher="mast3r", dataset="scannetpp")


def mast3r_objaverse() -> DistillConfig:
    return DistillConfig(teacher="mast3r", dataset="objaverse")


def vggt_scannetpp() -> DistillConfig:
    """finetune_timm_vggt_scannetpp: all four losses weighted 1, the
    teacher's aggregator in bf16."""
    return DistillConfig(
        teacher="vggt",
        dataset="scannetpp",
        loss_weights=LossWeights(ap=1.0, depth=1.0, intra_depth=1.0, kl=1.0),
        teacher_dtype="bfloat16",
    )


def vggt_objaverse() -> DistillConfig:
    return vggt_scannetpp().replace(dataset="objaverse")


NAMED_CONFIGS = {
    "finetune_timm_me_objaverse": me_objaverse,
    "finetune_timm_mast3r_scannetpp": mast3r_scannetpp,
    "finetune_timm_mast3r_objaverse": mast3r_objaverse,
    "finetune_timm_vggt_scannetpp": vggt_scannetpp,
    "finetune_timm_vggt_objaverse": vggt_objaverse,
}


def load_yaml_config(path: str) -> DistillConfig:
    """One of the bundled YAMLs (the reference's config/*.yaml): `matcher`
    and `dataset` select the NAMED_CONFIGS factory, which supplies every
    other hyper-parameter, and `evaluation_methods` overrides its list."""
    raw = read_yaml(path)
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: cannot read a config that is no mapping")
    matcher = raw.get("matcher", "mast3r")
    dataset = raw.get("dataset", "scannetpp")
    name = f"finetune_timm_{matcher}_{dataset}"
    if name not in NAMED_CONFIGS:
        raise ValueError(
            f"{path}: no named config for matcher={matcher!r} "
            f"dataset={dataset!r} (expected one of {sorted(NAMED_CONFIGS)})")
    cfg = NAMED_CONFIGS[name]()
    methods = raw.get("evaluation_methods")
    if methods is not None:
        if isinstance(methods, str):
            raise ValueError(f"{path}: evaluation_methods must be a list")
        cfg = cfg.replace(evaluation_methods=tuple(methods))
    return cfg


def bundled_config_path(name: str) -> str:
    """Where the bundled config `name` lies (gd3d_torch/configs/<name>.yaml)."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", f"{name}.yaml")


def resolve_config(name_or_path: str) -> DistillConfig:
    """A NAMED_CONFIGS key, a bundled config name
    (gd3d_torch/configs/<name>.yaml) or an explicit .yaml path."""
    if name_or_path.endswith((".yaml", ".yml")):
        return load_yaml_config(name_or_path)
    bundled = bundled_config_path(name_or_path)
    if os.path.exists(bundled):
        return load_yaml_config(bundled)
    return NAMED_CONFIGS[name_or_path]()
