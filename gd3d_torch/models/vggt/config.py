"""VGGT-1B configuration (counterpart of gd3d/models/vggt/config.py; the
facebook/VGGT-1B defaults). Copied rather than imported, as gd3d pulls in
JAX."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VggtConfig:
    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024

    # aggregator (alternating frame / global attention)
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    qk_norm: bool = True
    rope_freq: float = 100.0
    init_values: float = 0.01          # aggregator LayerScale

    # DINOv2-L/14-reg patchifier
    dino_depth: int = 24
    dino_num_heads: int = 16
    dino_init_values: float = 1.0
    # DINOv2 blocks take LayerNorm eps 1e-6; the aggregator's frame/global
    # blocks (and the camera-head trunk) torch's default 1e-5
    layernorm_eps: float = 1e-6
    agg_layernorm_eps: float = 1e-5

    # heads
    camera_trunk_depth: int = 4
    camera_iterations: int = 4
    dpt_features: int = 256
    dpt_out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    dpt_hooks: Tuple[int, ...] = (4, 11, 17, 23)

    # track head
    track_features: int = 128
    track_iters: int = 4
    track_stride: int = 2
    corr_levels: int = 7
    corr_radius: int = 4
    track_hidden_size: int = 384
    track_depth: int = 6
    num_virtual_tracks: int = 64
    track_max_scale: float = 518.0

    @property
    def patch_start_idx(self) -> int:
        return 1 + self.num_register_tokens
