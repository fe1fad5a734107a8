"""Full VGGT: aggregator + camera / depth / point / track heads
(counterpart of gd3d/models/vggt/model.py).

`forward` runs the aggregator and then `heads`; the teacher calls the two
apart so that the aggregator can run on a bf16 copy of its weights while
the heads run fp32, as gd3d and the reference do. Only the aggregator
layers that some head reads are kept (the camera head's last layer and the
DPT hooks; the track head reads the hooks too).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from gd3d_torch.models.vggt.aggregator import Aggregator
from gd3d_torch.models.vggt.config import VggtConfig
from gd3d_torch.models.vggt.heads import CameraHead, VggtDPTHead
from gd3d_torch.models.vggt.track import TrackHead


class Vggt(nn.Module):
    def __init__(self, cfg: VggtConfig):
        super().__init__()
        self.cfg = cfg
        self.aggregator = Aggregator(cfg)
        self.camera_head = CameraHead(cfg)
        self.depth_head = VggtDPTHead(cfg, output_dim=2, activation="exp")
        self.point_head = VggtDPTHead(cfg, output_dim=4, activation="inv_log")
        self.track_head = TrackHead(cfg)

    @property
    def head_layers(self) -> Tuple[int, ...]:
        """Aggregator layers the heads read."""
        return tuple(sorted({self.cfg.depth - 1, *self.cfg.dpt_hooks}))

    def forward(self, images: torch.Tensor, temperature=1.0,
                query_points: Optional[torch.Tensor] = None, run_track: bool = False,
                return_track_tokens: bool = False) -> Dict:
        """images (B, S, H, W, 3) in [0, 1]."""
        tokens_list, attn = self.aggregator(images, temperature=temperature,
                                            keep_layers=self.head_layers)
        return self.heads(tokens_list, attn, images.shape[2:4], query_points, run_track,
                          return_track_tokens)

    def heads(self, tokens_list: List[Optional[torch.Tensor]], attn: torch.Tensor,
              image_hw, query_points: Optional[torch.Tensor] = None, run_track: bool = False,
              return_track_tokens: bool = False) -> Dict:
        """The fp32 heads on the aggregator's output."""
        H, W = image_hw
        tokens_f32 = [None if t is None else t.float() for t in tokens_list]
        out: Dict = {"attn": attn.float()}
        out["pose_enc"] = self.camera_head(tokens_f32[-1], self.cfg.camera_iterations)
        out["depth"], out["depth_conf"] = self.depth_head(tokens_f32, (H, W))
        out["world_points"], out["world_points_conf"] = self.point_head(tokens_f32, (H, W))
        if run_track and query_points is not None:
            coords, vis, conf = self.track_head(tokens_f32, (H, W), query_points)
            out["track"], out["vis"], out["track_conf"] = coords[-1], vis, conf
        if return_track_tokens:
            out["track_tokens"] = tokens_f32
        return out

    def track(self, track_tokens, image_hw, query_points) -> torch.Tensor:
        """The track head alone on precomputed aggregator tokens -> the last
        iteration's (B, S, N, 2) coords."""
        coords, _, _ = self.track_head(track_tokens, tuple(image_hw), query_points)
        return coords[-1]
