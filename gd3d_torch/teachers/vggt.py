"""Frozen VGGT teacher (counterpart of gd3d/teachers/vggt.py).

extract_features() runs the aggregator, in bf16 with dtype="bfloat16" (a
bf16 copy of the aggregator's weights only, made per call, as gd3d casts
them inside its step; on non-square frames gd3d's fp32 resized pos-embed
promotes the tokens, and the aggregator then runs in fp32 on the
bf16-rounded weights, models/vggt/dinov2.py), and the camera, depth and
point heads in fp32 without TF32; it returns fp32 features: world point maps unprojected on the
device, the decoded cameras, the depth maps and the layer-mean cross-frame
cost volumes. sample_keypoints() takes co-view masks, NMS keypoints in
view 1 and their track-head correspondences in view 2 from the saved
aggregator tokens, then the border filter. gd3d's torch -> flax converters
have their inverse in gd3d_torch/convert.py::vggt_state_dict.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
from torch.func import functional_call

from gd3d_torch.core.mesh import ModelGroup
from gd3d_torch.models.vggt.config import VggtConfig
from gd3d_torch.models.vggt.heads import pose_encoding_to_extri_intri, unproject_depth_to_world
from gd3d_torch.models.vggt.model import Vggt
from gd3d_torch.models.vit import init_params_
from gd3d_torch.ops.geometry import coview_masks
from gd3d_torch.ops.nms import sample_keypoints_nms
from gd3d_torch.teachers.mast3r import no_tf32


class VggtTeacher(nn.Module):
    TRUNK = ("aggregator.",)  # the parameters teacher_dtype "bfloat16" casts

    def __init__(self, cfg: VggtConfig = VggtConfig(), sp_group: Optional[ModelGroup] = None):
        """sp_group: ring-attention sequence parallelism of the aggregator's
        global attention over this group (gd3d's sp_mesh and sp_axis; the
        train CLI passes the model group, the batch riding the data group)."""
        super().__init__()
        self.cfg = cfg
        sp = None
        if sp_group is not None and sp_group.size > 1:
            from gd3d_torch.parallel.sequence import GroupTransport

            sp = GroupTransport(sp_group)
        self.model = Vggt(cfg, sp)
        self.model.requires_grad_(False)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Seeded random weights (no pretrained checkpoint is in the repo):
        init_params_ for the Linear, conv and LayerNorm weights, and the
        VGGT-specific tokens as gd3d initializes them (camera and register
        tokens N(0, 1e-6), DINOv2 registers 0, the tracker's virtual tracks
        and query token N(0, 1), packed MHA projections Xavier-uniform).
        The generator's device must be the parameters' device."""
        init_params_(self.model, generator)
        agg = self.model.aggregator
        for p in (agg.camera_token, agg.register_token):
            p.normal_(0.0, 1e-6, generator=generator)
        agg.patch_embed.register_tokens.zero_()
        tracker = self.model.track_head.tracker
        tracker.updateformer.virual_tracks.normal_(0.0, 1.0, generator=generator)
        tracker.query_ref_token.normal_(0.0, 1.0, generator=generator)
        for name, p in self.model.named_parameters():
            if name.endswith("in_proj_weight"):
                bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                p.uniform_(-bound, bound, generator=generator)
            elif name.endswith("in_proj_bias"):
                p.zero_()

    @torch.no_grad()
    def spread_depth(self, rgb_vggt: torch.Tensor, log_mean: float = math.log(2.0),
                     log_std: float = 0.5, dtype: Optional[str] = None) -> None:
        """Rescale the depth head's last conv, depth channel, so that on
        these images the log-depth has the given mean and spread. With raw
        random weights the depth map is flat (std ~3e-3 around 1): no
        keypoint pair differs by the ranking threshold (0.05) and the
        intra-depth loss is 0 with no gradient. The conv stays linear, so
        this is only another random init of it (as Mast3rTeacher.face_forward
        does for MASt3R's point cloud)."""
        conv = self.model.depth_head.scratch.output_conv2[2]
        outs = []
        hook = conv.register_forward_hook(lambda m, i, o: outs.append(o[:, 0]))
        try:
            self.extract_features(rgb_vggt, dtype=dtype)
        finally:
            hook.remove()
        mean, std = outs[0].mean(), outs[0].std()
        conv.weight[0] *= log_std / std
        conv.bias[0] = (conv.bias[0] - mean) * log_std / std + log_mean

    @torch.no_grad()
    def extract_features(self, rgb_vggt: torch.Tensor, temperature=1.0,
                         dtype: Optional[str] = None, return_track_tokens: bool = False):
        """rgb_vggt (B, 2, H, W, 3) in [0, 1]. Returns the per-pair feature
        dict (and the aggregator tokens the track head reads)."""
        B, S, H, W, _ = rgb_vggt.shape
        agg = self.model.aggregator
        keep = self.model.head_layers
        with no_tf32():
            if dtype == "bfloat16":
                # parameters stored in bf16 already (a sharded teacher) stay put
                bf16 = {n: p.to(torch.bfloat16) for n, p in agg.named_parameters()
                        if p.dtype != torch.bfloat16}
                args = (rgb_vggt.to(torch.bfloat16),)
                kwargs = {"temperature": temperature, "keep_layers": keep}
                tokens_list, attn = (functional_call(agg, bf16, args, kwargs) if bf16
                                     else agg(*args, **kwargs))
            elif dtype in (None, "float32"):
                tokens_list, attn = agg(rgb_vggt, temperature=temperature, keep_layers=keep)
            else:
                raise ValueError(f"teacher dtype must be float32 or bfloat16, got {dtype!r}")
            out = self.model.heads(tokens_list, attn, (H, W),
                                   return_track_tokens=return_track_tokens)
            extr, intr = pose_encoding_to_extri_intri(out["pose_enc"], (H, W))
            depth = out["depth"][..., 0]  # (B, S, H, W)
            world = unproject_depth_to_world(depth, extr, intr)
        Pp = out["attn"].shape[-1]
        cost = out["attn"].reshape(2, B, Pp, Pp)  # concatenated on the batch axis
        feats = {
            "point_map_view_1": world[:, 0],
            "point_map_view_2": world[:, 1],
            "point_conf_view_1": out["world_points_conf"][:, 0],
            "point_conf_view_2": out["world_points_conf"][:, 1],
            "extrinsic_1": extr[:, 0],
            "extrinsic_2": extr[:, 1],
            "intrinsic_1": intr[:, 0],
            "intrinsic_2": intr[:, 1],
            "depth_pred_1": depth[:, 0],
            "depth_pred_2": depth[:, 1],
            "cost_1": cost[0],
            "cost_2": cost[1],
        }
        if return_track_tokens:
            return feats, out["track_tokens"]
        return feats

    @torch.no_grad()
    def track_from_tokens(self, track_tokens, image_hw, kp_1: torch.Tensor) -> torch.Tensor:
        """kp_1 (B, N, 2) (x, y) in view 1 -> the track head's view-2 points
        (B, N, 2), from the saved aggregator tokens (no second aggregator
        pass)."""
        with no_tf32():
            return self.model.track(track_tokens, image_hw, kp_1)[:, 1]

    @torch.no_grad()
    def sample_keypoints(self, feats: Dict[str, torch.Tensor], rgb_vggt: torch.Tensor,
                         track_tokens, num_keypoints: int = 300, min_distance: int = 5,
                         border: int = 3, priority: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        """Returns kp_1, kp_2 (B, N, 2) float (x, y), valid (B, N) and the
        co-view masks (B, H, W). priority (B, H*W), or None to draw it from
        `generator`."""
        B, S, H, W, _ = rgb_vggt.shape
        kps, valids, masks_1, masks_2 = [], [], [], []
        for b in range(B):
            m1, m2 = coview_masks(feats["point_map_view_1"][b], feats["point_map_view_2"][b],
                                  feats["intrinsic_1"][b], feats["extrinsic_1"][b],
                                  feats["intrinsic_2"][b], feats["extrinsic_2"][b], (H, W))
            kps_yx, valid = sample_keypoints_nms(
                m1, feats["point_conf_view_1"][b], num_keypoints, min_distance,
                priority=None if priority is None else priority[b], generator=generator)
            kps.append(kps_yx.flip(-1).float())  # (y, x) -> (x, y)
            valids.append(valid)
            masks_1.append(m1)
            masks_2.append(m2)
        kp_1 = torch.floor(torch.stack(kps))
        kp_2 = torch.floor(self.track_from_tokens(track_tokens, (H, W), kp_1))

        def in_border(kp):
            return ((kp[..., 0] >= border) & (kp[..., 0] < W - border)
                    & (kp[..., 1] >= border) & (kp[..., 1] < H - border))

        valid = torch.stack(valids) & in_border(kp_1) & in_border(kp_2)
        return kp_1, kp_2, valid, torch.stack(masks_1), torch.stack(masks_2)


@torch.no_grad()
def bias_params_for_live_keypoints(teacher: VggtTeacher) -> None:
    """Pin two small heads of a random-weight teacher, in place, so that
    keypoints survive the co-view, NMS and border filters (gd3d's function
    of the same name, which returns a pinned copy of its tree): the camera
    head's last Linear to an identity pose pushed back 0.25 along z with
    ~57 degree fields of view, and the tracker's flow head to zero deltas
    (kp_2 = kp_1). Every other weight, and every op of the step, is kept."""
    cfg = teacher.cfg
    pose = torch.zeros(9)
    pose[2] = 0.25
    pose[6] = 1.0  # identity quaternion, scalar last
    pose[7:] = 1.0  # fov_h = fov_w = 1 rad
    fc2 = teacher.model.camera_head.pose_branch.fc2
    fc2.weight.zero_()
    # the head accumulates one delta per iteration
    fc2.bias.copy_(pose / cfg.camera_iterations)
    flow = teacher.model.track_head.tracker.updateformer.flow_head
    flow.weight.zero_()
    flow.bias.zero_()
