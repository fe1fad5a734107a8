"""Frozen MASt3R teacher (counterpart of gd3d/teachers/mast3r.py).

extract_features() runs the symmetric inference under no_grad and indexes
the symmetrized batch as gd3d does: for each pair, the [B:] half is the
img1->img2 direction and the [:B] half the img2->img1 direction. The
teacher runs fp32 without TF32, whatever the process-wide switches say:
cuDNN rounds fp32 conv operands to TF32 by default.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch
import torch.nn as nn

from gd3d_torch.models.mast3r import Mast3r, Mast3rConfig
from gd3d_torch.models.vit import init_params_


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """Run fp32 matmuls and convs in full fp32 (no TF32) inside the block,
    and restore the caller's switches after it."""
    matmul = torch.get_float32_matmul_precision()
    conv = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul)
        torch.backends.cudnn.allow_tf32 = conv


class Mast3rTeacher(nn.Module):
    def __init__(self, cfg: Mast3rConfig = Mast3rConfig()):
        super().__init__()
        self.cfg = cfg
        self.model = Mast3r(cfg)
        self.model.requires_grad_(False)

    def init_params(self, generator: torch.Generator) -> None:
        """Seeded random weights (no pretrained checkpoint is in the repo)."""
        init_params_(self.model, generator)

    @torch.no_grad()
    def face_forward(self, rgb_mast3r_1: torch.Tensor, rgb_mast3r_2: torch.Tensor,
                     z_mean: float = 2.0) -> None:
        """Rescale both DPT heads' xyz output channels so that, on these
        images, each of x, y, z has unit spread around (0, 0, z_mean). With
        raw random weights the point cloud lies behind the camera or
        projects onto a few central pixels, the keypoints read depth 0, and
        the intra-depth loss is 0 with no gradient. The last conv stays
        linear, so this is only another random init of it."""
        heads = (self.model.downstream_head1, self.model.downstream_head2)
        outs = []
        hooks = [h.dpt.head[4].register_forward_hook(lambda m, i, o: outs.append(o))
                 for h in heads]
        try:
            self.extract_features(rgb_mast3r_1, rgb_mast3r_2)
        finally:
            for hook in hooks:
                hook.remove()
        for head, out in zip(heads, outs):
            xyz = out[:, :3]  # (2B, 3, H, W): NCHW inside the head
            mean, std = xyz.mean(dim=(0, 2, 3)), xyz.std(dim=(0, 2, 3))
            conv = head.dpt.head[4]
            conv.weight[:3] /= std[:, None, None, None]
            conv.bias[:3] = (conv.bias[:3] - mean) / std
            conv.bias[2] += z_mean

    @torch.no_grad()
    def extract_features(
        self,
        rgb_mast3r_1: torch.Tensor,
        rgb_mast3r_2: torch.Tensor,
        temperature=1.0,
        dtype: str | None = None,
    ) -> Dict[str, torch.Tensor]:
        """Images (B, H, W, 3) in [-1, 1], W >= H. Returns desc_1/2,
        pts3d_1, pts3d_2_from_1, pts3d_2, conf_1/2 (B, H, W, ...) and
        cost_1/2 (B, N, N). The trunk runs fp32 (gd3d's teacher_dtype
        "bfloat16" option is not ported yet), without TF32."""
        if dtype not in (None, "float32"):
            raise NotImplementedError(f"teacher dtype {dtype!r} is not ported yet")
        B = rgb_mast3r_1.shape[0]
        with no_tf32():
            out = self.model(rgb_mast3r_1, rgb_mast3r_2, temperature)
        res1, res2 = out["res1"], out["res2"]
        return {
            "desc_1": res1["desc"][B:],
            "desc_2": res2["desc"][B:],
            "pts3d_1": res1["pts3d"][B:],
            "pts3d_2_from_1": res2["pts3d_in_other_view"][B:],
            "pts3d_2": res1["pts3d"][:B],
            "conf_1": res1["conf"][B:],
            "conf_2": res1["conf"][:B],
            "cost_1": res2["tgt_attn_map"][B:],
            "cost_2": res2["tgt_attn_map"][:B],
        }
