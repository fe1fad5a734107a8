"""Student stack: ViT backbone + refine conv + depth head + feature APIs
(counterpart of gd3d/models/student.py: the training steps' surfaces and the
eval harness's, `dense_grid_features` and `get_intermediate_feature`).

Images are NHWC floats in [0, 1] at the public functions, as in gd3d. With
compute_dtype "bfloat16" the ViT trunk and the depth head run under
autocast (bf16 matmuls and convs; LayerNorms, the residual stream and the
refine conv stay fp32), which is gd3d's mixed-precision policy; with
bf16_stream the residual stream is bf16 too, and `remat` recomputes the
blocks in the backward (models/vit.py).

Parameter names: `vit.*` is a timm ViT state dict, `refine_conv.*` and
`depth_diff_head.*` follow the reference checkpoint layout
(gd3d/core/checkpoint.py::export_reference_layout).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gd3d_torch.core.config import StudentConfig
from gd3d_torch.kernels.pairwise_rank import pairwise_ranking_sums
from gd3d_torch.models.vit import DepthDiffHead, ViT
from gd3d_torch.ops.basic import l2_normalize
from gd3d_torch.ops.interpolate import interpolate_features
from gd3d_torch.ops.losses import pairwise_logistic_ranking_loss

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_img(x: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """Channel normalization: CLIP (OpenAI) statistics by default, the
    training-side input transform; the eval harness passes ImageNet's."""
    m = torch.tensor(mean, dtype=x.dtype, device=x.device)
    s = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - m) / s


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(method="bilinear") on NHWC: half-pixel sampling,
    antialiased when it downsamples (hence antialias=True)."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def target_grid(h: int, w: int, target_res: int, downsample: int) -> Tuple[int, int]:
    """Patch grid of the target_res / downsample_factor resize: long side to
    target_res, then integer-divided by downsample."""
    if h > w:
        tgt = (target_res, int(w * target_res / h))
    else:
        tgt = (int(h * target_res / w), target_res)
    return tgt[0] // downsample, tgt[1] // downsample


class Student(nn.Module):
    """ViT + refine conv (gd3d's RefineConv: a 3x3 same-padding conv on NHWC
    features) + depth-difference head. me_interp_quirk: the ME baseline's
    get_feature samples its keypoints with DINO-era 14-px patch constants
    (the reference's finetune_timm_me keeps them; gd3d's flag of the same
    name)."""

    def __init__(self, cfg: StudentConfig, me_interp_quirk: bool = False):
        super().__init__()
        self.cfg = cfg
        self.me_interp_quirk = me_interp_quirk
        C = cfg.embed_dim
        self.vit = ViT(cfg)
        self.refine_conv = nn.Conv2d(C, C, 3, padding=1)
        self.depth_diff_head = DepthDiffHead(C, cfg.depth_head_hidden,
                                             cfg.depth_head_tanh)

    def _autocast(self, device: torch.device):
        return torch.autocast(device.type, dtype=torch.bfloat16,
                              enabled=self.cfg.compute_dtype == "bfloat16")

    # ------------------------------------------------------------ backbone
    def forward_tokens(self, imgs, take_indices=(), final_tokens=True, stride=None):
        """Run the ViT on already-normalized NHWC images, with the patch conv
        at `stride` (default the patch size). When only intermediates are
        tapped, the trunk stops after the deepest tap."""
        n_need = self.cfg.depth
        if not final_tokens and take_indices:
            n_need = max(int(i) % self.cfg.depth for i in take_indices) + 1
        with self._autocast(imgs.device):
            return self.vit(imgs, take_indices=tuple(take_indices),
                            final_tokens=final_tokens, n_layers=n_need, stride=stride)

    def apply_norm(self, tokens: torch.Tensor) -> torch.Tensor:
        """The final LayerNorm alone (the reference's model.norm)."""
        return self.vit.norm(tokens)

    def apply_refine(self, grid_nhwc: torch.Tensor) -> torch.Tensor:
        return self.refine_conv(grid_nhwc.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    # --------------------------------------------------------- feature APIs
    def _resize_for_target(self, rgbs, pts):
        B, H, W, _ = rgbs.shape
        ph, pw = target_grid(H, W, self.cfg.target_res, self.cfg.downsample_factor)
        ps = self.cfg.patch_size
        resized = resize_bilinear(rgbs, (ph * ps, pw * ps))
        factor = torch.tensor([(pw * ps) / W, (ph * ps) / H], dtype=pts.dtype,
                              device=pts.device)
        return resized, ph, pw, pts * factor

    def _interp(self, grid_nhwc, pts, ph, pw, quirk: bool | None = None):
        """Sample the (B, ph, pw, C) grid at pts; the descriptor branches
        take the ME quirk when the student has it, the intermediate-feature
        branch never (quirk=False), as in gd3d."""
        quirk = self.me_interp_quirk if quirk is None else quirk
        ps = 14 if quirk else self.cfg.patch_size
        feat = interpolate_features(grid_nhwc.permute(0, 3, 1, 2), pts, h=ph * ps,
                                    w=pw * ps, normalize=False, patch_size=ps, stride=ps)
        return feat.transpose(1, 2)  # (B, N, C)

    def get_feature(self, rgbs: torch.Tensor, pts: torch.Tensor, normalize: bool = True,
                    global_feature: bool = False):
        """Per-keypoint descriptors after the refine conv: rgbs (B, H, W, 3)
        in [0, 1], pts (B, N, 2) as (x, y) input pixels. Returns (B, N, C),
        L2-normalized when `normalize`, and with global_feature also the
        final class token (B, C)."""
        resized, ph, pw, pts_s = self._resize_for_target(rgbs, pts)
        tokens = self.forward_tokens(normalize_img(resized))["tokens"]
        npfx = self.cfg.num_prefix_tokens
        grid = self.apply_refine(tokens[:, npfx:].reshape(-1, ph, pw, self.cfg.embed_dim))
        feat = self._interp(grid, pts_s, ph, pw)
        if normalize:
            feat = l2_normalize(feat, axis=-1)
        if global_feature:
            return feat, tokens[:, 0]
        return feat

    def get_feature_cost(self, rgbs: torch.Tensor) -> torch.Tensor:
        """Mean of the raw intermediate layers [4, 5, 6, 7] as a
        (B, ph, pw, C) grid (gd3d's normalize=False, which the step uses)."""
        B, H, W, _ = rgbs.shape
        ps = self.cfg.patch_size
        out = self.forward_tokens(normalize_img(rgbs), take_indices=(4, 5, 6, 7),
                                  final_tokens=False)["intermediates"]
        npfx = self.cfg.num_prefix_tokens
        feat = torch.stack([t[:, npfx:] for t in out], 0).mean(0)
        return feat.reshape(B, H // ps, W // ps, self.cfg.embed_dim)

    def get_feature_cost_vggt(self, rgbs: torch.Tensor, vggt_patch: int = 14,
                              layer: int = 7) -> torch.Tensor:
        """VGGT-step cost features: the patch grid follows the teacher's /14
        grid, the images are resized to that grid times the student's patch
        (518^2 -> 37 x 37 patches, 1370 tokens), and the raw intermediate
        layer 7 is tapped (gd3d's normalize=False). Returns (B, ph, pw, C)."""
        B, H, W, _ = rgbs.shape
        ph, pw = H // vggt_patch, W // vggt_patch
        ps = self.cfg.patch_size
        resized = resize_bilinear(rgbs, (ph * ps, pw * ps))
        out = self.forward_tokens(normalize_img(resized), take_indices=(layer,),
                                  final_tokens=False)["intermediates"][0]
        out = out[:, self.cfg.num_prefix_tokens:]
        return out.reshape(B, ph, pw, self.cfg.embed_dim)

    def get_feature_and_intermediates(
        self, rgbs: torch.Tensor, pts: torch.Tensor, n: Sequence[int] = (4, 5, 6, 7),
    ):
        """One forward yielding (desc (B, N, C) L2-normalized refined features
        at pts, kp_feat (B, N, C) mean of normalized intermediates at pts)."""
        resized, ph, pw, pts_s = self._resize_for_target(rgbs, pts)
        out = self.forward_tokens(normalize_img(resized), take_indices=tuple(n),
                                  final_tokens=True)
        C = self.cfg.embed_dim
        npfx = self.cfg.num_prefix_tokens
        grid = self.apply_refine(out["tokens"][:, npfx:].reshape(-1, ph, pw, C))
        desc = l2_normalize(self._interp(grid, pts_s, ph, pw), axis=-1)
        feats = [
            self._interp(self.apply_norm(t)[:, npfx:].reshape(-1, ph, pw, C),
                         pts_s, ph, pw, quirk=False)
            for t in out["intermediates"]
        ]
        return desc, torch.stack(feats, 0).mean(0)

    def get_intermediate_feature(self, rgbs: torch.Tensor, pts: torch.Tensor,
                                 n: Sequence[int] = (0, 1, 2, 3),
                                 return_class_token: bool = False, normalize: bool = True):
        """Keypoint features averaged over the intermediate layers `n`, each
        through the final LayerNorm when `normalize` (no refine conv):
        (B, N, C), and with return_class_token also the layers' mean class
        token (B, C)."""
        resized, ph, pw, pts_s = self._resize_for_target(rgbs, pts)
        out = self.forward_tokens(normalize_img(resized), take_indices=tuple(n),
                                  final_tokens=False)["intermediates"]
        C, npfx = self.cfg.embed_dim, self.cfg.num_prefix_tokens
        feats, prefixes = [], []
        for t in out:
            if normalize:
                t = self.apply_norm(t)
            prefixes.append(t[:, 0])
            feats.append(self._interp(t[:, npfx:].reshape(-1, ph, pw, C), pts_s, ph, pw,
                                      quirk=False))
        feat = torch.stack(feats, 0).mean(0)
        if return_class_token:
            return feat, torch.stack(prefixes, 0).mean(0)
        return feat

    def dense_grid_features(self, imgs: torch.Tensor, stride: int | None = None,
                            refine: bool = True, mean=IMAGENET_MEAN,
                            std=IMAGENET_STD) -> torch.Tensor:
        """The eval harness's dense features: ImageNet-normalized images
        (B, H, W, 3) in [0, 1] through the ViT with the patch conv at
        `stride`, the final tokens as a (B, ph, pw, C) grid, then the refine
        conv when `refine`."""
        ps = self.cfg.patch_size
        st = stride or ps
        B, H, W, _ = imgs.shape
        tokens = self.forward_tokens(normalize_img(imgs, mean, std), stride=st)["tokens"]
        ph, pw = 1 + (H - ps) // st, 1 + (W - ps) // st
        grid = tokens[:, self.cfg.num_prefix_tokens:].reshape(B, ph, pw, self.cfg.embed_dim)
        return self.apply_refine(grid) if refine else grid

    # ----------------------------------------------------------- depth head
    def depth_diff(self, features: torch.Tensor) -> torch.Tensor:
        with self._autocast(features.device):
            return self.depth_diff_head(features)

    def pairwise_score_diff(self, features: torch.Tensor) -> torch.Tensor:
        with self._autocast(features.device):
            return self.depth_diff_head.pairwise_score_diff(features)

    def intra_depth_loss(self, kp_feat_all, kp_depth_all, valid_all,
                         depth_threshold: float, dp=None) -> torch.Tensor:
        """Mean of the two per-view pairwise logistic ranking losses over the
        stacked views (2B, N, ...), through K4 in the form of gd3d's fused
        path (gd3d/models/student.py:430-454): u = feat . W + b in fp32, the
        head's first bias passed again (it commutes with the pair
        subtraction), and the mean of the per-view masked means. The whole
        pair chain is fp32, also when the student computes in bf16. A head
        without tanh takes the plain score path, as in gd3d. Under `dp`
        (core/mesh.py) each view's pair count is the global batch's."""
        B = kp_feat_all.shape[0] // 2
        if self.cfg.depth_head_tanh:
            fin, ln, fout = (self.depth_diff_head.fusion_layer[i] for i in (0, 1, 3))
            u = F.linear(kp_feat_all.float(), fin.weight, fin.bias)
            sums, cnts = pairwise_ranking_sums(
                u, fin.bias, ln.weight, ln.bias, fout.weight[0], fout.bias,
                kp_depth_all, valid_all, depth_threshold)

            def view_mean(s, c):
                tot, cnt = s.sum(), c.sum() if dp is None else dp.count(c.sum())
                return torch.where(cnt > 0, tot / torch.clamp(cnt, min=1.0),
                                   torch.zeros_like(tot))

            return (view_mean(sums[:B], cnts[:B]) + view_mean(sums[B:], cnts[B:])) / 2.0
        score_all = self.pairwise_score_diff(kp_feat_all)
        intra_1 = pairwise_logistic_ranking_loss(
            score_all[:B], kp_depth_all[:B], depth_threshold, valid_all[:B], dp)
        intra_2 = pairwise_logistic_ranking_loss(
            score_all[B:], kp_depth_all[B:], depth_threshold, valid_all[B:], dp)
        return (intra_1 + intra_2) / 2.0


# Only LoRA, adapters, refine_conv and the depth head are trained.
TRAINABLE_MARKERS = ("lora_a_", "lora_b_", "adapter", "refine_conv", "depth_diff_head")


def split_params(student: nn.Module) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """Mark the TRAINABLE_MARKERS parameters requires_grad and freeze the
    rest. Returns (trainable, frozen) name -> parameter dicts."""
    trainable, frozen = {}, {}
    for name, p in student.named_parameters():
        t = any(m in name for m in TRAINABLE_MARKERS)
        p.requires_grad_(t)
        (trainable if t else frozen)[name] = p
    return trainable, frozen
