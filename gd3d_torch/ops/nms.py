"""Max-pool NMS keypoint sampling with a fixed output size (counterpart of
gd3d/ops/nms.py).

Local maxima of the masked confidence map get a random priority, and the
`num` highest priorities are taken, with a validity mask. The priority is a
uniform draw from an explicit torch.Generator, or is given by the caller
(the tests hand in gd3d's jax.random draw: the two generators give other
numbers from one seed, and then other keypoints). Ties (the -1 of every
non-maximum) resolve to the lower index, as jax.lax.top_k does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def sample_keypoints_nms(
    mask: torch.Tensor,
    conf: torch.Tensor,
    num: int,
    min_distance: int,
    priority: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask (H, W) bool, conf (H, W); priority (H*W,) in [0, 1) or None
    (then drawn from `generator`). Returns kps (num, 2) int64 as (y, x) and
    valid (num,) bool."""
    H, W = mask.shape
    score = torch.where(mask, conf, torch.zeros_like(conf)).float()
    k = int(min_distance) * 2 + 1
    pooled = F.max_pool2d(score[None, None], k, stride=1, padding=k // 2)[0, 0]
    flat = ((score - pooled).abs() < eps) & mask
    flat = flat.reshape(-1)
    if priority is None:
        priority = torch.rand(H * W, generator=generator, device=mask.device)
    priority = torch.where(flat, priority.float(), torch.full_like(priority.float(), -1.0))
    idx = torch.sort(priority, descending=True, stable=True).indices[:num]
    kps = torch.stack([idx // W, idx % W], dim=-1)
    return kps, flat[idx]
