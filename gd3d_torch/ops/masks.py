"""Patch-occupancy masks and masked, normalized cost volumes (counterpart of
gd3d/ops/masks.py)."""
from __future__ import annotations

from typing import Optional

import torch


def patch_mask_from_kps(
    kp_xy: torch.Tensor,
    H: int,
    W: int,
    patch_size: int,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Boolean (ph*pw,) mask of patches holding at least one valid keypoint.

    Keypoints outside the patch grid, and invalid slots, go to an overflow
    bin that is dropped."""
    ph, pw = H // patch_size, W // patch_size
    num_patches = ph * pw
    in_bounds = (
        (kp_xy[:, 0] >= 0)
        & (kp_xy[:, 0] < pw * patch_size)
        & (kp_xy[:, 1] >= 0)
        & (kp_xy[:, 1] < ph * patch_size)
        & valid
    )
    x_idx = torch.clamp(kp_xy[:, 0], 0, W - 1).long() // patch_size
    y_idx = torch.clamp(kp_xy[:, 1], 0, H - 1).long() // patch_size
    patch_idx = torch.where(in_bounds, y_idx * pw + x_idx, num_patches)
    hits = torch.zeros(num_patches + 1, dtype=torch.int32, device=kp_xy.device)
    hits.index_add_(0, patch_idx, in_bounds.to(torch.int32))
    return hits[:num_patches] > 0


def masked_patch_cost(
    cost: torch.Tensor,
    mask_patch_1: torch.Tensor,
    mask_patch_2: Optional[torch.Tensor] = None,
    eps: float = 1e-8,
    use_softmax: bool = False,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Zero the (B, hw, hw2) cost entries outside the mask, then
    row-normalize, or softmax each row. The mask is mask_patch_1 (hw,) along
    the rows, and with mask_patch_2 (hw2,) also along the columns. Without
    softmax a zeroed row normalizes to all zeros (its sum is clamped at
    eps); with it, the rows are computed in fp32 after dividing by
    temperature, and a zeroed row comes out uniform, as gd3d's (a softmax of
    a constant row)."""
    keep = mask_patch_1[:, None]
    if mask_patch_2 is not None:
        keep = keep & mask_patch_2[None, :]
    zero = torch.zeros((), dtype=cost.dtype, device=cost.device)
    masked = torch.where(keep[None], cost, zero)
    if use_softmax:
        x = masked.float() / temperature
        e = torch.exp(x - x.amax(-1, keepdim=True))
        return e / e.sum(-1, keepdim=True)
    return masked / torch.clamp(masked.sum(-1, keepdim=True), min=eps)
