"""Patch-occupancy masks and masked, normalized cost volumes (counterpart of
gd3d/ops/masks.py)."""
from __future__ import annotations

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
    cost: torch.Tensor, mask_patch_1: torch.Tensor, eps: float = 1e-8,
) -> torch.Tensor:
    """Zero the (B, hw, hw2) cost rows outside mask_patch_1 (hw,), then
    row-normalize. A zeroed row normalizes to all zeros: its sum is clamped
    at eps. (gd3d's column-mask and softmax variants are not on the step's
    path.)"""
    zero = torch.zeros((), dtype=cost.dtype, device=cost.device)
    masked = torch.where(mask_patch_1[None, :, None], cost, zero)
    return masked / torch.clamp(masked.sum(-1, keepdim=True), min=eps)
