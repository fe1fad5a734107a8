"""Depth rasterization, keypoint depth and co-view masks (counterpart of
the device-side part of gd3d/ops/geometry.py that the MASt3R and VGGT steps
call), and the OnePose++ pose error, on the host in numpy."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def compute_projection(P: torch.Tensor, points_3d: torch.Tensor) -> torch.Tensor:
    """Project (..., 3) points through a (3, 4) matrix -> (..., 2)."""
    shape = points_3d.shape[:-1]
    pts = points_3d.reshape(-1, 3)
    ph = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1) @ P.T
    return (ph[:, :2] / (ph[:, 2:3] + 1e-8)).reshape(*shape, 2)


def convert_camera_to_world(point_map: torch.Tensor, extrinsic: torch.Tensor) -> torch.Tensor:
    """(x - t) @ R^T, the reference's formula (not the geometric inverse of an
    OpenCV [R|t]; kept, as gd3d keeps it)."""
    R, t = extrinsic[:, :3], extrinsic[:, 3][None, :]
    return ((point_map.reshape(-1, 3) - t) @ R.T).reshape(point_map.shape)


def coview_mask(point_map: torch.Tensor, P_other: torch.Tensor,
                image_shape: Tuple[int, int]) -> torch.Tensor:
    proj = compute_projection(P_other, point_map)
    u, v = proj[..., 0], proj[..., 1]
    H, W = image_shape
    return (u >= 0) & (u < W) & (v >= 0) & (v < H)


def coview_masks(point_map_view1, point_map_view2, intrinsic1, extrinsic1, intrinsic2,
                 extrinsic2, image_shape: Tuple[int, int]):
    """Mutual-reprojection visibility masks of one pair, (H, W) bool each.
    Both views' points are converted with extrinsic1, as in the reference
    and gd3d."""
    world1 = convert_camera_to_world(point_map_view1, extrinsic1)
    world2 = convert_camera_to_world(point_map_view2, extrinsic1)
    return (coview_mask(world1, intrinsic2 @ extrinsic2, image_shape),
            coview_mask(world2, intrinsic1 @ extrinsic1, image_shape))


def point_cloud_to_depth(
    points: torch.Tensor, K: torch.Tensor, w: int, h: int
) -> torch.Tensor:
    """Rasterize camera-frame points (N, 3) to a (1, 1, h, w) average-Z map.

    Round to the nearest pixel (half to even, as jnp.round), average Z of
    the points landing on a pixel, zero where empty. Invalid points go to an
    overflow bin. The range test runs on the rounded floats, so a point far
    off the image never reaches an integer cast."""
    X, Y, Z = points[:, 0], points[:, 1], points[:, 2]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    zsafe = torch.where(Z > 0, Z, torch.ones_like(Z))
    u = torch.round((X / zsafe) * fx + cx)
    v = torch.round((Y / zsafe) * fy + cy)
    valid = (Z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    idx = torch.where(valid, v * w + u, torch.full_like(u, h * w)).long()
    zsum = torch.zeros(h * w + 1, dtype=torch.float32, device=points.device)
    cnt = torch.zeros(h * w + 1, dtype=torch.float32, device=points.device)
    zsum.index_add_(0, idx, torch.where(valid, Z, torch.zeros_like(Z)).float())
    cnt.index_add_(0, idx, valid.float())
    avg = torch.where(cnt > 0, zsum / torch.clamp(cnt, min=1.0),
                      torch.zeros_like(zsum))[: h * w]
    return avg.reshape(1, 1, h, w)


def extract_kp_depth(
    depth_map: torch.Tensor, kp: torch.Tensor, window_size: int = 3
) -> torch.Tensor:
    """Mean depth in a replicate-padded window around floor(kp).

    depth_map (H, W), kp (B, N, 2) as (x, y). Returns (B, N). `.long()`
    truncates toward zero like the reference; keypoints are non-negative."""
    H, W = depth_map.shape[-2:]
    half = window_size // 2
    padded = F.pad(depth_map.reshape(1, 1, H, W), (half, half, half, half),
                   mode="replicate")[0, 0]
    patches = torch.zeros((H, W), dtype=padded.dtype, device=padded.device)
    for dy in range(window_size):
        for dx in range(window_size):
            patches = patches + padded[dy: dy + H, dx: dx + W]
    patch_means = patches / float(window_size * window_size)
    x = torch.clamp(kp[..., 0].long(), 0, W - 1)
    y = torch.clamp(kp[..., 1].long(), 0, H - 1)
    return patch_means[y, x]


def query_pose_error(pose_pred, pose_gt, unit: str = "m") -> Tuple[float, float]:
    """Angular (degrees) and translation (cm) error of a 3 x 4 or 4 x 4 pose,
    in numpy (gd3d/ops/geometry.py::query_pose_error): the trace clamped at
    3, and arccos NaN below -1, which an accuracy threshold counts as a miss."""
    if pose_pred.shape[0] == 4:
        pose_pred = pose_pred[:3]
    if pose_gt.shape[0] == 4:
        pose_gt = pose_gt[:3]
    scale = {"m": 100.0, "cm": 1.0, "mm": 0.1}[unit]
    translation_distance = np.linalg.norm(pose_pred[:, 3] - pose_gt[:, 3]) * scale
    rotation_diff = np.dot(pose_pred[:, :3], pose_gt[:, :3].T)
    trace = min(np.trace(rotation_diff), 3.0)
    with np.errstate(invalid="ignore"):
        angular_distance = np.rad2deg(np.arccos((trace - 1.0) / 2.0))
    return float(angular_distance), float(translation_distance)
