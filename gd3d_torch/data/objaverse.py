"""Objaverse rendering pair datasets (counterpart of gd3d/data/objaverse.py),
without cv2 or PIL.

  - ObjaverseCorrDataset (ME): mask-derived 2D keypoints lifted to
    object-frame 3D through depth and pose, 3000 keypoints a view, a random
    pair of views of one object; AugmentedCorrDataset with the 120 degree
    view-angle filter and its 200-try resampling, the geometric and colour
    augmentations;
  - ObjaverseMASt3RDataset: random views of one object, depth clamped to
    5000 and divided by 5000, MASt3R-format images (or, with vggt=True,
    rgb_vggt from the 518/14 loader); AugmentedObjaverseDataset, colour
    augmentations on rgb_1 and rgb_2.

Renders live under root/<obj>/{color,depth,mask}_%06d.png. Each sample
draws from the dataset's RandomState as gd3d's does, and gives gd3d's
arrays: the PNGs are decoded by gd3d_torch/data/png.py as cv2.imread and
PIL give them, each file once a sample (the colour render serves both the
cv2 view and the PIL one that the MASt3R/VGGT loader opens).
"""
from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from gd3d_torch.data import exif, png
from gd3d_torch.data.augment import color_augs_objaverse, shift_scale_rotate
from gd3d_torch.data.images import load_image_mast3r, load_images_vggt, read_bytes

OBJAVERSE_INTRINSIC = np.array(
    [[35 * 512 / 32.0, 0.0, 256], [0.0, 35 * 512 / 32.0, 256], [0.0, 0.0, 1.0]]
)

# gd3d's MASt3R objaverse intrinsics, with the reference's scale quirk (the
# focal and centre rows scaled by 384/512 on y only)
MAST3R_INTRINSIC = np.array(
    [
        [16 * 512 / 32.0, 0, 256],
        [0, 16 * 512 * (384 / 512) / 32.0, 256 * (384 / 512)],
        [0, 0, 1],
    ]
)


def img_coord_2_obj_coord(kp2d: np.ndarray, depth: np.ndarray, k: np.ndarray,
                          pose_obj2cam: np.ndarray) -> np.ndarray:
    """Lift 2D keypoints to object-frame 3D (gd3d/ops/geometry.py's host
    function of the same name)."""
    inv_k = np.linalg.inv(k[:3, :3])
    kp2d = kp2d[:, :2]
    kp2d_h = np.concatenate((kp2d, np.ones((kp2d.shape[0], 1))), 1)
    kp2d_int = np.round(kp2d_h).astype(int)[:, :2]
    kp_depth = depth[kp2d_int[:, 1], kp2d_int[:, 0]]
    kp2d_cam = np.expand_dims(kp_depth, 1) * kp2d_h
    kp3d_cam = np.dot(inv_k, kp2d_cam.T).T
    kp3d_cam_pad1 = np.concatenate((kp3d_cam, np.ones((kp2d_cam.shape[0], 1))), 1).T
    kp3d_obj = np.dot(np.linalg.inv(pose_obj2cam), kp3d_cam_pad1).T
    return kp3d_obj[:, :3]


def _rgb_of(decoded: png.Png) -> np.ndarray:
    """gd3d's _read_rgb: cv2.imread(path)[..., ::-1]."""
    return png.cv2_view(decoded)[..., ::-1].copy()


def _open_png(path: Path):
    """(the decoded file, PIL's RGB of it as gd3d's loaders open it)."""
    data = read_bytes(path)
    decoded = png.decode_png(data)
    value = exif.orientation(decoded.exif)
    return decoded, exif.transpose(png.pil_rgb(decoded), value)


class ObjaverseCorrDataset:
    """ME pair sampler: returns pts2d/pts3d with fixed 3000 kps per view."""

    def __init__(self, root: str, obj_names: List[str], poses: np.ndarray,
                 num_kps: int = 3000, length: int = 100,
                 seed: Optional[int] = None):
        self.root = Path(root)
        self.obj_names = obj_names
        self.poses = poses
        self.num_kps = num_kps
        self.length = length
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.length

    def _view(self, obj_name: str, i: int, suffix: str) -> Dict:
        rgb = _rgb_of(png.decode_png(self.root / obj_name / f"color_{i:06d}.png"))
        depth = png.imread(self.root / obj_name / f"depth_{i:06d}.png",
                           png.IMREAD_ANYDEPTH).astype(np.float64) / 1000.0
        mask = png.imread(self.root / obj_name / f"mask_{i:06d}.png", png.IMREAD_GRAYSCALE)
        kp2d = np.stack(np.where(mask > 0), -1)[:, ::-1]
        pose = self.poses[i]
        chosen = self.rng.choice(len(kp2d), self.num_kps, replace=len(kp2d) < self.num_kps)
        kp2d = kp2d[chosen]
        kp3d = img_coord_2_obj_coord(kp2d, depth, OBJAVERSE_INTRINSIC, pose)
        return {
            f"rgb_{suffix}": (rgb / 255.0).astype(np.float32),
            f"mask_{suffix}": mask > 0,
            f"pts2d_{suffix}": kp2d.astype(np.float32),
            f"pts3d_{suffix}": kp3d.astype(np.float32),
            f"rot_{suffix}": pose[:3, :3].astype(np.float32),
            f"pose_idx_{suffix}": i,
            f"obj_name_{suffix}": obj_name,
        }

    def __getitem__(self, idx) -> Dict:
        for _ in range(10):
            try:
                obj = self.rng.choice(self.obj_names)
                i = self.rng.choice(self.poses.shape[0])
                j = self.rng.choice(self.poses.shape[0])
                while j == i:
                    j = self.rng.choice(self.poses.shape[0])
                return {**self._view(obj, i, "1"), **self._view(obj, j, "2")}
            except Exception:
                continue  # skip and resample, as the reference does
        raise RuntimeError("no loadable objaverse pair found")


class AugmentedCorrDataset:
    """The ME dataset's view-angle filter and augmentations."""

    def __init__(self, base: ObjaverseCorrDataset, geom_aug_prob: float = 0.5,
                 max_angle_deg: float = 120.0, seed: Optional[int] = None):
        self.base = base
        self.geom_aug_prob = geom_aug_prob
        self.max_angle = max_angle_deg
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx) -> Dict:
        for attempt in range(200):
            data = self.base[idx]
            r1, r2 = data["rot_1"], data["rot_2"]
            cosang = np.clip((np.trace(r1 @ r2.T) - 1) / 2, -1.0, 1.0)
            if np.rad2deg(np.arccos(cosang)) <= self.max_angle:
                break
            if attempt % 20 == 19:  # try another object, as the reference does
                idx = (idx + 1) % len(self.base)
        else:
            raise RuntimeError(f"no view pair within {self.max_angle} deg after 200 tries")
        for v in ("1", "2"):
            img = (data[f"rgb_{v}"] * 255).astype(np.uint8)
            kps = data[f"pts2d_{v}"]
            mask = data[f"mask_{v}"]
            img, kps, mask = shift_scale_rotate(img, kps, mask, self.rng, p=self.geom_aug_prob)
            h, w = img.shape[:2]
            valid = (kps[:, 0] >= 0) & (kps[:, 0] < w) & (kps[:, 1] >= 0) & (kps[:, 1] < h)
            img = color_augs_objaverse(img, self.rng)
            if mask is not None:
                img = img * (mask > 0)[..., None].astype(img.dtype)
            data[f"rgb_{v}"] = (img / 255.0).astype(np.float32)
            data[f"mask_{v}"] = mask > 0 if mask is not None else None
            data[f"pts2d_{v}"] = kps.astype(np.float32)
            data[f"valid_{v}"] = valid
        return data


class ObjaverseMASt3RDataset:
    """MASt3R (or, with vggt=True, VGGT) teacher pairs."""

    def __init__(self, root: str, obj_names: List[str], length: int = 100,
                 seed: Optional[int] = None, vggt: bool = False):
        self.root = Path(root)
        self.obj_names = obj_names
        self.length = length
        self.vggt = vggt
        self.rng = np.random.RandomState(seed)
        self.max_idx = {o: self._max_idx(o) for o in obj_names}

    def _max_idx(self, obj: str) -> int:
        mx = 0
        for p in glob.glob(os.path.join(self.root, obj, "color_*.png")):
            mx = max(mx, int(p.split("_")[-1].split(".")[0]))
        return mx

    def __len__(self):
        return self.length

    def _view(self, obj: str, i: int, suffix: str) -> Dict:
        rgb_path = self.root / obj / f"color_{i:06d}.png"
        decoded, opened = _open_png(rgb_path)
        depth = png.imread(self.root / obj / f"depth_{i:06d}.png",
                           png.IMREAD_UNCHANGED).astype(np.float32)
        depth[depth == 0] = 5000
        depth[depth > 5000] = 5000
        return {
            f"rgb_{suffix}": (_rgb_of(decoded) / 255.0).astype(np.float32),
            f"rgb_path_{suffix}": str(rgb_path),
            f"depth_{suffix}": depth / 5000.0,
        }, opened

    def __getitem__(self, idx) -> Dict:
        for _ in range(10):
            try:
                obj = self.rng.choice([o for o in self.obj_names if self.max_idx[o] > 1])
                i = self.rng.choice(self.max_idx[obj])
                j = self.rng.choice(self.max_idx[obj])
                while j == i:
                    j = self.rng.choice(self.max_idx[obj])
                (v1, im1), (v2, im2) = self._view(obj, i, "1"), self._view(obj, j, "2")
                res = {**v1, **v2}
                if self.vggt:
                    res["rgb_vggt"] = load_images_vggt([im1, im2])
                else:
                    m1 = load_image_mast3r(im1, 512)
                    m2 = load_image_mast3r(im2, 512)
                    res["rgb_mast3r_1"] = m1["img"]
                    res["rgb_mast3r_2"] = m2["img"]
                    res["true_shape"] = m1["true_shape"]
                res["intrinsic"] = MAST3R_INTRINSIC.astype(np.float32)
                return res
            except Exception:
                continue
        raise RuntimeError("no loadable objaverse pair found")


class AugmentedObjaverseDataset:
    """Colour-only augmentations on rgb_1 and rgb_2."""

    def __init__(self, base, seed: Optional[int] = None):
        self.base = base
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        data = self.base[idx]
        for v in ("1", "2"):
            img = (data[f"rgb_{v}"] * 255).astype(np.uint8)
            img = color_augs_objaverse(img, self.rng)
            data[f"rgb_{v}"] = (img / 255.0).astype(np.float32)
        return data
