"""ScanNet++ co-view pair dataset (counterpart of gd3d/data/scannetpp.py),
without PIL.

Co-view pair mining from each scene's transforms_train.json (camera
distance <= 1 m, forward-axis angle <= 90 deg), the pair cache
metadata/train_image_pairs.npy (a pickle of (scene, name 1, name 2, K)
tuples: this module reads a cache gd3d wrote and writes one gd3d reads),
intrinsics rescaled to 512x336, square 512^2 student images, MASt3R- or
VGGT-format teacher images, and the ScanNet++ colour augmentations.

Tree: root/metadata/train_samples_all.txt (lines "<scene>_<image>"),
root/scenes/<scene>/transforms_train.json (w, h, fl_x, fl_y, cx, cy and
frames of file_path and transform_matrix) and
root/scenes/<scene>/images/<image>.JPG.

Each JPEG is decoded once a sample (gd3d opens it twice). Its two uses keep
gd3d's asymmetry: the square student image is PIL's default (bicubic)
resize of the file as opened, with no EXIF transpose, while the teacher
images are loaded from the EXIF-transposed RGB image.
"""
from __future__ import annotations

import collections
import json
import pickle
import random
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from gd3d_torch.data import exif
from gd3d_torch.data.augment import color_augs_scannetpp
from gd3d_torch.data.images import (decode_rgb, file_orientation, load_image_mast3r,
                                    load_images_vggt, read_bytes)
from gd3d_torch.data.resample import resize_bicubic


def is_co_view_transform(matA, matB, dist_thresh=1.0, angle_thresh=90.0) -> bool:
    if np.linalg.norm(matA[:3, 3] - matB[:3, 3]) > dist_thresh:
        return False
    fa, fb = -matA[:3, 2], -matB[:3, 2]
    cosv = np.dot(fa, fb) / (np.linalg.norm(fa) * np.linalg.norm(fb) + 1e-8)
    return np.degrees(np.arccos(np.clip(cosv, -1.0, 1.0))) <= angle_thresh


def rescale_intrinsic(transforms: Dict, out_wh=(512, 336)) -> np.ndarray:
    sx = out_wh[0] / transforms["w"]
    sy = out_wh[1] / transforms["h"]
    return np.array(
        [
            [transforms["fl_x"] * sx, 0, transforms["cx"] * sx],
            [0, transforms["fl_y"] * sy, transforms["cy"] * sy],
            [0, 0, 1],
        ]
    )


def mine_pairs(
    root: Path,
    scene_to_imgs: Dict[str, List[str]],
    desired_total: int,
    rng: random.Random,
) -> List[Tuple[str, str, str, np.ndarray]]:
    """Co-view pairs of each scene: for each image i, the later images j
    that co-view it; once the scene holds its quota (desired_total //
    scenes), each later i adds only its first (gd3d's break leaves the inner
    loop alone); where a scene holds more than its quota, a sample of that
    many drawn with `rng`."""
    pairs = []
    scenes = list(scene_to_imgs.keys())
    per_scene = max(1, desired_total // max(len(scenes), 1))
    for scene in scenes:
        names = scene_to_imgs[scene]
        if len(names) < 2:
            continue
        tpath = root / "scenes" / scene / "transforms_train.json"
        with open(tpath) as f:
            transforms = json.load(f)
        K = rescale_intrinsic(transforms)
        frames = {
            fr["file_path"].split(".")[0]: np.array(fr["transform_matrix"])
            for fr in transforms["frames"]
        }
        found = []
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                if not is_co_view_transform(frames[names[i]], frames[names[j]]):
                    continue
                found.append((scene, names[i], names[j], K))
                if len(found) >= per_scene:
                    break
        if len(found) > per_scene:
            found = rng.sample(found, per_scene)
        pairs.extend(found)
    return pairs


class ScanNetPPDataset:
    """Emits rgb_1/rgb_2 (512x512 square, [0,1]) + teacher images + intrinsic."""

    def __init__(
        self,
        root: str = "data/scannetpp",
        sample_list: str = "metadata/train_samples_all.txt",
        pairs_file: str = "metadata/train_image_pairs.npy",
        img_size: int = 512,
        num: int = 1000,
        length: int = 100,
        vggt: bool = False,
        seed: Optional[int] = None,
    ):
        self.root = Path(root)
        self.img_size = img_size
        self.vggt = vggt
        self.length = length
        self.rng = np.random.RandomState(seed)

        ids = np.loadtxt(self.root / sample_list, dtype=str)
        self.scene_to_imgs = collections.defaultdict(list)
        for img_id in np.atleast_1d(ids):
            scene, img = img_id.split("_")
            self.scene_to_imgs[scene].append(img)

        cache = self.root / pairs_file
        if cache.exists():
            with open(cache, "rb") as f:
                self.image_pairs = pickle.load(f)
        else:
            self.image_pairs = mine_pairs(
                self.root, self.scene_to_imgs, num, random.Random(seed)
            )
            cache.parent.mkdir(parents=True, exist_ok=True)
            with open(cache, "wb") as f:
                pickle.dump(self.image_pairs, f)

    def __len__(self):
        return self.length

    def _open(self, path: Path) -> Tuple[np.ndarray, np.ndarray]:
        """(the square student image, the teacher loaders' RGB image) of one
        JPEG, decoded once."""
        data = read_bytes(path)
        raw = decode_rgb(data, str(path))
        square = resize_bicubic(raw, (self.img_size, self.img_size))
        return (square / 255.0).astype(np.float32), exif.transpose(raw, file_orientation(data))

    def __getitem__(self, idx) -> Dict:
        idx = self.rng.randint(len(self.image_pairs))
        scene, n1, n2, K = self.image_pairs[idx]
        p1 = self.root / "scenes" / scene / "images" / f"{n1}.JPG"
        p2 = self.root / "scenes" / scene / "images" / f"{n2}.JPG"
        (sq1, im1), (sq2, im2) = self._open(p1), self._open(p2)
        res = {
            "rgb_1": sq1,
            "rgb_2": sq2,
            "intrinsic": np.asarray(K, np.float32),
            "scene_name": scene,
        }
        if self.vggt:
            res["rgb_vggt"] = load_images_vggt([im1, im2])
        else:
            m1 = load_image_mast3r(im1, self.img_size)
            m2 = load_image_mast3r(im2, self.img_size)
            res["rgb_mast3r_1"] = m1["img"]
            res["rgb_mast3r_2"] = m2["img"]
            res["true_shape"] = m1["true_shape"]
        return res


class AugmentedScanNetPPDataset:
    """Colour jitter and blur on the student views."""

    def __init__(self, base: ScanNetPPDataset, augmentation: bool = True,
                 seed: Optional[int] = None):
        self.base = base
        self.augmentation = augmentation
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        data = self.base[idx]
        if self.augmentation:
            for v in ("1", "2"):
                img = (data[f"rgb_{v}"] * 255).astype(np.uint8)
                img = color_augs_scannetpp(img, self.rng)
                data[f"rgb_{v}"] = (img / 255.0).astype(np.float32)
        return data
