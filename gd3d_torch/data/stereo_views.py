"""The stereo-view pretraining datasets (counterpart of
gd3d/data/stereo_views.py): the DUSt3R crop / rescale-with-intrinsics
geometry, StereoViews and its combinators, the nine dataset layouts
(Co3D-v2, WildRGB-D, ScanNet++, ARKitScenes, BlendedMVS, MegaDepth,
StaticThings3D, Waymo, Habitat) and `views_pretrain_batch`, the bridge into
the pretraining step's batch.

gd3d reads and resamples with PIL and cv2; the port decodes and resamples
itself, to the same arrays:

- images: `Image.open(f).convert("RGB")` is data/images.py::decode_rgb
  (JPEG, PNG, BMP, WebP; PIL's bytes); the Lanczos (down) and bicubic (up) rescales are
  data/resample.py's transcription of Pillow's; a crop past the border
  fills black, as PIL's does;
- depth: `np.asarray(Image.open(f))` of a PNG is data/png.py's pil_array
  (every PNG mode); the nearest rescale is cv2.INTER_NEAREST's index rule
  (resample.resize_nearest_cv), which gd3d uses wherever cv2 imports;
- masks: `.convert("L")` is data/png.py's pil_l (Pillow's rules for every
  mode);
- float depth: gd3d reads EXR through cv2 and falls back to the `.npy`
  sibling that gd3d's preprocessing writes; the port reads the EXR with
  data/exr.py where it exists, else the sibling, and raises a ValueError
  naming both when there is neither.

Views carry NHWC float32 images in [-1, 1]; everything else is numpy, as
in gd3d, and the reference's `if self.seed:` quirk (seed 0 means an
unseeded generator) is kept.
"""
from __future__ import annotations

import itertools
import json
import os.path as osp
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
from gd3d_torch.data import exr
from gd3d_torch.data import png as png_mod
from gd3d_torch.data.images import decode_rgb
from gd3d_torch.data.resample import resize_bicubic, resize_lanczos, resize_nearest_cv

Resolution = Union[int, Tuple[int, int]]


# ------------------------------------------------------------ intrinsics
def colmap_to_opencv_K(K: np.ndarray) -> np.ndarray:
    """Top-left pixel center (0.5, 0.5) -> (0, 0) (geometry.py:223-234)."""
    K = K.copy()
    K[0, 2] -= 0.5
    K[1, 2] -= 0.5
    return K


def opencv_to_colmap_K(K: np.ndarray) -> np.ndarray:
    K = K.copy()
    K[0, 2] += 0.5
    K[1, 2] += 0.5
    return K


def camera_matrix_of_crop(K: np.ndarray, input_resolution, output_resolution,
                          scaling: float = 1.0, offset_factor: float = 0.5,
                          offset=None) -> np.ndarray:
    """Intrinsics of a scaled-then-cropped view (cropping.py:88-101).
    The scale/shift happens in the COLMAP convention (pixel centers at
    half-integers) — dropping that half-pixel round-trip biases the
    principal point by (scaling-1)/2."""
    margins = np.asarray(input_resolution) * scaling - output_resolution
    assert np.all(margins >= 0.0)
    if offset is None:
        offset = offset_factor * margins
    K2 = opencv_to_colmap_K(np.asarray(K, np.float32))
    K2[:2, :] *= scaling
    K2[:2, 2] -= offset
    return colmap_to_opencv_K(K2)


def bbox_from_K_in_out(K_in: np.ndarray, K_out: np.ndarray,
                       output_resolution) -> Tuple[int, int, int, int]:
    """(l, t, r, b) crop box realizing K_in -> K_out (cropping.py:119-123)."""
    out_w, out_h = output_resolution
    l, t = np.int32(np.round(K_in[:2, 2] - K_out[:2, 2]))
    return (int(l), int(t), int(l) + int(out_w), int(t) + int(out_h))


# ------------------------------------------------------------ image ops
def _open_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8: Image.open(path).convert("RGB") (any format
    data/images.py decodes, alpha dropped)."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_rgb(data, str(path), composite=False)


def _open_png(path) -> np.ndarray:
    """np.asarray(Image.open(path)) of a PNG, in the mode PIL opens it in
    (png.pil_array: uint16 for 16-bit grey, palette indices for P)."""
    return png_mod.pil_array(png_mod.decode_png(path))


def _open_l(path) -> np.ndarray:
    """(H, W) uint8: Image.open(path).convert("L") of a PNG (png.pil_l)."""
    return png_mod.pil_l(png_mod.decode_png(path))


def _size(image: np.ndarray):
    """PIL's image.size of an (H, W, C) array: (W, H)."""
    return image.shape[1], image.shape[0]


def _crop(image: np.ndarray, l: int, t: int, r: int, b: int) -> np.ndarray:
    """PIL's image.crop((l, t, r, b)): pixels past the border are black."""
    H, W = image.shape[:2]
    out = np.zeros((b - t, r - l) + image.shape[2:], image.dtype)
    y0, x0, y1, x1 = max(t, 0), max(l, 0), min(b, H), min(r, W)
    if y1 > y0 and x1 > x0:
        out[y0 - t:y1 - t, x0 - l:x1 - l] = image[y0:y1, x0:x1]
    return out


def rescale_view(image, depthmap: Optional[np.ndarray], K: np.ndarray,
                 output_resolution, force: bool = True):
    """Jointly rescale (image, depth, K) so the image COVERS
    output_resolution (cropping.py:56-85): Lanczos down / bicubic up for
    the image, nearest for depth, intrinsics scaled in colmap convention."""
    in_res = np.array(_size(image))  # (W, H)
    out_res = np.asarray(output_resolution)
    if depthmap is not None:
        assert tuple(depthmap.shape[:2]) == image.shape[:2]
    scale = float(max(out_res / in_res)) + 1e-8
    if scale >= 1 and not force:
        return image, depthmap, np.asarray(K, np.float32)
    target = np.floor(in_res * scale).astype(int)
    resize = resize_lanczos if scale < 1 else resize_bicubic
    image = resize(image, (int(target[0]), int(target[1])))
    if depthmap is not None:
        depthmap = resize_nearest_cv(depthmap, target)
    K = camera_matrix_of_crop(K, in_res, target, scaling=scale)
    return image, depthmap, K


def crop_view(image, depthmap: Optional[np.ndarray], K: np.ndarray,
              crop_bbox: Tuple[int, int, int, int]):
    """Crop image/depth and shift the principal point (cropping.py:104-116)."""
    l, t, r, b = crop_bbox
    image = _crop(image, l, t, r, b)
    if depthmap is not None:
        depthmap = depthmap[t:b, l:r]
    K = np.asarray(K, np.float32).copy()
    K[0, 2] -= l
    K[1, 2] -= t
    return image, depthmap, K


def crop_resize_principal(image, depthmap: np.ndarray, K: np.ndarray,
                          resolution: Tuple[int, int],
                          rng: np.random.Generator,
                          aug_crop: int = 0, info=None):
    """The full view pipeline of base_stereo_view_dataset.py:137-182:

    1. crop to the largest rectangle centered on the principal point
       (rejects views whose pp sits within W/5 or H/5 of a border),
    2. orient the target resolution: portrait if H > 1.1 W, random
       orientation for near-square inputs,
    3. Lanczos-rescale to cover the (optionally aug_crop-enlarged) target,
    4. final center crop realizing the exact output intrinsics.

    Returns (image uint8 (H, W, 3), depth (H, W), K 3x3) at exactly
    `resolution` (possibly transposed by step 2)."""
    W, H = _size(image)
    cx, cy = np.round(np.asarray(K)[:2, 2]).astype(int)
    min_margin_x = min(cx, W - cx)
    min_margin_y = min(cy, H - cy)
    assert min_margin_x > W / 5, f"Bad principal point in view={info}"
    assert min_margin_y > H / 5, f"Bad principal point in view={info}"
    bbox = (cx - min_margin_x, cy - min_margin_y,
            cx + min_margin_x, cy + min_margin_y)
    image, depthmap, K = crop_view(image, depthmap, K, bbox)

    W, H = _size(image)
    assert resolution[0] >= resolution[1]
    if H > 1.1 * W:
        resolution = resolution[::-1]
    elif 0.9 < H / W < 1.1 and resolution[0] != resolution[1]:
        if rng.integers(2):
            resolution = resolution[::-1]

    target = np.array(resolution)
    if aug_crop > 1:
        target = target + rng.integers(0, aug_crop)
    image, depthmap, K = rescale_view(image, depthmap, K, target)

    K2 = camera_matrix_of_crop(K, _size(image), resolution, offset_factor=0.5)
    bbox = bbox_from_K_in_out(K, K2, resolution)
    image, depthmap, _ = crop_view(image, depthmap, K, bbox)
    return image, depthmap, K2


# ------------------------------------------------------------- geometry
def unproject_depth(depthmap: np.ndarray, K: np.ndarray,
                    cam2world: Optional[np.ndarray]):
    """depth + K (+ cam2world) -> (pts3d (H, W, 3), valid (H, W)) —
    geometry.py:165-220: integer pixel grid, valid = depth > 0."""
    K = np.float32(K)
    H, W = depthmap.shape
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    z = depthmap
    x = (u - K[0, 2]) * z / K[0, 0]
    y = (v - K[1, 2]) * z / K[1, 1]
    pts = np.stack((x, y, z), axis=-1).astype(np.float32)
    if cam2world is not None:
        pts = pts @ np.float32(cam2world[:3, :3]).T + np.float32(
            cam2world[:3, 3])
    return pts, depthmap > 0.0


def transpose_to_landscape(view: Dict) -> Dict:
    """Rectify a portrait view to landscape IN PLACE
    (base_stereo_view_dataset.py:203-220). NHWC layout: the image swaps
    its two leading axes; intrinsics swap their x/y rows."""
    h, w = view["true_shape"]
    if w < h:
        for key in ("img", "depthmap", "valid_mask"):
            view[key] = view[key].swapaxes(0, 1)
        view["pts3d"] = view["pts3d"].swapaxes(0, 1)
        view["camera_intrinsics"] = view["camera_intrinsics"][[1, 0, 2]]
        view["true_shape"] = view["true_shape"][::-1].copy()
    return view


# ---------------------------------------------------------- base dataset
class StereoViews:
    """Two-view dataset base (base_stereo_view_dataset.py:17-135).

    Subclasses implement `_get_views(idx, resolution, rng) -> [raw view
    dict, raw view dict]` where each raw view carries a uint8 image plus
    depthmap/camera_intrinsics/camera_pose (cam2world); this class crops,
    normalizes to [-1, 1] NHWC, unprojects pts3d, and rectifies portrait
    views. Indexing with `(idx, ar_idx)` selects among multiple configured
    resolutions, exactly like the reference's aspect-ratio sampler."""

    num_views = 2
    # mast3r/datasets/base/mast3r_base_stereo_view_dataset.py:38 — by
    # default a dataset is NOT metric scale; subclasses overwrite
    # (mast3r/datasets/__init__.py: Co3d False, ScanNetpp/WildRGBD True).
    is_metric_scale = False

    def __init__(self, *, split: Optional[str] = None,
                 resolution: Union[Resolution, List[Resolution]] = None,
                 aug_crop: int = 0, seed: Optional[int] = None):
        self.split = split
        self._set_resolutions(resolution)
        self.aug_crop = aug_crop
        self.seed = seed

    # --- combinators (easy_dataset.py:22-157) ---
    def __add__(self, other: "StereoViews") -> "CatViews":
        return CatViews([self, other])

    def __rmul__(self, factor: int) -> "MulViews":
        return MulViews(factor, self)

    def __rmatmul__(self, new_size: int) -> "ResizedViews":
        return ResizedViews(new_size, self)

    def set_epoch(self, epoch: int) -> None:
        pass

    def _set_resolutions(self, resolutions):
        assert resolutions is not None, "undefined resolution"
        if not isinstance(resolutions, list):
            resolutions = [resolutions]
        self._resolutions = []
        for res in resolutions:
            w, h = (res, res) if isinstance(res, int) else res
            assert isinstance(w, int) and isinstance(h, int)
            assert w >= h
            self._resolutions.append((w, h))

    def __len__(self):
        return len(self.scenes)

    def _get_views(self, idx: int, resolution, rng) -> List[Dict]:
        raise NotImplementedError

    def _crop_resize(self, image, depthmap, K, resolution, rng, info=None):
        return crop_resize_principal(image, depthmap, K, resolution, rng,
                                     aug_crop=self.aug_crop, info=info)

    def __getitem__(self, idx) -> List[Dict]:
        if isinstance(idx, tuple):
            idx, ar_idx = idx
        else:
            assert len(self._resolutions) == 1
            ar_idx = 0
        if self.seed:  # deterministic per item, like the reference
            self._rng = np.random.default_rng(seed=self.seed + idx)
        elif not hasattr(self, "_rng"):
            self._rng = np.random.default_rng()

        views = self._get_views(idx, self._resolutions[ar_idx], self._rng)
        assert len(views) == self.num_views
        for v, view in enumerate(views):
            assert "pts3d" not in view and "valid_mask" not in view
            view["idx"] = (idx, ar_idx, v)
            # per-view flag, like the reference (:205) — survives CatViews
            # mixing metric and non-metric datasets
            view["is_metric_scale"] = self.is_metric_scale
            img = view["img"]
            w, h = _size(img)
            view["true_shape"] = np.int32((h, w))
            arr = np.asarray(img, np.float32) / 255.0
            view["img"] = (arr - 0.5) / 0.5  # ImgNorm: [-1, 1], NHWC
            if "camera_pose" not in view:
                view["camera_pose"] = np.full((4, 4), np.nan, np.float32)
            else:
                assert np.isfinite(view["camera_pose"]).all()
            assert np.isfinite(view["depthmap"]).all()
            pose = view["camera_pose"]
            pts3d, valid = unproject_depth(
                view["depthmap"], view["camera_intrinsics"],
                None if not np.isfinite(pose).all() else pose)
            view["pts3d"] = pts3d
            view["valid_mask"] = valid & np.isfinite(pts3d).all(axis=-1)
            transpose_to_landscape(view)
        return views


class MulViews(StereoViews):
    """`k * ds`: every element duplicated k times (easy_dataset.py:41-67)."""

    def __init__(self, multiplicator: int, dataset: StereoViews):
        assert isinstance(multiplicator, int) and multiplicator > 0
        self.multiplicator = multiplicator
        self.dataset = dataset

    def __len__(self):
        return self.multiplicator * len(self.dataset)

    def set_epoch(self, epoch):
        self.dataset.set_epoch(epoch)

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            idx, other = idx
            return self.dataset[idx // self.multiplicator, other]
        return self.dataset[idx // self.multiplicator]

    @property
    def _resolutions(self):
        return self.dataset._resolutions


class ResizedViews(StereoViews):
    """`n @ ds`: epoch-resized random subset (easy_dataset.py:70-112) —
    seed=epoch+777 permutation, rotary-extended to n."""

    def __init__(self, new_size: int, dataset: StereoViews):
        assert isinstance(new_size, int) and new_size > 0
        self.new_size = new_size
        self.dataset = dataset

    def __len__(self):
        return self.new_size

    def set_epoch(self, epoch):
        rng = np.random.default_rng(seed=epoch + 777)
        perm = rng.permutation(len(self.dataset))
        reps = 1 + (len(self) - 1) // len(self.dataset)
        self._idxs_mapping = np.concatenate([perm] * reps)[: self.new_size]

    def __getitem__(self, idx):
        assert hasattr(self, "_idxs_mapping"), \
            "call set_epoch() before indexing a ResizedViews"
        if isinstance(idx, tuple):
            idx, other = idx
            return self.dataset[self._idxs_mapping[idx], other]
        return self.dataset[self._idxs_mapping[idx]]

    @property
    def _resolutions(self):
        return self.dataset._resolutions


class CatViews(StereoViews):
    """`ds1 + ds2` concatenation (easy_dataset.py:115-157)."""

    def __init__(self, datasets: Sequence[StereoViews]):
        assert all(isinstance(d, StereoViews) for d in datasets)
        self.datasets = list(datasets)
        self._cum_sizes = np.cumsum([len(d) for d in datasets])

    def __len__(self):
        return int(self._cum_sizes[-1])

    def set_epoch(self, epoch):
        for d in self.datasets:
            d.set_epoch(epoch)

    def __getitem__(self, idx):
        other = None
        if isinstance(idx, tuple):
            idx, other = idx
        if not 0 <= idx < len(self):
            raise IndexError()
        db = int(np.searchsorted(self._cum_sizes, idx, "right"))
        new_idx = idx - (self._cum_sizes[db - 1] if db > 0 else 0)
        d = self.datasets[db]
        return d[new_idx if other is None else (int(new_idx), other)]

    @property
    def _resolutions(self):
        res = self.datasets[0]._resolutions
        for d in self.datasets[1:]:
            assert tuple(d._resolutions) == tuple(res)
        return res


# -------------------------------------------------------------- Co3D-v2
class Co3dViews(StereoViews):
    """Preprocessed Co3D-v2 layout (co3d.py:22-165): selected_seqs json,
    `frame%06d` images/depths/masks, npz metadata with camera_intrinsics/
    camera_pose/maximum_depth; pairs are the +/-[5..30]-step (step 5)
    combinations of the 100-frame orbit with +/-4 jitter, zero-depth
    frames resampled toward a valid neighbor."""

    is_metric_scale = False  # mast3r/datasets/__init__.py:32

    def __init__(self, root: str, *, mask_bg: Union[bool, str] = True,
                 **kwargs):
        self.ROOT = root
        super().__init__(**kwargs)
        assert mask_bg in (True, False, "rand")
        self.mask_bg = mask_bg
        self.dataset_label = "Co3d_v2"
        with open(osp.join(root, f"selected_seqs_{self.split}.json")) as f:
            scenes = json.load(f)
        scenes = {k: v for k, v in scenes.items() if len(v) > 0}
        self.scenes = {(k, k2): v2 for k, v in scenes.items()
                       for k2, v2 in v.items()}
        self.scene_list = list(self.scenes.keys())
        self.combinations = [
            (i, j) for i, j in itertools.combinations(range(100), 2)
            if 0 < abs(i - j) <= 30 and abs(i - j) % 5 == 0]
        self.invalidate = {s: {} for s in self.scene_list}

    def __len__(self):
        return len(self.scene_list) * len(self.combinations)

    # path/decode hooks — overridden by WildRGBDViews (wildrgbd.py:18-41)
    def _get_impath(self, obj, instance, view_idx):
        return osp.join(self.ROOT, obj, instance, "images",
                        f"frame{view_idx:06n}.jpg")

    def _get_metadatapath(self, obj, instance, view_idx):
        return osp.join(self.ROOT, obj, instance, "images",
                        f"frame{view_idx:06n}.npz")

    def _get_depthpath(self, obj, instance, view_idx):
        return osp.join(self.ROOT, obj, instance, "depths",
                        f"frame{view_idx:06n}.jpg.geometric.png")

    def _get_maskpath(self, obj, instance, view_idx):
        return osp.join(self.ROOT, obj, instance, "masks",
                        f"frame{view_idx:06n}.png")

    def _read_depthmap(self, depthpath, meta) -> np.ndarray:
        """uint16/65535 x maximum_depth (co3d.py:62-65)."""
        depth16 = _open_png(depthpath)
        return (depth16.astype(np.float32) / 65535.0) * \
            np.nan_to_num(float(meta["maximum_depth"]))

    def _get_views(self, idx, resolution, rng):
        obj, instance = self.scene_list[idx // len(self.combinations)]
        image_pool = self.scenes[obj, instance]
        im1_idx, im2_idx = self.combinations[idx % len(self.combinations)]
        last = len(image_pool) - 1
        invalid = self.invalidate[obj, instance].setdefault(
            resolution, [False] * len(image_pool))
        mask_bg = (self.mask_bg is True) or (
            self.mask_bg == "rand" and rng.choice(2))

        views = []
        queue = [max(0, min(i + int(rng.integers(-4, 5)), last))
                 for i in [im2_idx, im1_idx]]
        while queue:
            im_idx = queue.pop()
            if invalid[im_idx]:  # walk to the nearest valid frame
                direction = 2 * int(rng.choice(2)) - 1
                for off in range(1, len(image_pool)):
                    cand = (im_idx + direction * off) % len(image_pool)
                    if not invalid[cand]:
                        im_idx = cand
                        break
            view_idx = image_pool[im_idx]
            impath = self._get_impath(obj, instance, view_idx)
            meta = np.load(self._get_metadatapath(obj, instance, view_idx))
            K = meta["camera_intrinsics"].astype(np.float32)
            pose = meta["camera_pose"].astype(np.float32)
            image = _open_rgb(impath)
            depthmap = self._read_depthmap(
                self._get_depthpath(obj, instance, view_idx), meta)
            if mask_bg:
                m = _open_l(
                    self._get_maskpath(obj, instance, view_idx)
                ).astype(np.float32) / 255.0
                depthmap = depthmap * (m > 0.1)  # co3d.py:120-126
            image, depthmap, K = self._crop_resize(
                image, depthmap, K, resolution, rng,
                info=f"{impath}")
            if (depthmap > 0.0).sum() == 0:  # co3d.py:133-140
                invalid[im_idx] = True
                queue.append(im_idx)
                continue
            views.append(dict(
                img=image, depthmap=depthmap, camera_pose=pose,
                camera_intrinsics=K, dataset=self.dataset_label,
                label=osp.join(obj, instance), instance=osp.split(impath)[1]))
        return views


class WildRGBDViews(Co3dViews):
    """Preprocessed WildRGB-D layout (wildrgbd.py:18-41): same orbit/pair
    logic as Co3D with rgb/depth/masks/metadata subdirs, %05d frame
    names, and METRIC depth stored at scale 1000 (millimeters)."""

    is_metric_scale = True  # mast3r/datasets/__init__.py:62

    def __init__(self, root: str, **kwargs):
        super().__init__(root, **kwargs)
        self.dataset_label = "WildRGBD"

    def _get_impath(self, obj, instance, view_idx):
        return osp.join(self.ROOT, obj, instance, "rgb",
                        f"{view_idx:0>5d}.jpg")

    def _get_metadatapath(self, obj, instance, view_idx):
        return osp.join(self.ROOT, obj, instance, "metadata",
                        f"{view_idx:0>5d}.npz")

    def _get_depthpath(self, obj, instance, view_idx):
        return osp.join(self.ROOT, obj, instance, "depth",
                        f"{view_idx:0>5d}.png")

    def _get_maskpath(self, obj, instance, view_idx):
        return osp.join(self.ROOT, obj, instance, "masks",
                        f"{view_idx:0>5d}.png")

    def _read_depthmap(self, depthpath, meta) -> np.ndarray:
        return _open_png(depthpath).astype(np.float32) / 1000.0


class ScanNetppViews(StereoViews):
    """Preprocessed ScanNet++ PRETRAINING layout (scannetpp.py:17-70):
    one all_metadata.npz with scenes/sceneids/images/intrinsics/
    trajectories/pairs; per-frame jpg + mm-uint16 depth png. (The
    DISTILLATION-side ScanNet++ loader — pair mining from raw scenes —
    is gd3d/data/scannetpp.py; this one consumes the dust3r-preprocessed
    pretraining dump.)"""

    is_metric_scale = True  # mast3r/datasets/__init__.py:44

    def __init__(self, root: str, **kwargs):
        self.ROOT = root
        super().__init__(**kwargs)
        assert self.split == "train"  # scannetpp.py:22
        with np.load(osp.join(root, "all_metadata.npz")) as data:
            self.scenes = data["scenes"]
            self.sceneids = data["sceneids"]
            self.images = data["images"]
            self.intrinsics = data["intrinsics"].astype(np.float32)
            self.trajectories = data["trajectories"].astype(np.float32)
            self.pairs = data["pairs"][:, :2].astype(int)

    def __len__(self):
        return len(self.pairs)

    def _get_views(self, idx, resolution, rng):
        views = []
        for view_idx in self.pairs[idx]:
            scene_id = self.sceneids[view_idx]
            scene_dir = osp.join(self.ROOT, str(self.scenes[scene_id]))
            basename = str(self.images[view_idx])
            image = _open_rgb(
                osp.join(scene_dir, "images", basename + ".jpg")
            )
            depthmap = _open_png(
                osp.join(scene_dir, "depth", basename + ".png")
            ).astype(np.float32) / 1000.0
            depthmap[~np.isfinite(depthmap)] = 0
            image, depthmap, K = self._crop_resize(
                image, depthmap, self.intrinsics[view_idx].copy(),
                resolution, rng, info=view_idx)
            views.append(dict(
                img=image, depthmap=depthmap.astype(np.float32),
                camera_pose=self.trajectories[view_idx],
                camera_intrinsics=K.astype(np.float32),
                dataset="ScanNet++",
                label=f"{self.scenes[scene_id]}_{basename}",
                instance=f"{idx}_{view_idx}"))
        return views


# ------------------------------------------------ float-depth file read
def read_depth_float(path: str) -> np.ndarray:
    """Float depth of the dust3r preprocessed trees: the EXR itself
    (data/exr.py, cv2.imread(path, IMREAD_ANYDEPTH)'s array) where it
    exists and OpenCV reads it, as gd3d reads it wherever its cv2 has the
    EXR codec; else (no file, or one OpenCV returns None for) the float32
    `<path>.npy` sibling that gd3d's preprocessing writes; else a
    ValueError naming both."""
    refused = None
    if osp.exists(path):
        try:
            return exr.read_exr(path)
        except exr.OpenCVRefuses as e:
            refused = e
    npy = path + ".npy"
    if osp.exists(npy):
        return np.load(npy).astype(np.float32)
    if refused is not None:
        raise ValueError(f"cannot read depth: OpenCV returns None for {path} ({refused}) and "
                         f"its float32 sibling {npy} does not exist") from refused
    raise ValueError(f"cannot read depth: neither {path} nor its float32 sibling {npy} exists")


class ARKitScenesViews(StereoViews):
    """Preprocessed ARKitScenes layout (arkitscenes.py:17-75): per-split
    Training/Test subdirs, one all_metadata.npz (scenes/sceneids/images/
    intrinsics/trajectories/pairs), per-frame vga_wide/*.jpg + mm-uint16
    lowres_depth/*.png."""

    is_metric_scale = True  # mast3r/datasets/__init__.py:17-20

    def __init__(self, root: str, **kwargs):
        self.ROOT = root
        super().__init__(**kwargs)
        self.split_dir = {"train": "Training",
                          "test": "Test"}[self.split]  # arkitscenes.py:21-26
        with np.load(osp.join(root, self.split_dir,
                              "all_metadata.npz")) as data:
            self.scenes = data["scenes"]
            self.sceneids = data["sceneids"]
            self.images = data["images"]
            self.intrinsics = data["intrinsics"].astype(np.float32)
            self.trajectories = data["trajectories"].astype(np.float32)
            self.pairs = data["pairs"][:, :2].astype(int)

    def __len__(self):
        return len(self.pairs)

    def _get_views(self, idx, resolution, rng):
        views = []
        for view_idx in self.pairs[idx]:
            scene_id = self.sceneids[view_idx]
            scene_dir = osp.join(self.ROOT, self.split_dir,
                                 str(self.scenes[scene_id]))
            basename = str(self.images[view_idx])
            image = _open_rgb(osp.join(
                scene_dir, "vga_wide",
                basename.replace(".png", ".jpg")))
            depthmap = _open_png(
                osp.join(scene_dir, "lowres_depth", basename)
            ).astype(np.float32) / 1000.0  # arkitscenes.py:59
            depthmap[~np.isfinite(depthmap)] = 0
            image, depthmap, K = self._crop_resize(
                image, depthmap, self.intrinsics[view_idx].copy(),
                resolution, rng, info=view_idx)
            views.append(dict(
                img=image, depthmap=depthmap.astype(np.float32),
                camera_pose=self.trajectories[view_idx],
                camera_intrinsics=K.astype(np.float32),
                dataset="arkitscenes",
                label=f"{self.scenes[scene_id]}_{basename}",
                instance=f"{idx}_{view_idx}"))
        return views


class BlendedMVSViews(StereoViews):
    """Preprocessed BlendedMVS layout (blendedmvs.py:16-77):
    blendedmvs_pairs.npy records of (seq_high, seq_low, im1, im2, score),
    per-sequence dirs named %08x%016x with jpg + EXR depth + npz
    (intrinsics, R_cam2world, t_cam2world); train/val split by
    seq_low %% 10 (90/10)."""

    is_metric_scale = False  # mast3r/datasets/__init__.py:23-26

    def __init__(self, root: str, **kwargs):
        self.ROOT = root
        super().__init__(**kwargs)
        pairs = np.load(osp.join(root, "blendedmvs_pairs.npy"))
        seq_low = (pairs["seq_low"] if pairs.dtype.names
                   else np.asarray(pairs)[:, 1])
        if self.split == "train":  # blendedmvs.py:29-34
            pairs = pairs[(seq_low % 10) > 0]
        elif self.split == "val":
            pairs = pairs[(seq_low % 10) == 0]
        else:
            assert self.split is None, self.split
        self.pairs = pairs

    def __len__(self):
        return len(self.pairs)

    def _get_views(self, idx, resolution, rng):
        seqh, seql, img1, img2, _score = self.pairs[idx]
        seq_path = osp.join(self.ROOT, f"{int(seqh):08x}{int(seql):016x}")
        views = []
        for view_index in (int(img1), int(img2)):
            impath = f"{view_index:08n}"
            image = _open_rgb(
                osp.join(seq_path, impath + ".jpg"))
            depthmap = read_depth_float(osp.join(seq_path, impath + ".exr"))
            camera = np.load(osp.join(seq_path, impath + ".npz"))
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = camera["R_cam2world"]
            pose[:3, 3] = camera["t_cam2world"]
            image, depthmap, K = self._crop_resize(
                image, depthmap,
                np.float32(camera["intrinsics"]), resolution, rng,
                info=(seq_path, impath))
            views.append(dict(
                img=image, depthmap=depthmap, camera_pose=pose,
                camera_intrinsics=K, dataset="BlendedMVS",
                label=osp.relpath(seq_path, self.ROOT), instance=impath))
        return views


class MegaDepthViews(StereoViews):
    """Preprocessed MegaDepth layout (megadepth.py:16-96): one
    all_metadata.npz (scenes as 'scene subscene' strings, images, pairs
    records of (scene_id, im1_id, im2_id, score)); per-frame jpg + EXR
    depth + npz (intrinsics, cam2world). train excludes scenes
    0015/0022, val is exactly those (megadepth.py:24-29)."""

    is_metric_scale = False  # mast3r/datasets/__init__.py:35-38

    HELDOUT = ("0015", "0022")

    def __init__(self, root: str, **kwargs):
        self.ROOT = root
        super().__init__(**kwargs)
        with np.load(osp.join(root, "all_metadata.npz")) as data:
            self.all_scenes = data["scenes"]
            self.all_images = data["images"]
            self.pairs = data["pairs"]
        if self.split is not None:
            assert self.split in ("train", "val"), self.split
            scene_id = np.asarray(
                [str(s).startswith(self.HELDOUT) for s in self.all_scenes])
            sid = (self.pairs["scene_id"] if self.pairs.dtype.names
                   else np.asarray(self.pairs)[:, 0])
            valid = np.isin(sid, np.nonzero(scene_id)[0])
            if self.split == "train":
                valid = ~valid  # select_scene(opposite=True)
            assert valid.any()
            self.pairs = self.pairs[valid]

    def __len__(self):
        return len(self.pairs)

    def _get_views(self, idx, resolution, rng):
        scene_id, im1_id, im2_id, _score = self.pairs[idx]
        scene, subscene = str(self.all_scenes[int(scene_id)]).split()
        seq_path = osp.join(self.ROOT, scene, subscene)
        views = []
        for im_id in (int(im1_id), int(im2_id)):
            img = str(self.all_images[im_id])
            image = _open_rgb(
                osp.join(seq_path, img + ".jpg"))
            depthmap = read_depth_float(osp.join(seq_path, img + ".exr"))
            camera = np.load(osp.join(seq_path, img + ".npz"))
            image, depthmap, K = self._crop_resize(
                image, depthmap,
                np.float32(camera["intrinsics"]), resolution, rng,
                info=(seq_path, img))
            views.append(dict(
                img=image, depthmap=depthmap,
                camera_pose=np.float32(camera["cam2world"]),
                camera_intrinsics=K, dataset="MegaDepth",
                label=osp.relpath(seq_path, self.ROOT), instance=img))
        return views


class StaticThings3DViews(StereoViews):
    """Preprocessed StaticThings3D layout (staticthings3d.py:16-69):
    staticthings_pairs.npy records of (scene, seq, cam1, im1, cam2, im2)
    under TRAIN/<scene>/<seq>/{left,right}; per-frame %04d_{clean,final}.jpg
    (picked at random per item), EXR depth, npz (intrinsics, cam2world);
    mask_bg zeroes depths > 200 (the synthetic sky plane)."""

    is_metric_scale = False  # mast3r/datasets/__init__.py:47-50

    def __init__(self, root: str, *, mask_bg: Union[bool, str] = "rand",
                 **kwargs):
        self.ROOT = root
        super().__init__(**kwargs)
        assert self.split is None, "StaticThings3D has no split"
        assert mask_bg in (True, False, "rand")
        self.mask_bg = mask_bg
        self.pairs = np.load(osp.join(root, "staticthings_pairs.npy"))

    def __len__(self):
        return len(self.pairs)

    @staticmethod
    def _cam_name(cam) -> str:
        cam = cam.decode("ascii") if isinstance(cam, bytes) else str(cam)
        return {"l": "left", "r": "right"}[cam]

    def _get_views(self, idx, resolution, rng):
        scene, seq, cam1, im1, cam2, im2 = self.pairs[idx]
        scene = scene.decode("ascii") if isinstance(scene, bytes) \
            else str(scene)
        seq_path = osp.join("TRAIN", scene, f"{int(seq):04d}")
        mask_bg = (self.mask_bg is True) or (
            self.mask_bg == "rand" and rng.choice(2))
        views = []
        for cam, im in ((self._cam_name(cam1), int(im1)),
                        (self._cam_name(cam2), int(im2))):
            num = f"{im:04n}"
            img = num + ("_clean.jpg" if rng.choice(2) else "_final.jpg")
            image = _open_rgb(
                osp.join(self.ROOT, seq_path, cam, img))
            depthmap = read_depth_float(
                osp.join(self.ROOT, seq_path, cam, num + ".exr"))
            camera = np.load(
                osp.join(self.ROOT, seq_path, cam, num + ".npz"))
            if mask_bg:  # staticthings3d.py:55-56
                depthmap = np.where(depthmap > 200, 0.0, depthmap)
            image, depthmap, K = self._crop_resize(
                image, depthmap,
                np.float32(camera["intrinsics"]), resolution, rng,
                info=(seq_path, cam, img))
            views.append(dict(
                img=image, depthmap=depthmap,
                camera_pose=np.float32(camera["cam2world"]),
                camera_intrinsics=K, dataset="StaticThings3D",
                label=seq_path, instance=cam + "_" + img))
        return views


class WaymoViews(StereoViews):
    """Preprocessed Waymo Open layout (waymo.py:16-66): one
    waymo_pairs.npz (scenes, frames, pairs of (scene_id, im1, im2));
    per-frame jpg + EXR depth + npz (intrinsics, cam2world)."""

    is_metric_scale = True  # mast3r/datasets/__init__.py:53-56

    def __init__(self, root: str, **kwargs):
        self.ROOT = root
        super().__init__(**kwargs)
        with np.load(osp.join(root, "waymo_pairs.npz")) as data:
            self.scenes = data["scenes"]
            self.frames = data["frames"]
            self.pairs = data["pairs"]
        assert int(np.max(self.pairs[:, 0])) == len(self.scenes) - 1

    def __len__(self):
        return len(self.pairs)

    def _get_views(self, idx, resolution, rng):
        seq, img1, img2 = self.pairs[idx]
        seq_path = osp.join(self.ROOT, str(self.scenes[int(seq)]))
        views = []
        for view_index in (int(img1), int(img2)):
            impath = str(self.frames[view_index])
            image = _open_rgb(
                osp.join(seq_path, impath + ".jpg"))
            depthmap = read_depth_float(osp.join(seq_path, impath + ".exr"))
            camera = np.load(osp.join(seq_path, impath + ".npz"))
            image, depthmap, K = self._crop_resize(
                image, depthmap,
                np.float32(camera["intrinsics"]), resolution, rng,
                info=(seq_path, impath))
            views.append(dict(
                img=image, depthmap=depthmap,
                camera_pose=np.float32(camera["cam2world"]),
                camera_intrinsics=K, dataset="Waymo",
                label=osp.relpath(seq_path, self.ROOT), instance=impath))
        return views


class HabitatViews(StereoViews):
    """Preprocessed Habitat renders (habitat.py:20-79): scene list from
    Habitat_<size>_scenes_<split>.txt, per scene 5 views named
    <key>_<1..5>.{jpeg,_depth.exr,_camera_params.json}; each item pairs
    view 0 with a random other view (view 0 is connected to all),
    walking forward past views whose stored pose is non-finite."""

    # habitat is dust3r-only (never wrapped in mast3r/datasets/
    # __init__.py), so it keeps the base default is_metric_scale=False

    def __init__(self, root: str, size: int, **kwargs):
        self.ROOT = root
        super().__init__(**kwargs)
        assert self.split is not None
        with open(osp.join(root,
                           f"Habitat_{size}_scenes_{self.split}.txt")) as f:
            self.scenes = f.read().splitlines()
        self.instances = list(range(1, 5))

    def filter_scene(self, label, instance=None):
        """(habitat.py:30-37)."""
        if instance:
            subscene, instance = instance.split("_")
            label += "/" + subscene
            self.instances = [int(instance) - 1]
        valid = [scene.startswith(label) for scene in self.scenes]
        assert sum(valid), f"no scene was selected for {label=}"
        self.scenes = [s for s, v in zip(self.scenes, valid) if v]

    def _load_one_view(self, data_path, key, view_index, resolution, rng):
        view_index += 1  # file indices start at 1
        impath = osp.join(data_path, f"{key}_{view_index}.jpeg")
        image = _open_rgb(impath)
        depthmap = read_depth_float(
            osp.join(data_path, f"{key}_{view_index}_depth.exr"))
        with open(osp.join(
                data_path,
                f"{key}_{view_index}_camera_params.json")) as f:
            camera = json.load(f)
        K = np.float32(camera["camera_intrinsics"])
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = camera["R_cam2world"]
        pose[:3, 3] = camera["t_cam2world"]
        image, depthmap, K = self._crop_resize(
            image, depthmap, K, resolution, rng, info=impath)
        return image, depthmap, K, pose

    def _get_views(self, idx, resolution, rng):
        scene = self.scenes[idx]
        data_path, key = osp.split(osp.join(self.ROOT, scene))
        views = []
        for view_index in (0, int(rng.choice(self.instances))):
            for ii in range(view_index, view_index + 5):  # skip broken
                image, depthmap, K, pose = self._load_one_view(
                    data_path, key, ii % 5, resolution, rng)
                if np.isfinite(pose).all():
                    break
            views.append(dict(
                img=image, depthmap=depthmap, camera_pose=pose,
                camera_intrinsics=K, dataset="Habitat",
                label=osp.relpath(data_path, self.ROOT),
                instance=f"{key}_{view_index}"))
        return views


# ----------------------------------------------------- pretrain bridge
def views_pretrain_batch(dataset: StereoViews, indices: Sequence[int],
                         rng: np.random.RandomState,
                         n_corres: int = 256,
                         depth_eps: float = 0.02,
                         is_metric_scale: Optional[bool] = None
                         ) -> Dict[str, np.ndarray]:
    """Collate stereo views into the build_mast3r_pretrain_step batch
    (img1/img2 + gt trees + fixed-capacity reprojection correspondences;
    same contract as gd3d.data.pretrain_pairs batches) — the gd3d
    replacement for the reference's torch collate. Correspondences:
    sample valid view-1 pixels, unproject with the view's own
    depth/K/pose, reproject into view 2, keep hits whose stored depth
    agrees within `depth_eps` x the scene's median depth.

    `is_metric_scale=None` (default) reads the per-view flag the dataset
    attached (mast3r_base_stereo_view_dataset.py:205); pass a bool to
    override."""
    out: Dict[str, list] = {"img1": [], "img2": []}
    gts: Dict[int, Dict[str, list]] = {
        v: {k: [] for k in ("camera_pose", "pts3d", "valid_mask",
                            "sky_mask", "corres")} for v in (1, 2)}
    valid_corres = []
    metric = []
    for idx in indices:
        v1, v2 = dataset[int(idx)]
        metric.append(bool(v1.get("is_metric_scale", False))
                      if is_metric_scale is None else is_metric_scale)
        for vi, view in enumerate((v1, v2)):
            out[f"img{vi + 1}"].append(view["img"].astype(np.float32))
            g = gts[vi + 1]
            g["camera_pose"].append(view["camera_pose"])
            g["pts3d"].append(view["pts3d"])
            g["valid_mask"].append(view["valid_mask"])
            # sky = negative stored depth, NOT merely-invalid pixels
            # (mast3r_base_stereo_view_dataset.py:231) — empty for
            # Co3D/WildRGBD/ScanNet++; invalid pixels are simply
            # excluded from the loss, not sky-supervised
            g["sky_mask"].append(view["depthmap"] < 0)

        H, W = v1["depthmap"].shape
        w2c = np.linalg.inv(v2["camera_pose"])
        K2 = v2["camera_intrinsics"]
        pos = v2["depthmap"][v2["depthmap"] > 0]
        eps = depth_eps * max(
            float(np.median(pos)) if pos.size else 0.0, 1e-6)
        ys, xs = np.nonzero(v1["valid_mask"])
        take = rng.permutation(len(ys))[: 4 * n_corres]
        ys, xs = ys[take], xs[take]
        world = v1["pts3d"][ys, xs]
        cam2 = world @ w2c[:3, :3].T + w2c[:3, 3]
        uv = cam2 @ K2.T
        uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-8)
        ui = np.clip(np.floor(uv).astype(np.int64),
                     0, [W - 1, H - 1])
        inb = ((uv[:, 0] >= 0) & (uv[:, 0] < W)
               & (uv[:, 1] >= 0) & (uv[:, 1] < H) & (cam2[:, 2] > 0))
        zbuf = v2["depthmap"][ui[:, 1], ui[:, 0]]
        ok = inb & (zbuf > 0) & (np.abs(cam2[:, 2] - zbuf) < eps)
        order = np.argsort(~ok)  # visible-in-both first
        sel = order[:n_corres]
        pad = n_corres - len(sel)
        c1 = np.stack([xs[sel], ys[sel]], -1).astype(np.int64)
        c2 = ui[sel]
        vc = ok[sel]
        if pad:
            c1 = np.concatenate([c1, np.zeros((pad, 2), np.int64)])
            c2 = np.concatenate([c2, np.zeros((pad, 2), np.int64)])
            vc = np.concatenate([vc, np.zeros(pad, bool)])
        gts[1]["corres"].append(c1)
        gts[2]["corres"].append(c2)
        valid_corres.append(vc)

    batch: Dict[str, np.ndarray] = {k: np.stack(v) for k, v in out.items()}
    for vi in (1, 2):
        batch[f"gt{vi}"] = {k: np.stack(v) for k, v in gts[vi].items()}
    batch["gt1"]["valid_corres"] = np.stack(valid_corres)
    batch["gt1"]["is_metric_scale"] = np.asarray(metric, bool)
    return batch
