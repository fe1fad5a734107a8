"""The committed image fixtures of the data readers (gd3d_torch/data/
testdata/), the trees fabricated from them, and the port's digests of
what it reads from them; numpy only.

No dataset is in the repository. The CPU tests (tests/test_torch_datasets.py,
tests/test_torch_cli.py) and chip_smoke.py's data phase build the same trees
with these functions. testdata/digests.json holds the SHA-256 digests of
what cv2, PIL and gd3d give for the fixtures (each PNG in cv2.imread's four
modes and PIL's RGB, each JPEG as PIL opens it, gd3d's image loaders, gd3d's
augmentations at fixed seeds with the RandomState after them, and gd3d's
first two host batches on the trees); `port_digests` computes the same
records with the port, and `python tests/test_torch_datasets.py` writes the
fixtures and the reference digests anew (cv2, PIL and gd3d needed).

  - `write_scannetpp_tree(root)`: <root>/scannetpp/metadata/
    train_samples_all.txt and, per scene, scenes/<scene>/transforms_train.json
    (the DSLR's 1752x1168 intrinsics, camera centres 0.2 m apart along a
    line, one forward axis) and scenes/<scene>/images/<image>.JPG, each a
    copy of the 1752x1168 fixture dslr.jpg. No pair cache: the first
    dataset mines it.
  - `write_objaverse_tree(root)`: <root>/10k.txt, <root>/obj_poses.npy
    (the views' object-to-camera poses, rotations about y from 0 to 150
    degrees, so that some pairs fail the ME config's 120 degree filter) and
    <root>/objaverse_renderings/<obj>/{color,depth,mask}_%06d.png, the
    view's render fixtures (render_<k>_{color,depth,mask}.png, k = view mod
    RENDERS).
"""
from __future__ import annotations

import hashlib
import json
import shutil
import tempfile
from pathlib import Path
from typing import Callable, Dict

import numpy as np

TESTDATA = Path(__file__).resolve().parent / "testdata"
RENDERS = 3
SCANNETPP_SCENES = ("8b5caf3398", "a5114ca13d")
SCANNETPP_IMAGES = 4
OBJAVERSE_OBJECTS = ("000-017/0b5d3f9e8a2c4e61", "000-042/7c1e2f4d9a3b5c60")
OBJAVERSE_VIEWS = 6
DSLR_SIZE = (1752, 1168)


def write_scannetpp_tree(root, scenes=SCANNETPP_SCENES, images: int = SCANNETPP_IMAGES,
                         jpeg=None) -> Path:
    """The ScanNet++ tree under <root>/scannetpp, its frames copies of
    `jpeg` (default testdata/dslr.jpg); returns <root>."""
    root = Path(root)
    jpeg = Path(jpeg) if jpeg else TESTDATA / "dslr.jpg"
    base = root / "scannetpp"
    ids = []
    w, h = DSLR_SIZE
    for s, scene in enumerate(scenes):
        img_dir = base / "scenes" / scene / "images"
        img_dir.mkdir(parents=True, exist_ok=True)
        frames = []
        for i in range(images):
            name = f"DSC{1000 + 7 * i + s:05d}"
            shutil.copyfile(jpeg, img_dir / f"{name}.JPG")
            pose = np.eye(4)
            pose[:3, 3] = [0.2 * i, 0.05 * s, 1.5]
            frames.append({"file_path": f"{name}.JPG", "transform_matrix": pose.tolist()})
            ids.append(f"{scene}_{name}")
        transforms = {"w": w, "h": h, "fl_x": 1150.0, "fl_y": 1148.5, "cx": 875.5,
                      "cy": 583.25, "frames": frames}
        (base / "scenes" / scene / "transforms_train.json").write_text(
            json.dumps(transforms, indent=1))
    (base / "metadata").mkdir(parents=True, exist_ok=True)
    (base / "metadata" / "train_samples_all.txt").write_text("\n".join(ids) + "\n")
    return root


def objaverse_poses(views: int = OBJAVERSE_VIEWS) -> np.ndarray:
    """(views, 4, 4) object-to-camera poses: rotations about y spread over
    [0, 150] degrees, the object 2 m in front of the camera."""
    poses = np.zeros((views, 4, 4))
    for v, deg in enumerate(np.linspace(0.0, 150.0, views)):
        a = np.deg2rad(deg)
        poses[v, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        poses[v, :3, 3] = [0.0, 0.0, 2.0]
        poses[v, 3, 3] = 1.0
    return poses


def write_objaverse_tree(root, objects=OBJAVERSE_OBJECTS, views: int = OBJAVERSE_VIEWS) -> Path:
    """The Objaverse tree under <root>; returns <root>."""
    root = Path(root)
    for obj in objects:
        d = root / "objaverse_renderings" / obj
        d.mkdir(parents=True, exist_ok=True)
        for v in range(views):
            for kind in ("color", "depth", "mask"):
                shutil.copyfile(TESTDATA / f"render_{v % RENDERS}_{kind}.png",
                                d / f"{kind}_{v:06d}.png")
    (root / "10k.txt").write_text("\n".join(objects) + "\n")
    np.save(root / "obj_poses.npy", objaverse_poses(views))
    return root


# ---------------------------------------------------------------------------
# Digests
# ---------------------------------------------------------------------------

# cv2.imread flags of the PNG records, and "pil": gd3d's _to_pil(path)
PNG_MODES = {"unchanged": -1, "gray": 0, "color": 1, "anydepth": 2}
# image loader cases: name -> (function, files, keyword arguments)
LOADER_CASES = {
    "mast3r_512_dslr": ("mast3r", ("dslr.jpg",), {"size": 512}),
    "mast3r_224_dslr": ("mast3r", ("dslr.jpg",), {"size": 224}),
    "mast3r_512_square_render": ("mast3r", ("render_0_color.png",), {"size": 512,
                                                                     "square_ok": True}),
    "mast3r_512_up_exif6": ("mast3r", ("exif_6.jpg",), {"size": 512}),
    "mast3r_224_up_exif5": ("mast3r", ("exif_5.jpg",), {"size": 224}),
    "vggt_crop_dslr": ("vggt", ("dslr.jpg", "dslr.jpg"), {"mode": "crop"}),
    "vggt_pad_exif8_render": ("vggt", ("exif_8.jpg", "render_2_color.png"),
                              {"mode": "pad"}),
    "square_rgb_dslr": ("square", ("dslr.jpg",), {}),
}
# augmentation cases: name -> (function, seed, crop of render_1's cv2 colour
# view (rows, columns), keyword arguments)
AUGMENT_CASES = {
    "gaussian_blur_1_3": ("gaussian_blur", 3, (512, 512), {}),
    "gaussian_blur_3_7": ("gaussian_blur", 4, (97, 131), {"blur_limit": (3, 7)}),
    "gauss_noise": ("gauss_noise", 5, (97, 131), {}),
    "clahe": ("clahe", 6, (512, 512), {}),
    "clahe_odd": ("clahe", 7, (97, 131), {}),
    "brightness_contrast": ("brightness_contrast", 8, (97, 131), {}),
    "color_jitter": ("color_jitter", 9, (512, 512), {}),
    "color_jitter_odd": ("color_jitter", 10, (97, 131), {}),
    "color_augs_objaverse": ("color_augs_objaverse", 11, (512, 512), {}),
    "color_augs_scannetpp": ("color_augs_scannetpp", 12, (512, 512), {}),
    "shift_scale_rotate": ("shift_scale_rotate", 13, (512, 512), {"p": 1.0}),
}
# host batch records: name -> (teacher, dataset, steps), epoch 0, batch 1
BATCH_RUNS = {
    "finetune_timm_mast3r_scannetpp": ("mast3r", "scannetpp", 2),
    "finetune_timm_me_objaverse": ("me", "objaverse", 2),
    "finetune_timm_vggt_objaverse": ("vggt", "objaverse", 2),
}
SEED = 42


def sha(a) -> Dict:
    """{shape, dtype, sha256} of an array."""
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def rng_sha(rng: np.random.RandomState) -> str:
    _, key, pos, gauss, cached = rng.get_state()
    return hashlib.sha256(key.tobytes() + bytes(str((pos, gauss, cached)), "ascii")).hexdigest()


def augment_inputs(imread: Callable, crop, seed: int):
    """(image, keypoints, mask) of an augmentation case: the crop of
    render_1's colour render as cv2.imread reads it (RGB), 200 keypoints
    drawn from RandomState(seed + 1000) and the render's mask; `imread`
    is cv2.imread or gd3d_torch.data.png.imread."""
    h, w = crop
    img = imread(str(TESTDATA / "render_1_color.png"), 1)[:h, :w, ::-1].copy()
    mask = imread(str(TESTDATA / "render_1_mask.png"), 0)[:h, :w] > 0
    kps = (np.random.RandomState(seed + 1000).rand(200, 2) * [w, h]).astype(np.float32)
    return img, kps, mask


def augment_record(fn: Callable, imread: Callable, name: str, seed: int, crop,
                   kwargs) -> Dict:
    """The digests of one augmentation case with the functions `fn(name)`."""
    img, kps, mask = augment_inputs(imread, crop, seed)
    rng = np.random.RandomState(seed)
    if name == "shift_scale_rotate":
        out_img, out_kps, out_mask = fn(name)(img, kps, mask, rng, **kwargs)
        out = {"img": sha(out_img), "kps": sha(out_kps), "mask": sha(out_mask)}
    else:
        out = {"img": sha(fn(name)(img, rng, **kwargs))}
    out["rng"] = rng_sha(rng)
    return out


def port_digests(sections=("png", "jpeg", "loaders", "augment", "batches"),
                 workers: int = 0) -> Dict:
    """The port's digests of the fixtures, in digests.json's layout."""
    from gd3d_torch.data import augment, images, png
    from gd3d_torch.data.pipeline import DataSpec, EpochSource
    from gd3d_torch.data.resample import resize_bicubic

    ref = json.loads((TESTDATA / "digests.json").read_text())
    out: Dict = {}
    if "png" in sections:
        out["png"] = {}
        for name in ref["png"]:
            decoded = png.decode_png(TESTDATA / name)
            rec = {m: sha(png.cv2_view(decoded, f)) for m, f in PNG_MODES.items()}
            rec["pil"] = sha(images.open_rgb(TESTDATA / name))
            out["png"][name] = rec
    if "jpeg" in sections:
        out["jpeg"] = {name: {"pil": sha(images.open_rgb(TESTDATA / name))}
                       for name in ref["jpeg"]}
    if "loaders" in sections:
        out["loaders"] = {}
        for case, (kind, files, kw) in LOADER_CASES.items():
            paths = [str(TESTDATA / f) for f in files]
            if kind == "mast3r":
                res = images.load_image_mast3r(paths[0], **kw)
                out["loaders"][case] = {"img": sha(res["img"]),
                                        "true_shape": sha(res["true_shape"])}
            elif kind == "vggt":
                out["loaders"][case] = {"img": sha(images.load_images_vggt(paths, **kw))}
            else:
                raw = images.decode_rgb(images.read_bytes(paths[0]))
                out["loaders"][case] = {"img": sha(resize_bicubic(raw, (512, 512)))}
    if "augment" in sections:
        out["augment"] = {case: augment_record(lambda n: getattr(augment, n), png.imread,
                                               *spec)
                          for case, spec in AUGMENT_CASES.items()}
    if "batches" in sections:
        out["batches"] = {}
        with tempfile.TemporaryDirectory() as tmp:
            write_scannetpp_tree(tmp)
            write_objaverse_tree(tmp)
            for config, (teacher, dataset, steps) in BATCH_RUNS.items():
                source = EpochSource(DataSpec(teacher, dataset, SEED, tmp, 1), workers)
                try:
                    out["batches"][config] = [{k: sha(v) for k, v in b.items()}
                                              for b in source.batches(0, steps)]
                finally:
                    source.close()
    return out


def mismatches(got: Dict, want: Dict, path: str = "") -> list:
    """The paths where two digest trees differ."""
    if isinstance(want, dict) and isinstance(got, dict):
        keys = sorted(set(want) | set(got))
        return [m for k in keys for m in mismatches(got.get(k), want.get(k), f"{path}/{k}")]
    if isinstance(want, list) and isinstance(got, list) and len(want) == len(got):
        return [m for i, (g, w) in enumerate(zip(got, want))
                for m in mismatches(g, w, f"{path}[{i}]")]
    return [] if got == want else [path]
