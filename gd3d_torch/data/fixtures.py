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
  - `write_onepose_tree(root)`: <root>/lowtexture_test_data and
    <root>/sfm_output/outputs_softmax_loftr_loftr, gd3d's OnePose-LowTexture
    layout, with two objects (see its docstring): a known answer, whose test
    frames are copies of its one template frame under that frame's pose,
    and a template bank of `bank_frames` x `bank_kps` rows. PNGs are written
    with png.encode_png_rgb.
  - `write_co3d_tree(root)`: a preprocessed Co3D-v2 tree (the pretraining
    CLI's --co3d-root, gd3d/data/stereo_views.py's layout): one sequence of
    frames that cycle through the 192x144 JPEG fixtures co3d/frame_<k>.jpg, each
    with a metadata npz (intrinsics, an orbit's cam2world pose,
    maximum_depth), a 16-bit depth PNG and an 8-bit mask PNG, and
    selected_seqs_train.json.
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
CO3D_JPEGS = 4
CO3D_SIZE = (192, 144)


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


ONEPOSE_KNOWN, ONEPOSE_BANK = "0501-known", "0502-bank"


def texture(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A smooth random uint8 RGB texture (noise at 1/8 size, upsampled)."""
    small = rng.rand((h + 7) // 8, (w + 7) // 8, 3)
    big = np.repeat(np.repeat(small, 8, 0), 8, 1)[:h, :w]
    big = (big + np.roll(big, 4, 0) + np.roll(big, 4, 1) + rng.rand(h, w, 3) * 0.5) / 2.5
    return (big * 255).astype(np.uint8)


def _write_sequence(seq_dir: Path, png: bytes, copies: int, K: np.ndarray, pose: np.ndarray,
                    every_nth: int = 10) -> None:
    """color/<i>.png for i < copies (the same bytes), and intrin_ba and
    poses_ba for the frames the evaluation reads (every `every_nth` of the
    sorted names)."""
    for sub in ("color", "intrin_ba", "poses_ba"):
        (seq_dir / sub).mkdir(parents=True, exist_ok=True)
    names = [f"{i:03d}" for i in range(copies)]
    for name in names:
        (seq_dir / "color" / f"{name}.png").write_bytes(png)
    for name in sorted(names)[::every_nth]:
        np.savetxt(seq_dir / "intrin_ba" / f"{name}.txt", K)
        np.savetxt(seq_dir / "poses_ba" / f"{name}.txt", pose)


def write_onepose_tree(root, size=(512, 512), known_kps: int = 2000, bank_frames: int = 40,
                       bank_kps: int = 3200, bank_tests: int = 3, seed: int = 0) -> Dict:
    """gd3d's OnePose-LowTexture layout under `root` with two objects.

    ONEPOSE_KNOWN: one template frame (a smooth random texture, `size` =
    (H, W)) whose `known_kps` LoFTR keypoints are interior patch centres of
    the stride-4 query grid,
    their 3D points back-projected from a curved depth map through K and a
    seeded object-to-camera pose, and 11 copies of the frame as sequence 2
    (frames 0 and 10 read) with that pose as ground truth. Identical
    descriptors at identical pixels match each other, and EPnP on exact
    correspondences recovers the pose, so all three thresholds are 1.0.

    ONEPOSE_BANK: `bank_frames` template frames of `bank_kps` random
    keypoints each (random 3D points), filling the bank to 128 000 rows at
    the defaults (gd3d samples 120 000), and 10 * (bank_tests - 1) + 1 test
    frames (bank_tests read) of another texture.

    Returns K, the known pose and the known object's 2D and 3D points."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    H, W = size
    lt = root / "lowtexture_test_data"
    sfm = root / "sfm_output" / "outputs_softmax_loftr_loftr"
    K = np.array([[0.9 * W, 0.0, W / 2.0], [0.0, 0.9 * W, H / 2.0], [0.0, 0.0, 1.0]])

    # the known answer
    from gd3d_torch.data.png import encode_png_rgb
    from gd3d_torch.eval.pnp import rodrigues_to_matrix

    R = rodrigues_to_matrix(np.array([[0.3, -0.2, 0.1]]))[0]
    t = np.array([0.01, -0.02, 0.05])
    pose = np.eye(4)
    pose[:3, :3], pose[:3, 3] = R, t
    # interior patch centres (x, y = 4 + 8k in the frame): the query grid
    # holds them, and no other grid point has their descriptor (the grid's
    # first row and column are clamped copies of the first centres)
    gx, gy = np.meshgrid(np.arange(12, W - 11, 8), np.arange(12, H - 11, 8))
    grid = np.column_stack([gx.ravel(), gy.ravel()]).astype(float)
    kp2d = grid[np.sort(rng.choice(len(grid), known_kps, replace=False))]
    depth = 0.6 + 0.1 * (kp2d[:, 0] / W - 0.5) + 0.05 * np.sin(kp2d[:, 1] / H * np.pi)
    cam = depth[:, None] * np.column_stack([(kp2d[:, 0] - K[0, 2]) / K[0, 0],
                                            (kp2d[:, 1] - K[1, 2]) / K[1, 1], np.ones(len(kp2d))])
    kp3d = (cam - t) @ R
    name = ONEPOSE_KNOWN.split("-")[1]
    (lt / ONEPOSE_KNOWN / f"{name}-1" / "anno_loftr").mkdir(parents=True)
    (lt / ONEPOSE_KNOWN / f"{name}-1" / "color").mkdir(parents=True)
    (sfm / ONEPOSE_KNOWN / "anno").mkdir(parents=True)
    np.savez(sfm / ONEPOSE_KNOWN / "anno" / "anno_3d_average.npz", keypoints3d=kp3d)
    with open(lt / ONEPOSE_KNOWN / f"{name}-1" / "anno_loftr" / "0.json", "w") as f:
        json.dump({"keypoints2d": kp2d.tolist(),
                   "assign_matrix": [list(range(known_kps)), list(range(known_kps))]}, f)
    png = encode_png_rgb(texture(rng, H, W))
    (lt / ONEPOSE_KNOWN / f"{name}-1" / "color" / "0.png").write_bytes(png)
    _write_sequence(lt / ONEPOSE_KNOWN / f"{name}-2", png, 11, K, pose)

    # the bank
    name = ONEPOSE_BANK.split("-")[1]
    seq1 = lt / ONEPOSE_BANK / f"{name}-1"
    (seq1 / "anno_loftr").mkdir(parents=True)
    (seq1 / "color").mkdir(parents=True)
    (sfm / ONEPOSE_BANK / "anno").mkdir(parents=True)
    n3d = bank_frames * bank_kps
    np.savez(sfm / ONEPOSE_BANK / "anno" / "anno_3d_average.npz",
             keypoints3d=rng.uniform(-0.1, 0.1, (n3d, 3)))
    for i in range(bank_frames):
        kp = rng.uniform(0, [W - 1, H - 1], (bank_kps, 2))
        with open(seq1 / "anno_loftr" / f"{i:03d}.json", "w") as f:
            json.dump({"keypoints2d": kp.tolist(),
                       "assign_matrix": [list(range(bank_kps)),
                                         list(range(i * bank_kps, (i + 1) * bank_kps))]}, f)
        (seq1 / "color" / f"{i:03d}.png").write_bytes(encode_png_rgb(texture(rng, H, W)))
    _write_sequence(lt / ONEPOSE_BANK / f"{name}-2", encode_png_rgb(texture(rng, H, W)),
                    10 * (bank_tests - 1) + 1, K, pose)
    return {"K": K, "pose": pose, "kp2d": kp2d, "kp3d": kp3d}


def write_co3d_tree(root, frames: int = 8, seed: int = 0) -> Path:
    """The Co3D-v2 tree <root>/apple/seq1 (see the module docstring): depth
    a tilted plane 1.6 to 2.4 m deep with noise, stored as uint16 of
    depth / 4.0 (maximum_depth 4.0), the mask a centred rectangle, the
    cameras on a 2 m orbit about the origin. Returns <root>."""
    from gd3d_torch.data.png import encode_png

    root = Path(root)
    base = root / "apple" / "seq1"
    for sub in ("images", "depths", "masks"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    w, h = CO3D_SIZE
    K = np.array([[160.0, 0, w / 2], [0, 160.0, h / 2], [0, 0, 1]], np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    for i in range(frames):
        shutil.copyfile(TESTDATA / "co3d" / f"frame_{i % CO3D_JPEGS}.jpg",
                        base / "images" / f"frame{i:06d}.jpg")
        a = 2 * np.pi * i / (4 * frames)
        c, s = np.cos(a), np.sin(a)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        pose[:3, 3] = [2 * s, 0, -2 * c]
        np.savez(base / "images" / f"frame{i:06d}.npz", camera_intrinsics=K,
                 camera_pose=pose, maximum_depth=4.0)
        depth = 1.6 + 0.8 * xs / w + 0.05 * rng.rand(h, w)
        (base / "depths" / f"frame{i:06d}.jpg.geometric.png").write_bytes(
            encode_png((depth / 4.0 * 65535).astype(np.uint16)))
        mask = np.zeros((h, w), np.uint8)
        mask[12:-12, 16:-16] = 255
        (base / "masks" / f"frame{i:06d}.png").write_bytes(encode_png(mask))
    with open(root / "selected_seqs_train.json", "w") as f:
        json.dump({"apple": {"seq1": list(range(frames))}}, f)
    return root


# ---------------------------------------------------------------------------
# Raw downloads: the inputs of the render and preprocessing CLIs
# ---------------------------------------------------------------------------
# Every writer below fabricates one dataset's raw layout, in the form
# gd3d's preprocessors read (gd3d/cli/preprocess.py, gd3d/data/preprocess_*),
# from a seed, with numpy and the port's own encoders (data/png.py,
# data/jpeg_encode.py) only. The scenes are geometrically consistent: a
# textured plane PLANE_Z metres in front of cameras that translate along
# their x axis, so that a tree preprocessed from them gives live
# correspondences. Each returns what the CLI needs beside the raw root.

PLANE_Z = 2.0
RAW_DATASETS = ("co3d", "wildrgbd", "scannetpp", "arkitscenes", "blendedmvs",
                "staticthings3d", "megadepth", "waymo")


def _jpeg(path: Path, rgb: np.ndarray, quality: int = 90) -> None:
    from gd3d_torch.data.jpeg_encode import encode_jpeg

    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_jpeg(rgb, quality))


def _png(path: Path, arr: np.ndarray) -> None:
    from gd3d_torch.data.png import encode_png

    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(arr))


def _plane_views(rng: np.random.RandomState, n: int, h: int, w: int, step: float, fx: float):
    """n (h, w) views of one texture: view i is the texture shifted by
    i * step * fx / PLANE_Z pixels, what a camera moved i * step metres
    along x sees of a fronto-parallel plane PLANE_Z away."""
    shift = int(np.ceil(n * step * fx / PLANE_Z)) + 1
    big = texture(rng, h, w + shift)
    return [np.ascontiguousarray(big[:, int(round(i * step * fx / PLANE_Z)):][:, :w])
            for i in range(n)]


def write_raw_co3d(root, frames: int = 6, size=(120, 100), category: str = "apple",
                   seq: str = "106_1_2", seed: int = 0) -> Dict:
    """Co3D-v2's raw layout: <root>/<category>/{frame,sequence}_annotations.jgz
    (pytorch3d-NDC viewpoints), set_lists/set_lists_fewview_train.json,
    and per frame an RGB JPEG, a depth PNG whose 16 bits are float16 and a
    mask PNG. Returns the CLI's extra flags."""
    import gzip

    root = Path(root)
    rng = np.random.RandomState(seed)
    w, h = size
    fx, cx, cy = 110.0, w / 2 + 1.5, h / 2 - 1.0
    cat = root / category
    views = _plane_views(rng, frames, h, w, 0.03, fx)
    ann, rows = [], []
    for i in range(1, frames + 1):
        name = f"frame{i:06d}"
        img_rel = f"{category}/{seq}/images/{name}.jpg"
        depth_rel = f"{category}/{seq}/depths/{name}.jpg.geometric.png"
        mask_rel = f"{category}/{seq}/masks/{name}.png"
        _jpeg(root / img_rel, views[i - 1])
        depth = np.full((h, w), PLANE_Z, np.float16)
        depth[:4] = 0  # a band without depth
        _png(root / depth_rel, depth.view(np.uint16))
        mask = np.zeros((h, w), np.uint8)
        mask[h // 6:-h // 6, w // 6:-w // 6] = 255
        _png(root / mask_rel, mask)
        # world2cam translation along x in OpenCV, stored as pytorch3d NDC
        t_cv = np.array([-0.03 * i, 0.0, 0.0])
        R_stored = np.eye(3)
        R_stored[:, :2] *= -1
        T_stored = t_cv.copy()
        T_stored[:2] *= -1
        scale = min(w, h) / 2.0
        focal_ndc = [fx / scale, fx / scale]
        p0_ndc = ((np.array([w, h]) / 2.0 - [cx, cy]) / scale).tolist()
        ann.append({"sequence_name": seq, "frame_number": i,
                    "image": {"size": [h, w], "path": img_rel},
                    "depth": {"path": depth_rel, "scale_adjustment": 1.0},
                    "viewpoint": {"R": R_stored.T.tolist(), "T": T_stored.tolist(),
                                  "focal_length": focal_ndc, "principal_point": p0_ndc}})
        rows.append([seq, i, img_rel])
    (cat / "set_lists").mkdir(parents=True, exist_ok=True)
    with gzip.open(cat / "frame_annotations.jgz", "wt") as f:
        json.dump(ann, f)
    with gzip.open(cat / "sequence_annotations.jgz", "wt") as f:
        json.dump([{"sequence_name": seq, "viewpoint_quality_score": 1.0}], f)
    with open(cat / "set_lists" / "set_lists_fewview_train.json", "w") as f:
        json.dump({"train": rows, "test": rows[:2]}, f)
    return {"args": ["--category", category]}


def write_raw_wildrgbd(root, frames: int = 6, size=(120, 100), category: str = "mug",
                       seed: int = 1) -> Dict:
    """WildRGB-D's raw layout: <root>/<category>/scenes/scene_00{1,2}/
    {rgb,depth,masks}/%05d.png, metadata (K column-major), cam_poses.txt,
    and the two subset lists (scene_001 train, scene_002 test)."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    w, h = size
    fx, cx, cy = 110.0, w / 2 + 1.3, h / 2 - 1.4
    K = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1.0]])
    seqs = ("scenes/scene_001", "scenes/scene_002")
    for seq in seqs:
        d = root / category / seq
        views = _plane_views(rng, frames, h, w, 0.03, fx)
        rows = []
        for i in range(frames):
            _png(d / "rgb" / f"{i:05d}.png", views[i])
            depth = np.full((h, w), int(PLANE_Z * 1000), np.uint16)
            depth[-3:] = 0
            _png(d / "depth" / f"{i:05d}.png", depth)
            mask = np.full((h, w), 255, np.uint8)
            mask[:, :w // 8] = 0
            _png(d / "masks" / f"{i:05d}.png", mask)
            c2w = np.eye(4)
            c2w[0, 3] = 0.03 * i
            rows.append([i] + c2w.ravel().tolist())
        (d / "metadata").write_text(json.dumps({"K": K.T.ravel().tolist(), "w": w, "h": h}))
        np.savetxt(d / "cam_poses.txt", np.array(rows))
    for lf in ("camera_eval_list.json", "nvs_list.json"):
        (root / category / lf).write_text(json.dumps({"train": [seqs[0]], "val": [seqs[1]]}))
    return {"args": ["--num-frames", str(frames)]}


def _ply_mesh(path: Path, verts: np.ndarray, faces: np.ndarray) -> None:
    """A binary little-endian PLY: float x, y, z plus colour per vertex,
    uchar-counted int triangles."""
    path.parent.mkdir(parents=True, exist_ok=True)
    vdt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("r", "u1"), ("g", "u1"),
                    ("b", "u1")])
    rec = np.zeros(len(verts), vdt)
    rec["x"], rec["y"], rec["z"] = verts.T.astype(np.float32)
    rec["r"] = 200
    frec = np.zeros(len(faces), np.dtype([("n", "u1"), ("v", "<i4", (3,))]))
    frec["n"], frec["v"] = 3, faces
    head = (f"ply\nformat binary_little_endian 1.0\ncomment fabricated scan\n"
            f"element vertex {len(verts)}\nproperty float x\nproperty float y\n"
            f"property float z\nproperty uchar red\nproperty uchar green\n"
            f"property uchar blue\nelement face {len(faces)}\n"
            f"property list uchar int vertex_indices\nend_header\n")
    path.write_bytes(head.encode() + rec.tobytes() + frec.tobytes())


def _grid_mesh(n: int, half: float, z: float):
    """An (n x n)-cell grid of the plane at depth z, two triangles a cell."""
    xs = np.linspace(-half, half, n + 1)
    gx, gy = np.meshgrid(xs, xs)
    verts = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z)], -1)
    a = (np.arange(n)[:, None] * (n + 1) + np.arange(n)[None]).ravel()
    faces = np.concatenate([np.stack([a, a + 1, a + n + 2], -1),
                            np.stack([a, a + n + 2, a + n + 1], -1)])
    return verts, faces


def _colmap_text(d: Path, cam_line: str, entries) -> None:
    """cameras.txt (3 header lines) and images.txt (one header line; each
    image's line, then its 2D-point line) for world2cam poses."""
    d.mkdir(parents=True, exist_ok=True)
    (d / "cameras.txt").write_text("# h1\n# h2\n# h3\n" + cam_line + "\n")
    lines = ["# header"]
    for img_id, name, w2c in entries:
        t = w2c[:3, 3]  # the fabricated cameras do not rotate: q = (1, 0, 0, 0)
        lines.append(f"{img_id} 1.0 0.0 0.0 0.0 {t[0]} {t[1]} {t[2]} 1 {name}")
        lines.append("1.0 2.0 -1")
    (d / "images.txt").write_text("\n".join(lines) + "\n")


def write_raw_scannetpp(root, size=(160, 120), dslr: int = 3, seed: int = 2,
                        scene: str = "0a1b2c3d4e") -> Dict:
    """ScanNet++'s raw layout for one scene: data/<scene>/scans/
    mesh_aligned_0.05.ply (a 24 x 24-cell plane), dslr/ (OPENCV_FISHEYE
    camera with k1..k4, JPEGs and anonymisation masks, a masked patch in
    the first) and iphone/ (OPENCV camera with radial-tangential
    distortion, one JPEG); the pairs dir <root>/pairs (scene_list.json,
    <scene>/selected_pairs.npz)."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    w, h = size
    fx = 100.0
    data = root / "data" / scene
    verts, faces = _grid_mesh(24, 4.0, PLANE_Z)
    _ply_mesh(data / "scans" / "mesh_aligned_0.05.ply", verts, faces)
    views = _plane_views(rng, dslr + 1, h, w, 0.05, fx)
    entries = []
    for i in range(dslr):
        name = f"DSC{i + 1:05d}.JPG"
        w2c = np.eye(4)
        w2c[0, 3] = -0.05 * i
        entries.append((i + 1, name, w2c))
        _jpeg(data / "dslr" / "resized_images" / name, views[i])
        mask = np.full((h, w), 255, np.uint8)
        if i == 0:
            mask[h // 3:h // 2, w // 3:w // 2] = 0
        _png(data / "dslr" / "resized_anon_masks" / (name[:-3] + "png"), mask)
    _colmap_text(data / "dslr" / "colmap",
                 f"1 OPENCV_FISHEYE {w} {h} {fx} {fx * 1.01} {w / 2 + 2.5} {h / 2 - 1.5} "
                 "0.03 -0.01 0.002 -0.0005", entries)
    w2c = np.eye(4)
    w2c[0, 3] = -0.05 * dslr
    _colmap_text(data / "iphone" / "colmap",
                 f"1 OPENCV {w} {h} {fx} {fx} {w / 2 - 0.7} {h / 2 + 0.4} "
                 "-0.05 0.01 0.0005 -0.0004", [(1, "frame_000001.jpg", w2c)])
    _jpeg(data / "iphone" / "rgb" / "frame_000001.jpg", views[dslr])
    _png(data / "iphone" / "rgb_masks" / "frame_000001.png", np.full((h, w), 255, np.uint8))
    pairs = root / "pairs"
    (pairs / scene).mkdir(parents=True, exist_ok=True)
    selection = np.array([f"DSC{i + 1:05d}" for i in range(dslr)] + ["frame_000001"])
    np.savez(pairs / scene / "selected_pairs.npz", selection=selection,
             pairs=np.array([[i, i + 1, 0.9] for i in range(dslr)], np.float64))
    (pairs / "scene_list.json").write_text(json.dumps([scene]))
    return {"args": ["--pairs-dir", str(pairs), "--target-resolution", str(w)]}


def write_raw_arkitscenes(root, frames: int = 4, size=(96, 72), seed: int = 3,
                          scene: str = "41069021") -> Dict:
    """ARKitScenes' raw layout under Training/<scene>: vga_wide PNGs,
    half-size lowres_depth PNGs (mm), per-frame .pincam intrinsics and
    lowres_wide.traj. The device is held sideways (sky to the RIGHT), so
    the preprocessor turns every image and depth map upright. The pairs
    dir is <root>/pairs."""
    from scipy.spatial.transform import Rotation

    root = Path(root)
    rng = np.random.RandomState(seed)
    w, h = size
    sdir = root / "Training" / scene
    (sdir / "vga_wide_intrinsics").mkdir(parents=True, exist_ok=True)
    # device right -> world +z, device up -> world -x: sky RIGHT; the
    # camera looks along world +y at the plane y = PLANE_Z
    R = np.stack([[0.0, 0, 1], [1.0, 0, 0], [0.0, 1, 0]], axis=1)
    views = _plane_views(rng, frames, h, w, 0.05, 70.0)
    lines, names = [], []
    for i in range(frames):
        ts = 0.001 * (i + 1)
        pose = np.eye(4)
        pose[:3, :3] = R
        pose[:3, 3] = [0.0, 0.0, 0.05 * i]
        w2p = np.linalg.inv(pose)
        rv = Rotation.from_matrix(w2p[:3, :3]).as_rotvec()
        t = w2p[:3, 3]
        lines.append(f"{ts:.6f} {rv[0]} {rv[1]} {rv[2]} {t[0]} {t[1]} {t[2]}")
        name = f"{scene}_{ts:.3f}.png"
        names.append(name)
        _png(sdir / "vga_wide" / name, views[i])
        depth = np.full((h // 2, w // 2), int(PLANE_Z * 1000), np.uint16)
        depth[0] = 0
        _png(sdir / "lowres_depth" / name, depth)
        (sdir / "vga_wide_intrinsics" / f"{scene}_{ts:.3f}.pincam").write_text(
            f"{w} {h} 70.0 71.0 {w / 2 + 0.5} {h / 2 - 0.5}\n")
    (sdir / "lowres_wide.traj").write_text("\n".join(lines) + "\n")
    pairs = root / "pairs" / "Training"
    (pairs / scene).mkdir(parents=True, exist_ok=True)
    (pairs / "scene_list.json").write_text(json.dumps([scene]))
    np.savez(pairs / scene / "selected_pairs.npz", selection=np.array(names[:3]),
             pairs=np.array([[0, 1, 0.9], [1, 2, 0.8]]),
             sky_direction_scene=np.array(["RIGHT"]))
    return {"args": ["--pairs-dir", str(root / "pairs")]}


def _pfm(path: Path, arr: np.ndarray) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(arr, "<f4")
    path.write_bytes(f"Pf\n{arr.shape[1]} {arr.shape[0]}\n-1.0\n".encode()
                     + np.ascontiguousarray(arr[::-1]).tobytes())


def _float3(path: Path, arr: np.ndarray) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(arr, np.float32)
    head = f"float\n{arr.ndim}\n" + "".join(f"{d}\n" for d in arr.shape[::-1])
    path.write_bytes(head.encode() + arr.tobytes())


def _mat_txt(M: np.ndarray) -> str:
    return "".join(" ".join(repr(float(v)) for v in row) + "\n" for row in M)


def write_raw_blendedmvs(root, frames: int = 3, size=(128, 96), seed: int = 4) -> Dict:
    """BlendedMVS' raw layout for one 24-character sequence: cams/
    %08d_cam.txt (world2cam, then K) and pair.txt, blended_images/*.jpg,
    rendered_depth_maps/*.pfm; the pairs file <root>/blendedmvs_pairs.npy."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    w, h = size
    seqh, seql = 0, 5
    seq = root / "raw" / f"{seqh:08x}{seql:016x}"
    K = np.array([[90.0, 0, w / 2], [0, 90.0, h / 2], [0, 0, 1]])
    views = _plane_views(rng, frames, h, w, 0.05, 90.0)
    for i in range(frames):
        _jpeg(seq / "blended_images" / f"{i:08n}.jpg", views[i])
        _pfm(seq / "rendered_depth_maps" / f"{i:08n}.pfm",
             PLANE_Z + 0.01 * rng.rand(h, w))
        pose = np.eye(4)
        pose[0, 3] = 0.05 * i
        (seq / "cams").mkdir(parents=True, exist_ok=True)
        (seq / "cams" / f"{i:08n}_cam.txt").write_text(
            "extrinsic\n" + _mat_txt(np.linalg.inv(pose)) + "\nintrinsic\n" + _mat_txt(K)
            + "\n425.0 2.5\n")
    (seq / "cams" / "pair.txt").write_text("")
    rec = np.dtype([("seq_high", "<i8"), ("seq_low", "<i8"), ("im1", "<i4"), ("im2", "<i4"),
                    ("score", "<f4")])
    np.save(root / "blendedmvs_pairs.npy",
            np.array([(seqh, seql, i, i + 1, 0.9) for i in range(frames - 1)], rec))
    return {"raw": root / "raw", "args": ["--pairs-dir", str(root / "blendedmvs_pairs.npy")]}


def write_raw_staticthings3d(root, seed: int = 5) -> Dict:
    """StaticThings3D's raw layout for TRAIN/A/0000, frames 6..15 of both
    cameras at its 960x540: intrinsics/, poses/, depths/ as .float3 blobs
    and frames_{clean,final}pass PNGs; the pairs file
    <root>/staticthings_pairs.npy."""
    root = Path(root)
    raw = root / "raw"
    rng = np.random.RandomState(seed)
    rel = Path("TRAIN") / "A" / "0000"
    K = np.array([[500.0, 0, 480], [0, 500.0, 270], [0, 0, 1]], np.float32)
    w, h = 960, 540
    views = _plane_views(rng, 11, h, w, 0.01, 500.0)
    depth = np.full((h, w), PLANE_Z, np.float32)
    for c, cam in enumerate(("left", "right")):
        for n in range(6, 16):
            num = f"{n:04d}"
            _float3(raw / "intrinsics" / rel / f"{num}.float3", K)
            pose = np.eye(4, dtype=np.float32)
            pose[0, 3] = 0.01 * (n - 6 + c)
            _float3(raw / "poses" / rel / cam / f"{num}.float3", np.linalg.inv(pose))
            _float3(raw / "depths" / rel / cam / f"{num}.float3", depth)
            _png(raw / "frames_cleanpass" / rel / cam / f"{num}.png", views[n - 6 + c])
            final = views[n - 6 + c] // 2 + 64  # the final pass: another rendering
            _png(raw / "frames_finalpass" / rel / cam / f"{num}.png", final.astype(np.uint8))
    rec = np.dtype([("scene", "S2"), ("seq", "<i4"), ("cam1", "S1"), ("im1", "<i4"),
                    ("cam2", "S1"), ("im2", "<i4")])
    np.save(root / "staticthings_pairs.npy",
            np.array([(b"A", 0, b"l", 6, b"r", 7), (b"A", 0, b"l", 8, b"l", 9)], rec))
    return {"raw": raw, "args": ["--pairs-dir", str(root / "staticthings_pairs.npy")]}


HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"


def write_raw_megadepth(root, size=(96, 64), seed: int = 6) -> Dict:
    """MegaDepth's raw layout for scene 0001, subscene 0: the COLMAP
    'manhattan' text model (SIMPLE_RADIAL), dense0/imgs/*.jpg and
    dense0/depths/*.h5, each the float32 "depth" dataset (zeros where the
    depth is unknown) written by data/hdf5.py; the pairs file
    <root>/megadepth_pairs.npz."""
    root = Path(root)
    raw = root / "raw"
    rng = np.random.RandomState(seed)
    w, h = size
    sfm = raw / "0001" / "sparse" / "manhattan" / "0"
    sfm.mkdir(parents=True, exist_ok=True)
    dense = raw / "0001" / "dense0"
    (sfm / "cameras.txt").write_text(
        f"# h\n# h\n# h\n1 SIMPLE_RADIAL {w} {h} 70.0 {w / 2} {h / 2} 0.0\n")
    tags = ["im_a.jpg", "im_b.jpg"]
    lines = ["# h"] * 4
    views = _plane_views(rng, len(tags), h, w, 0.05, 70.0)
    for i, tag in enumerate(tags):
        lines += [f"{i + 1} 1 0 0 0 {-0.05 * i} 0 0 1 {tag}", "1 2 -1"]
        _jpeg(dense / "imgs" / tag, views[i])
        (dense / "depths").mkdir(parents=True, exist_ok=True)
        from gd3d_torch.data import hdf5

        depth = (2.0 + rng.rand(h, w) * 3.0).astype(np.float32)
        depth[rng.rand(h, w) < 0.1] = 0.0
        hdf5.write_dataset(dense / "depths" / (tag[:-4] + ".h5"), "depth", depth)
    (sfm / "images.txt").write_text("\n".join(lines) + "\n")
    rec = np.dtype([("scene_id", "<i8"), ("im1_id", "<i8"), ("im2_id", "<i8"),
                    ("score", "<f4")])
    np.savez(root / "megadepth_pairs.npz", scenes=np.array(["0001 0"]), images=np.array(tags),
             pairs=np.array([(0, 0, 1, 0.5)], rec))
    return {"raw": raw, "args": ["--pairs-dir", str(root / "megadepth_pairs.npz")]}


# protobuf wire format (the fields of waymo_open_dataset's Frame that the
# preprocessor reads)
def _vint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _vint(field << 3 | wire)


def _ld(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _vint(len(payload)) + payload


def _dbl(field: int, v: float) -> bytes:
    import struct

    return _tag(field, 1) + struct.pack("<d", float(v))


def _transform(mat4) -> bytes:
    return b"".join(_dbl(1, v) for v in np.ravel(mat4))


def _matrix(arr: np.ndarray, kind: str) -> bytes:
    """zlib(MatrixFloat / MatrixInt32): data = 1 packed, shape = 2 {dims}."""
    import zlib

    if kind == "float":
        data = _ld(1, np.asarray(arr, "<f4").tobytes())
    else:
        data = _ld(1, b"".join(_vint(int(v)) for v in np.ravel(arr)))
    return zlib.compress(data + _ld(2, _ld(1, b"".join(_vint(d) for d in arr.shape))))


def write_raw_waymo(root, frames: int = 2, size=(192, 128), seed: int = 7) -> Dict:
    """One Waymo Open .tfrecord of `frames` frames: the FRONT camera (a JPEG,
    its calibration) and the TOP lidar (computed beam inclinations, a
    per-pixel pose) whose returns land on a wall 8 m ahead, with their
    camera projections; the pairs file <root>/waymo_pairs.npz."""
    import struct

    from gd3d_torch.data.jpeg_encode import encode_jpeg
    from gd3d_torch.data.preprocess_waymo import AXES_TRANSFORMATION, masked_crc32c

    root = Path(root)
    raw = root / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    w, h = size
    f = 120.0
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    cam_to_car = np.eye(4)
    cam_to_car[:3, 3] = [1.5, 0.0, 1.6]
    top_ext = np.eye(4)
    top_ext[:3, 3] = [1.2, 0.0, 2.0]
    H_ri, W_ri = 16, 64
    incl = np.linspace(0.2, -0.3, H_ri)  # top-down, as the decoder reverses
    cam_calib = (_tag(1, 0) + _vint(1) + b"".join(_dbl(2, v) for v in [f, f, w / 2, h / 2,
                                                                          0, 0, 0, 0, 0])
                 + _ld(3, _transform(cam_to_car)) + _tag(4, 0) + _vint(w) + _tag(5, 0)
                 + _vint(h))
    laser_calib = (_tag(1, 0) + _vint(1) + _dbl(3, float(incl.min())) + _dbl(4, float(incl.max()))
                   + _ld(5, _transform(top_ext)))
    ratios = (np.arange(W_ri, 0, -1) - 0.5) / W_ri
    az = (ratios * 2 - 1) * np.pi
    trf = AXES_TRANSFORMATION @ np.linalg.inv(cam_to_car)
    views = _plane_views(rng, frames, h, w, 0.5, f)
    records = []
    for fi in range(frames):
        pose = np.eye(4)
        pose[0, 3] = 0.5 * fi
        wall = 8.0 - 0.5 * fi  # the wall at world x = 9.5 m
        # each return: the range at which its ray meets the wall
        dirs = np.stack([np.cos(az)[None] * np.cos(incl)[:, None],
                         np.sin(az)[None] * np.cos(incl)[:, None],
                         np.sin(incl)[:, None] * np.ones((1, W_ri))], -1)
        ri = np.zeros((H_ri, W_ri, 4), np.float32)
        front = dirs[..., 0] > 0.3
        ri[..., 0] = np.where(front, (wall + 1.5 - top_ext[0, 3]) / np.maximum(dirs[..., 0], 1e-3),
                              0).astype(np.float32)
        pts = dirs * ri[..., :1].astype(np.float64) + top_ext[:3, 3]
        cam = pts @ trf[:3, :3].T + trf[:3, 3]
        with np.errstate(divide="ignore", invalid="ignore"):
            px = np.round(f * cam[..., 0] / cam[..., 2] + w / 2)
            py = np.round(f * cam[..., 1] / cam[..., 2] + h / 2)
        seen = front & (cam[..., 2] > 0.5) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
        cp = np.zeros((H_ri, W_ri, 6), np.int32)
        cp[..., 0] = np.where(seen, 1, 0)
        cp[..., 1] = np.where(seen, px, 0)
        cp[..., 2] = np.where(seen, py, 0)
        ri_pose = np.zeros((H_ri, W_ri, 6), np.float32)
        ri_pose[..., 3:] = pose[:3, 3]
        ctx = _ld(1, b"segment-fabricated") + _ld(2, cam_calib) + _ld(3, laser_calib)
        image = (_tag(1, 0) + _vint(1) + _ld(2, encode_jpeg(views[fi], 95))
                 + _ld(3, _transform(pose)) + _dbl(5, 1.5 + fi))
        laser = _tag(1, 0) + _vint(1) + _ld(2, _ld(2, _matrix(ri, "float"))
                                           + _ld(3, _matrix(cp, "int32"))
                                           + _ld(4, _matrix(ri_pose, "float")))
        records.append(_ld(1, ctx) + _ld(3, _transform(pose)) + _ld(4, image) + _ld(5, laser))
    seq = "segment-fabricated.tfrecord"
    with open(raw / seq, "wb") as fh:
        for r in records:
            ln = struct.pack("<Q", len(r))
            fh.write(ln + struct.pack("<I", masked_crc32c(ln)) + r
                     + struct.pack("<I", masked_crc32c(r)))
    np.savez(root / "waymo_pairs.npz", scenes=np.array([seq]),
             frames=np.array([f"{i:05d}_1" for i in range(frames)]),
             pairs=np.array([[0, i, i + 1] for i in range(frames - 1)]))
    return {"raw": raw, "args": ["--pairs-dir", str(root / "waymo_pairs.npz")]}


def write_raw_tree(dataset: str, root) -> Dict:
    """The raw tree of `dataset` (one of RAW_DATASETS) under <root>:
    {"raw": the CLI's --raw-dir, "args": its other flags}."""
    root = Path(root)
    spec = {"co3d": write_raw_co3d, "wildrgbd": write_raw_wildrgbd,
            "scannetpp": write_raw_scannetpp, "arkitscenes": write_raw_arkitscenes,
            "blendedmvs": write_raw_blendedmvs, "staticthings3d": write_raw_staticthings3d,
            "megadepth": write_raw_megadepth, "waymo": write_raw_waymo}[dataset](root)
    spec.setdefault("raw", root)
    return spec


def preprocess_argv(dataset: str, raw_spec: Dict, out) -> list:
    """The preprocessing CLI's argv for a tree written by write_raw_tree
    (raw_spec None for habitat, which generates its scenes)."""
    if dataset == "habitat":
        return ["--dataset", "habitat", *HABITAT_ARGS, "--output-dir", str(out)]
    return ["--dataset", dataset, "--raw-dir", str(raw_spec["raw"]), "--output-dir", str(out),
            *raw_spec["args"]]


# the render CLI runs whose trees testdata/datagen_digests.json records
# ("{glb_root}" is the directory write_glb wrote GLB_NAME into), and the
# habitat generator's flags
GLB_NAME = "asset.glb"
RENDER_RUNS = {"procedural": ["--num-objects", "2", "--views", "6", "--size", "512"],
               "glb": ["--glb-root", "{glb_root}", "--views", "4", "--size", "512",
                       "--workers", "2"]}
HABITAT_ARGS = ["--num-sequences-per-object", "2", "--img-size", "64"]
# each preprocessed tree's reader in data/stereo_views.py and its arguments
TREE_VIEWS = {"co3d": ("Co3dViews", {"split": "train"}),
              "wildrgbd": ("WildRGBDViews", {"split": "train"}),
              "scannetpp": ("ScanNetppViews", {"split": "train"}),
              "arkitscenes": ("ARKitScenesViews", {"split": "train"}),
              "blendedmvs": ("BlendedMVSViews", {"split": None}),
              "staticthings3d": ("StaticThings3DViews", {"mask_bg": False}),
              "waymo": ("WaymoViews", {}),
              "megadepth": ("MegaDepthViews", {"split": "train"}),
              "habitat": ("HabitatViews", {"split": "train", "size": 64})}
DATAGEN_DIGESTS = TESTDATA / "datagen_digests.json"


def render_argv(run: str, glb_root, out) -> list:
    """The render CLI's argv for RENDER_RUNS[run]."""
    return [a.format(glb_root=glb_root) for a in RENDER_RUNS[run]] + ["--output", str(out)]


# ------------------------------------------------------------ a .glb asset
def write_glb(path, seed: int = 8) -> Path:
    """A small textured .glb: node 0 (TRS) holds an icosphere, indexed
    TRIANGLES with TEXCOORD_0 into an RGBA PNG texture (its alpha must be
    dropped, not composited) and a normalised uint8 COLOR_0; node 1, its
    child (a column-major matrix), holds a ground patch as a non-indexed
    TRIANGLE_STRIP with a JPEG texture, whose POSITION is a sparse
    accessor over a zero base (6 vertices, 4 overridden). Returns path."""
    import struct

    from gd3d_torch.data.jpeg_encode import encode_jpeg
    from gd3d_torch.data.png import encode_png
    from gd3d_torch.data.render_synthetic import icosphere

    path = Path(path)
    rng = np.random.RandomState(seed)
    blobs, views = [], []

    def add(blob: bytes) -> int:
        off = sum(len(b) for b in blobs)
        pad = (-off) % 4
        blobs.append(b"\0" * pad)
        views.append({"buffer": 0, "byteOffset": off + pad, "byteLength": len(blob)})
        blobs.append(blob)
        return len(views) - 1

    verts, faces = icosphere(1)
    verts = (verts * [0.6, 0.5, 0.4]).astype(np.float32)
    uv = np.stack([0.5 + np.arctan2(verts[:, 1], verts[:, 0]) / (2 * np.pi),
                   0.5 - np.arcsin(np.clip(verts[:, 2] / 0.4, -1, 1)) / np.pi], -1)
    colour = np.concatenate([rng.randint(128, 256, (len(verts), 3)),
                             np.full((len(verts), 1), 255)], 1).astype(np.uint8)
    rgba = np.concatenate([texture(rng, 32, 48), rng.randint(0, 256, (32, 48, 1))], 2)
    png_rgba = encode_png(rgba.astype(np.uint8))
    strip = np.array([[-1, -1, -0.5], [1, -1, -0.5], [-1, 0, -0.45], [1, 0, -0.45],
                      [-1, 1, -0.5], [1, 1, -0.5]], np.float32)
    sparse_idx = np.array([0, 1, 4, 5], np.uint16)
    strip_uv = np.array([[0, 0], [1, 0], [0, 0.5], [1, 0.5], [0, 1], [1, 1]], np.float32)
    v = [add(verts.tobytes()), add(faces.astype(np.uint16).tobytes()),
         add(uv.astype(np.float32).tobytes()), add(colour.tobytes()), add(png_rgba),
         add(encode_jpeg(texture(rng, 40, 40), 90)), add(sparse_idx.tobytes()),
         add(strip[sparse_idx].tobytes()), add(strip_uv.tobytes())]
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "rotation": [0.0, 0.0, 0.38268343, 0.92387953],
                   "scale": [1.0, 1.2, 1.0], "translation": [0.1, 0.0, 0.0], "children": [1]},
                  {"mesh": 1, "matrix": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, -0.1, 1]}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 2,
                                                   "COLOR_0": 3},
                                    "indices": 1, "material": 0}]},
                   {"primitives": [{"attributes": {"POSITION": 4, "TEXCOORD_0": 5},
                                    "mode": 5, "material": 1}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorFactor": [1, 0.9, 0.8, 1],
                                                "baseColorTexture": {"index": 0}}},
                      {"pbrMetallicRoughness": {"baseColorTexture": {"index": 1}}}],
        "textures": [{"source": 0}, {"source": 1}],
        "images": [{"bufferView": v[4], "mimeType": "image/png"},
                   {"bufferView": v[5], "mimeType": "image/jpeg"}],
        "accessors": [
            {"bufferView": v[0], "componentType": 5126, "count": len(verts), "type": "VEC3"},
            {"bufferView": v[1], "componentType": 5123, "count": faces.size, "type": "SCALAR"},
            {"bufferView": v[2], "componentType": 5126, "count": len(verts), "type": "VEC2"},
            {"bufferView": v[3], "componentType": 5121, "count": len(verts), "type": "VEC4",
             "normalized": True},
            {"componentType": 5126, "count": 6, "type": "VEC3",
             "sparse": {"count": 4, "indices": {"bufferView": v[6], "componentType": 5123},
                        "values": {"bufferView": v[7]}}},
            {"bufferView": v[8], "componentType": 5126, "count": 6, "type": "VEC2"}],
    }
    binary = b"".join(blobs)
    binary += b"\0" * ((-len(binary)) % 4)
    gltf["bufferViews"] = views
    gltf["buffers"] = [{"byteLength": len(binary)}]
    body = json.dumps(gltf).encode()
    body += b" " * ((-len(body)) % 4)
    out = struct.pack("<4sII", b"glTF", 2, 12 + 8 + len(body) + 8 + len(binary))
    out += struct.pack("<II", len(body), 0x4E4F534A) + body
    out += struct.pack("<II", len(binary), 0x004E4942) + binary
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(out)
    return path


# ------------------------------------------------------------ tree digests
def file_digest(path: Path) -> str:
    """SHA-256 of a file's decoded content (see tree_digests)."""
    from gd3d_torch.data.jpeg import decode_jpeg
    from gd3d_torch.data.png import decode_png

    def arr_sha(h, a):
        a = np.asarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(np.ascontiguousarray(a).tobytes() if a.dtype != object else repr(a).encode())

    h = hashlib.sha256()
    data = path.read_bytes()
    if path.suffix == ".png":
        arr_sha(h, decode_png(data).samples)
    elif path.suffix.lower() in (".jpg", ".jpeg"):
        arr_sha(h, decode_jpeg(data))
    elif path.suffix == ".npz":
        with np.load(path) as z:
            for k in sorted(z.files):
                h.update(k.encode())
                arr_sha(h, z[k])
    elif path.suffix == ".npy":
        arr_sha(h, np.load(path))
    elif path.suffix == ".json":
        h.update(json.dumps(json.loads(data), sort_keys=True).encode())
    else:
        h.update(data)
    return h.hexdigest()


def tree_files(root) -> list:
    """The files under <root>, as sorted relative POSIX paths."""
    root = Path(root)
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())


def tree_digests(root) -> Dict[str, str]:
    """{relative path: SHA-256 of its decoded content} of every file under
    <root>: a PNG's pixels (data/png.py's samples, dtype and shape), a
    JPEG's RGB as PIL decodes it (data/jpeg.py), each array of a .npz
    (sorted by name) or .npy, a .json file's parsed value, any other file's
    bytes."""
    root = Path(root)
    return {rel: file_digest(root / rel) for rel in tree_files(root)}
