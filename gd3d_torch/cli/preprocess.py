"""Raw dataset downloads -> the preprocessed training trees (counterpart of
gd3d/cli/preprocess.py, gd3d-preprocess).

    python -m gd3d_torch.cli.preprocess --dataset {co3d, wildrgbd,
        scannetpp, arkitscenes, habitat, waymo, blendedmvs, staticthings3d,
        megadepth} --raw-dir RAW --output-dir OUT [--pairs-dir ...]

Each writes the tree gd3d's CLI writes from the same input: the same
files, the same JSON, .npz and .npy contents, PNGs that decode to the same
pixels and JPEGs that decode to the same pixels as PIL's (the port's
encoder gives PIL's bytes, data/jpeg_encode.py). gd3d reads and writes with
PIL and cv2; the port decodes with data/png.py and data/jpeg.py, resizes
with data/resample.py and undistorts with data/undistort.py. Everything
runs on the host in numpy, as gd3d's does, and the module imports no
torch. MegaDepth's raw depth is HDF5, read with data/hdf5.py (h5py's
arrays without h5py).

The rest of this docstring is gd3d's.

The reference can take raw Co3D-v2 / WildRGB-D / ScanNet++ downloads to the
training-ready layouts its pretraining datasets consume
(dust3r/datasets_preprocess/preprocess_{co3d,wildrgbd,scannetpp}.py); this
CLI closes that loop on gd3d's side so `gd3d-pretrain
--{co3d,wildrgbd,scannetpp}-root` can be fed from raw downloads end-to-end.
Select with --dataset {co3d,wildrgbd,scannetpp} (default co3d).

Co3D behavior parity per frame (preprocess_co3d.py:130-295):

  1. pytorch3d-NDC viewpoint -> OpenCV intrinsics + world2cam
     (preprocess_co3d.py:65-113: NDC->screen via min(half_wh), column
     negation + transpose for the rotation, camera_pose = inv([R|t]))
  2. crop to the largest rectangle centered on the (rounded) principal
     point (:202-210)
  3. rescale so min dim >= 3/4 img_size (else max dim >= img_size), floor
     resolution, Lanczos/bicubic image + nearest depth&mask, intrinsics
     scaled in the colmap convention (:222-232 via cropping.py:56-101)
  4. write frame%06d.jpg, uint16 depth png scaled by the frame max
     (x/max*65535), mask png, and an npz with
     camera_intrinsics/camera_pose/maximum_depth (:240-252)
  5. per-category + merged selected_seqs_{split}.json indices, sequences
     filtered by viewpoint_quality_score > min_quality and subsampled with
     seed = --seed + category index (:130-166, :255-295)

The output tree is exactly what data/stereo_views.py's Co3dViews reads
(images/frame%06d.{jpg,npz}, depths/frame%06d.jpg.geometric.png,
masks/frame%06d.png, uint16/65535 * maximum_depth decode).
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import os.path as osp
import random

import numpy as np

from gd3d_torch.data.jpeg_encode import save_jpeg
from gd3d_torch.data.png import encode_png
from gd3d_torch.data.stereo_views import _open_l, _open_png, _open_rgb, crop_view, rescale_view

# preprocess_co3d.py:30-44 (dataset constants; index seeds the per-category
# sequence subsampling)
CATEGORIES = [
    "apple", "backpack", "ball", "banana", "baseballbat", "baseballglove",
    "bench", "bicycle", "book", "bottle", "bowl", "broccoli", "cake", "car",
    "carrot", "cellphone", "chair", "couch", "cup", "donut", "frisbee",
    "hairdryer", "handbag", "hotdog", "hydrant", "keyboard", "kite",
    "laptop", "microwave", "motorcycle", "mouse", "orange", "parkingmeter",
    "pizza", "plant", "remote", "sandwich", "skateboard", "stopsign",
    "suitcase", "teddybear", "toaster", "toilet", "toybus", "toyplane",
    "toytrain", "toytruck", "tv", "umbrella", "vase", "wineglass",
]
CATEGORIES_IDX = {cat: i for i, cat in enumerate(CATEGORIES)}
SINGLE_SEQUENCE_CATEGORIES = sorted(
    set(CATEGORIES) - {"microwave", "stopsign", "tv"})


# ------------------------------------------------- camera conventions
def ndc_to_opencv_camera(R_p3d, T_p3d, focal_ndc, pp_ndc, image_size_hw):
    """pytorch3d NDC viewpoint -> (R world2cam, tvec, K) in OpenCV pixels
    (preprocess_co3d.py:80-113, numpy transcription of the torch math)."""
    R_p3d = np.asarray(R_p3d, np.float64).copy()
    T_p3d = np.asarray(T_p3d, np.float64).copy()
    focal = np.asarray(focal_ndc, np.float64)
    p0 = np.asarray(pp_ndc, np.float64)
    hw = np.asarray(image_size_hw, np.float64)

    T_p3d[:2] *= -1
    R_p3d[:, :2] *= -1
    R = R_p3d.T  # world2cam rotation, OpenCV convention
    tvec = T_p3d

    image_size_wh = hw[::-1]
    scale = image_size_wh.min() / 2.0
    c0 = image_size_wh / 2.0
    principal_point = -p0 * scale + c0
    focal_length = focal * scale
    K = np.array(
        [[focal_length[0], 0.0, principal_point[0]],
         [0.0, focal_length[1], principal_point[1]],
         [0.0, 0.0, 1.0]], np.float32)
    return R.astype(np.float32), tvec.astype(np.float32), K


def read_co3d_depth_png(path: str) -> np.ndarray:
    """Raw Co3D depth: 16-bit png whose bits are float16 (:190-196)."""
    arr = np.array(_open_png(path), dtype=np.uint16)
    return arr.view(np.float16).astype(np.float32)


def write_u16_png(path: str, arr: np.ndarray) -> None:
    """Image.fromarray(arr.astype(np.uint16)).save(path): a 16-bit grey PNG."""
    write_png(path, arr.astype(np.uint16))


def write_png(path: str, arr: np.ndarray) -> None:
    """Image.fromarray(arr).save(path) of a uint8 or uint16 grey or uint8 RGB
    array."""
    with open(path, "wb") as f:
        f.write(encode_png(arr))


# ------------------------------------------------- per-frame pipeline
def preprocess_frame(image: np.ndarray, depth: np.ndarray,
                     mask: np.ndarray, K: np.ndarray,
                     img_size: int):
    """Crop-center-on-pp + coverage rescale (preprocess_co3d.py:202-232).
    Returns (uint8 RGB image, depth, mask, K)."""
    H, W = depth.shape
    cx, cy = np.round(K[:2, 2]).astype(int)
    min_margin_x = min(cx, W - cx)
    min_margin_y = min(cy, H - cy)
    bbox = (cx - min_margin_x, cy - min_margin_y,
            cx + min_margin_x, cy + min_margin_y)
    # depth and mask ride the crop/rescale as a 2-channel "depthmap"
    depth_mask = np.stack((depth, mask), axis=-1)
    image, depth_mask, K = crop_view(image, depth_mask, K, bbox)

    # NOTE the reference computes the scale from the PRE-crop (H, W)
    # (preprocess_co3d.py:222-227 uses the outer H, W) — reproduced
    scale = (img_size * 3 // 4) / min(H, W) + 1e-8
    out_res = np.floor(np.array([W, H]) * scale).astype(int)
    if max(out_res) < img_size:
        scale = img_size / max(H, W) + 1e-8
        out_res = np.floor(np.array([W, H]) * scale).astype(int)
    image, depth_mask, K = rescale_view(image, depth_mask, K, out_res)
    return image, depth_mask[:, :, 0], depth_mask[:, :, 1], K


def get_set_list(category_dir: str, split: str,
                 single_sequence_subset: bool = False):
    listdir = osp.join(category_dir, "set_lists")
    pattern = "manyview_dev" if single_sequence_subset else "fewview_train"
    sequences_all = []
    for f in sorted(os.listdir(listdir)):
        if pattern not in f:
            continue
        with open(osp.join(listdir, f)) as fh:
            sequences_all.extend(json.load(fh)[split])
    return sequences_all


def prepare_category(category: str, co3d_dir: str, output_dir: str,
                     img_size: int, split: str, min_quality: float,
                     max_sequences: int, seed: int,
                     single_sequence_subset: bool = False):
    """One category, one split -> {seq_name: [frame indices]}
    (preprocess_co3d.py:130-252)."""
    random.seed(seed)
    category_dir = osp.join(co3d_dir, category)
    sequences_all = get_set_list(category_dir, split, single_sequence_subset)
    sequences_numbers = sorted({s for s, _, _ in sequences_all})

    with gzip.open(osp.join(category_dir, "frame_annotations.jgz")) as f:
        frame_data = json.loads(f.read())
    with gzip.open(osp.join(category_dir, "sequence_annotations.jgz")) as f:
        sequence_data = json.loads(f.read())

    frames = {}
    for fd in frame_data:
        frames.setdefault(fd["sequence_name"], {})[fd["frame_number"]] = fd
    good = {s["sequence_name"] for s in sequence_data
            if s["viewpoint_quality_score"] > min_quality}
    sequences_numbers = [s for s in sequences_numbers if s in good]
    if len(sequences_numbers) > max_sequences:
        selected = random.sample(sequences_numbers, max_sequences)
    else:
        selected = sequences_numbers
    selected_dict = {s: [] for s in selected}
    todo = [(s, n, p) for s, n, p in sequences_all if s in selected_dict]

    for seq_name, frame_number, filepath in todo:
        frame_idx = int(filepath.split("/")[-1][5:-4])
        selected_dict[seq_name].append(frame_idx)
        fd = frames[seq_name][frame_number]
        assert fd["depth"]["scale_adjustment"] == 1.0
        R, tvec, K = ndc_to_opencv_camera(
            fd["viewpoint"]["R"], fd["viewpoint"]["T"],
            fd["viewpoint"]["focal_length"],
            fd["viewpoint"]["principal_point"],
            fd["image"]["size"])

        mask_rel = filepath.replace("images", "masks").replace(".jpg", ".png")
        image = _open_rgb(osp.join(co3d_dir, filepath))
        depth = read_co3d_depth_png(osp.join(co3d_dir, fd["depth"]["path"]))
        mask = np.asarray(_open_l(osp.join(co3d_dir, mask_rel)), np.float32) / 255.0

        image, depth, mask, K = preprocess_frame(
            image, depth, mask, K, img_size)

        camera_pose = np.eye(4, dtype=np.float32)
        camera_pose[:3, :3] = R
        camera_pose[:3, 3] = tvec
        camera_pose = np.linalg.inv(camera_pose)

        img_out = osp.join(output_dir, filepath)
        depth_out = osp.join(output_dir, fd["depth"]["path"])
        mask_out = osp.join(output_dir, mask_rel)
        for p in (img_out, depth_out, mask_out):
            os.makedirs(osp.split(p)[0], exist_ok=True)
        save_jpeg(img_out, image)
        # uint16 encode scaled by the frame max (:246-247); Co3dViews
        # decodes with the stored maximum_depth
        dmax = float(np.max(depth))
        write_u16_png(depth_out, depth / max(dmax, 1e-12) * 65535)
        write_png(mask_out, (mask * 255).astype(np.uint8))
        np.savez(img_out.replace("jpg", "npz"),
                 camera_intrinsics=K.astype(np.float32),
                 camera_pose=camera_pose,
                 maximum_depth=np.float32(dmax))
    return selected_dict


# ------------------------------------------------- WildRGB-D
# preprocess_wildrgbd.py:43-57: train = intersection of the two subset
# lists' train splits; test = everything else
def wildrgbd_set_list(category_dir: str, split: str):
    listfiles = ("camera_eval_list.json", "nvs_list.json")
    per_split = {s: {f: set() for f in listfiles} for s in ("train", "val")}
    for lf in listfiles:
        with open(osp.join(category_dir, lf)) as f:
            data = json.load(f)
        for s in ("train", "val"):
            per_split[s][lf].update(data[s])
    train = set.intersection(*per_split["train"].values())
    if split == "train":
        return train
    every = set.union(*per_split["train"].values(),
                      *per_split["val"].values())
    return every - train


def prepare_wildrgbd_sequences(category: str, wildrgbd_dir: str,
                               output_dir: str, img_size: int, split: str,
                               max_sequences: int, num_frames: int,
                               seed: int):
    """One category, one split -> {seq_name: [frame ids]}
    (preprocess_wildrgbd.py:60-164). Differences from the Co3D pipeline,
    reproduced: the crop bbox truncates float principal-point margins with
    int() (Co3D rounds the pp first), depth is written as RAW mm uint16
    (no per-frame max scaling / maximum_depth metadata), frames are
    linspace-subsampled to `num_frames`, and sequences live under a
    'scenes/...' prefix inside each category."""
    random.seed(seed)
    category_dir = osp.join(wildrgbd_dir, category)
    sequences_all = sorted(
        s for s in wildrgbd_set_list(category_dir, split)
        if osp.isdir(osp.join(category_dir, s)))
    if len(sequences_all) > max_sequences:
        selected = random.sample(sequences_all, max_sequences)
    else:
        selected = sequences_all

    selected_dict = {}
    for seq_name in selected:
        scene_dir = osp.join(category_dir, seq_name)
        scene_out = osp.join(output_dir, category, seq_name)
        with open(osp.join(scene_dir, "metadata")) as f:
            meta = json.load(f)
        # K is stored column-major (:88)
        K_raw = np.array(meta["K"], np.float64).reshape(3, 3).T
        K = np.array([[K_raw[0, 0], 0.0, K_raw[0, 2]],
                      [0.0, K_raw[1, 1], K_raw[1, 2]],
                      [0.0, 0.0, 1.0]])
        cx, cy = K[0, 2], K[1, 2]

        posefile = np.genfromtxt(osp.join(scene_dir, "cam_poses.txt"))
        cam2world = posefile[:, 1:].reshape(-1, 4, 4)
        frame_idx = posefile[:, 0]
        total = frame_idx.shape[0]
        assert total >= num_frames
        assert np.all(frame_idx == np.arange(total))
        frames = np.round(
            np.linspace(0, total - 1, num_frames)).astype(int).tolist()
        selected_dict[seq_name] = frames

        for fid in frames:
            image = _open_rgb(osp.join(scene_dir, "rgb", f"{fid:0>5d}.png"))
            depth = np.asarray(_open_png(
                osp.join(scene_dir, "depth", f"{fid:0>5d}.png")),
                np.float64)  # raw mm uint16
            mask = np.asarray(_open_png(
                osp.join(scene_dir, "masks", f"{fid:0>5d}.png")),
                np.float32)
            if mask.dtype != np.float32 or mask.max() > 1.0:
                mask = mask.astype(np.float32) / 255.0  # plt.imread scaling
            H, W = depth.shape

            # float margins, int()-truncated bbox (:122-128)
            min_margin_x = min(cx, W - cx)
            min_margin_y = min(cy, H - cy)
            bbox = (int(cx - min_margin_x), int(cy - min_margin_y),
                    int(cx + min_margin_x), int(cy + min_margin_y))
            depth_mask = np.stack((depth, mask), axis=-1)
            image_c, depth_mask, Kc = crop_view(image, depth_mask, K, bbox)

            # coverage rescale from the PRE-crop (H, W), same reference
            # quirk as Co3D (:132-138)
            scale = (img_size * 3 // 4) / min(H, W) + 1e-8
            out_res = np.floor(np.array([W, H]) * scale).astype(int)
            if max(out_res) < img_size:
                scale = img_size / max(H, W) + 1e-8
                out_res = np.floor(np.array([W, H]) * scale).astype(int)
            image_c, depth_mask, Kc = rescale_view(
                image_c, depth_mask, Kc, out_res)

            img_out = osp.join(scene_out, "rgb", f"{fid:0>5d}.jpg")
            depth_out = osp.join(scene_out, "depth", f"{fid:0>5d}.png")
            mask_out = osp.join(scene_out, "masks", f"{fid:0>5d}.png")
            meta_out = osp.join(scene_out, "metadata", f"{fid:0>5d}.npz")
            for pth in (img_out, depth_out, mask_out, meta_out):
                os.makedirs(osp.split(pth)[0], exist_ok=True)
            save_jpeg(img_out, image_c)
            write_u16_png(depth_out, depth_mask[:, :, 0])  # raw mm (:156)
            write_png(mask_out, (depth_mask[:, :, 1] * 255).astype(np.uint8))
            np.savez(meta_out, camera_intrinsics=Kc.astype(np.float32),
                     camera_pose=cam2world[fid].astype(np.float32))
    return selected_dict


def run_wildrgbd(args) -> None:
    categories = sorted(
        d for d in os.listdir(args.raw_dir)
        if osp.isdir(osp.join(args.raw_dir, d, "scenes")))
    os.makedirs(args.output_dir, exist_ok=True)
    per_split_counts = (("train", args.num_sequences_per_object),
                        ("test", args.test_num_sequences_per_object))
    for split, n_seq in per_split_counts:
        merged_path = osp.join(args.output_dir,
                               f"selected_seqs_{split}.json")
        if osp.isfile(merged_path):
            print(f"{merged_path} exists; skipping {split}")
            continue
        merged = {}
        for category in categories:
            cat_dir = osp.join(args.output_dir, category)
            os.makedirs(cat_dir, exist_ok=True)
            cat_path = osp.join(cat_dir, f"selected_seqs_{split}.json")
            if osp.isfile(cat_path):
                with open(cat_path) as f:
                    sel = json.load(f)
            else:
                print(f"processing {split} - {category}", flush=True)
                # the reference hashes the LITERAL string "category"
                # (preprocess_wildrgbd.py:202), so every category gets the
                # same seed offset — reproduced as the constant
                sel = prepare_wildrgbd_sequences(
                    category, args.raw_dir, args.output_dir,
                    args.img_size, split, n_seq, args.num_frames,
                    seed=args.seed + int(b"category".hex(), 16))
                with open(cat_path, "w") as f:
                    json.dump(sel, f)
            merged[category] = sel
        with open(merged_path, "w") as f:
            json.dump(merged, f)
    print(f"preprocessed tree -> {args.output_dir}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Preprocess a raw Co3D-v2 / WildRGB-D / ScanNet++ / "
                    "ARKitScenes / ... download into the tree "
                    "gd3d_torch.cli.pretrain "
                    "consumes")
    p.add_argument("--dataset", choices=("co3d", "wildrgbd", "scannetpp",
                                         "arkitscenes", "blendedmvs",
                                         "staticthings3d", "megadepth",
                                         "waymo", "habitat"),
                   default="co3d")
    p.add_argument("--habitat-sim", action="store_true",
                   help="habitat: drive real habitat-sim instead of the "
                        "synthetic-equivalent generator (requires the "
                        "upstream habitat stack; errors with the recipe "
                        "otherwise)")
    p.add_argument("--co3d-dir", default=None,
                   help="raw dataset root (alias of --raw-dir, kept for "
                        "the original co3d-only interface)")
    p.add_argument("--raw-dir", default=None, help="raw dataset root")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--category", default=None,
                   help="co3d: single category (default: all 51)")
    p.add_argument("--single-sequence-subset", action="store_true",
                   help="co3d: use the manyview_dev set lists instead of "
                        "fewview_train")
    p.add_argument("--num-sequences-per-object", type=int, default=50)
    p.add_argument("--test-num-sequences-per-object", type=int, default=10,
                   help="wildrgbd: sequences per category in the test split")
    p.add_argument("--num-frames", type=int, default=100,
                   help="wildrgbd: linspace-subsampled frames per sequence")
    p.add_argument("--min-quality", type=float, default=0.5,
                   help="co3d: minimum viewpoint_quality_score")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--target-resolution", type=int, default=920,
                   help="scannetpp: long-side resolution")
    p.add_argument("--pairs-dir", default=None,
                   help="scannetpp/arkitscenes: precomputed-pairs dir "
                        "(scene_list.json + per-scene selected_pairs.npz; "
                        "per Training/Test split for arkitscenes). For "
                        "blendedmvs/staticthings3d/megadepth/waymo: the "
                        "precomputed pairs FILE itself")
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)
    args.raw_dir = args.raw_dir or args.co3d_dir
    if args.raw_dir is None and args.dataset != "habitat":
        # habitat's synthetic-equivalent generator has no raw input
        p.error("--raw-dir (or --co3d-dir) is required")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.dataset == "habitat":
        from gd3d_torch.data.preprocess_habitat import run_habitat

        os.makedirs(args.output_dir, exist_ok=True)
        run_habitat(args)
        return
    assert osp.abspath(args.raw_dir) != osp.abspath(args.output_dir)
    if args.dataset == "wildrgbd":
        run_wildrgbd(args)
        return
    if args.dataset == "scannetpp":
        from gd3d_torch.data.preprocess_scannetpp import run_scannetpp
        run_scannetpp(args)
        return
    if args.dataset == "arkitscenes":
        from gd3d_torch.data.preprocess_arkitscenes import run_arkitscenes
        run_arkitscenes(args)
        return
    if args.dataset == "waymo":
        from gd3d_torch.data.preprocess_waymo import run_waymo

        os.makedirs(args.output_dir, exist_ok=True)
        run_waymo(args)
        return
    if args.dataset in ("blendedmvs", "staticthings3d", "megadepth"):
        from gd3d_torch.data import preprocess_mvs

        os.makedirs(args.output_dir, exist_ok=True)
        {"blendedmvs": preprocess_mvs.run_blendedmvs,
         "staticthings3d": preprocess_mvs.run_staticthings3d,
         "megadepth": preprocess_mvs.run_megadepth}[args.dataset](args)
        return
    args.co3d_dir = args.raw_dir
    if args.category is None:
        categories = (SINGLE_SEQUENCE_CATEGORIES
                      if args.single_sequence_subset else CATEGORIES)
    else:
        categories = [args.category]
    os.makedirs(args.output_dir, exist_ok=True)

    for split in ("train", "test"):
        merged_path = osp.join(args.output_dir,
                               f"selected_seqs_{split}.json")
        if osp.isfile(merged_path):
            print(f"{merged_path} exists; skipping {split}")
            continue
        merged = {}
        for category in categories:
            cat_dir = osp.join(args.output_dir, category)
            os.makedirs(cat_dir, exist_ok=True)
            cat_path = osp.join(cat_dir, f"selected_seqs_{split}.json")
            if osp.isfile(cat_path):
                with open(cat_path) as f:
                    sel = json.load(f)
            else:
                print(f"processing {split} - {category}", flush=True)
                sel = prepare_category(
                    category, args.co3d_dir, args.output_dir,
                    args.img_size, split, args.min_quality,
                    args.num_sequences_per_object,
                    seed=args.seed + CATEGORIES_IDX.get(category, 0),
                    single_sequence_subset=args.single_sequence_subset)
                with open(cat_path, "w") as f:
                    json.dump(sel, f)
            merged[category] = sel
        with open(merged_path, "w") as f:
            json.dump(merged, f)
    print(f"preprocessed tree -> {args.output_dir}")


if __name__ == "__main__":
    main()
