"""Raw BlendedMVS / StaticThings3D / MegaDepth downloads -> the
dust3r-preprocessed pretraining trees (counterpart of
gd3d/data/preprocess_mvs.py, followed line for line: PIL's reads, Lanczos
rescales and JPEG writes are data/jpeg.py / data/png.py, data/resample.py
and data/jpeg_encode.py). Float depth is always the ``<name>.exr.npy``
sibling, what gd3d writes where its cv2 has no EXR codec. MegaDepth's raw
depth is HDF5, read with data/hdf5.py where gd3d opens it with h5py.

Parity targets:
  - dust3r/datasets_preprocess/preprocess_blendedMVS.py:36-143 — per
    frame: blended_images jpg + rendered_depth_maps PFM + cams txt
    (world2cam 4x4 then K 3x3) -> cover-rescale to (512, 384), jpg q80 +
    float depth + npz(intrinsics, R_cam2world, t_cam2world).
  - dust3r/datasets_preprocess/preprocess_staticthings3d.py:36-124 —
    frames 6..15 of TRAIN/{A,B,C}/<seq>/{left,right}: .float3 blobs for
    intrinsics/world2cam-pose/depth + clean/final pngs -> (512, 384),
    both jpg variants q80 + float depth + npz(intrinsics, cam2world).
  - dust3r/datasets_preprocess/preprocess_megadepth.py:32-150 — COLMAP
    'manhattan' text model (SIMPLE_RADIAL), h5 depth, undistorted K via
    getOptimalNewCameraMatrix(alpha=0, centerPrincipalPoint=True),
    orientation-aware downscale to (800, 600) without upscaling, jpg q90
    + float depth + npz(intrinsics, cam2world).

Float depth: the reference writes EXR via cv2. cv2 builds without the
EXR codec (this image's) write a float32 ``<name>.exr.npy`` sibling
instead — data/stereo_views.py's `read_depth_float` reads either. The
precomputed-pairs file is additionally copied into the output root under
the name the corresponding loader expects (the reference leaves that
copy to the user).
"""
from __future__ import annotations

import os
import os.path as osp
import re
import shutil
from typing import Dict, List, Tuple

import numpy as np

from gd3d_torch.data import hdf5
from gd3d_torch.data.jpeg_encode import save_jpeg
from gd3d_torch.data.stereo_views import _open_rgb, rescale_view
from gd3d_torch.data.undistort import optimal_new_camera_matrix


def write_depth_float(path_exr: str, depth: np.ndarray) -> None:
    """The float32 ``<path_exr>.npy`` sibling (the port writes no EXR)."""
    np.save(path_exr + ".npy", np.asarray(depth, np.float32))


# ------------------------------------------------------------- readers
def load_pfm(path: str) -> np.ndarray:
    """PFM (BlendedMVS rendered_depth_maps) — bottom-up scanline order,
    endianness from the scale sign (preprocess_blendedMVS.py:110-143)."""
    with open(path, "rb") as f:
        header = f.readline().decode().strip()
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"{path} is not a PFM file")
        m = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode())
        if not m:
            raise ValueError(f"invalid PFM header in {path}")
        w, h = map(int, m.groups())
        scale = float(f.readline().decode().strip())
        dtype = "<f" if scale < 0 else ">f"
        data = np.frombuffer(f.read(), dtype=dtype)
    data = data.reshape((h, w, 3) if channels == 3 else (h, w))
    return np.ascontiguousarray(data[::-1])  # stored bottom-up


def read_float3(path: str) -> np.ndarray:
    """lmb-freiburg .float3 blob: 'float\\n', ndim, dims (fastest-varying
    first), raw float32 (preprocess_staticthings3d.py:108-124)."""
    with open(path, "rb") as f:
        if f.readline().decode() != "float\n":
            raise ValueError(f"{path} missing the float keyword")
        ndim = int(f.readline())
        dims = [int(f.readline()) for _ in range(ndim)]
        count = int(np.prod(dims))
        return np.fromfile(f, np.float32, count).reshape(dims[::-1])


def load_blendedmvs_cam(path: str):
    """BlendedMVS *_cam.txt: 'extrinsic' + 4x4 world2cam, blank +
    'intrinsic' + 3x3 K (preprocess_blendedMVS.py:96-107). Returns
    (K, R_cam2world, t_cam2world)."""
    with open(path) as f:
        RT = np.loadtxt(f, skiprows=1, max_rows=4, dtype=np.float32)
        assert RT.shape == (4, 4), path
        K = np.loadtxt(f, skiprows=2, max_rows=3, dtype=np.float32)
        assert K.shape == (3, 3), path
    RT = np.linalg.inv(RT)
    return K, RT[:3, :3], RT[:3, 3]


# ----------------------------------------------------------- BlendedMVS
def process_blendedmvs_frame(root: str, img: str, out_dir: str) -> None:
    """(preprocess_blendedMVS.py:63-86)."""
    if osp.isfile(osp.join(out_dir, img + ".npz")):
        return
    K, R_c2w, t_c2w = load_blendedmvs_cam(
        osp.join(root, "cams", img + "_cam.txt"))
    image = _open_rgb(osp.join(root, "blended_images", img + ".jpg"))
    depth = load_pfm(osp.join(root, "rendered_depth_maps", img + ".pfm"))
    H, W = image.shape[:2]
    assert H * 4 == W * 3, (H, W)
    image, depth, K_out = rescale_view(image, depth, K, (512, 384))
    save_jpeg(osp.join(out_dir, img + ".jpg"), image, quality=80)
    write_depth_float(osp.join(out_dir, img + ".exr"), depth)
    # R_in2out is identity for a pure rescale (:89-93)
    np.savez(osp.join(out_dir, img + ".npz"), intrinsics=K_out,
             R_cam2world=R_c2w, t_cam2world=t_c2w)


def run_blendedmvs(args) -> None:
    """python -m gd3d_torch.cli.preprocess --dataset blendedmvs --raw-dir <BlendedMVS(+,++)
    unzipped root> --pairs-dir <blendedmvs_pairs.npy> --output-dir."""
    if args.pairs_dir is None:
        raise SystemExit("--pairs-dir (the precomputed "
                         "blendedmvs_pairs.npy) is required")
    sequences = [f for f in os.listdir(args.raw_dir) if len(f) == 24]
    assert sequences, f"no 24-char sequence dirs at {args.raw_dir}"
    for seq in sequences:
        print(f"processing {seq}", flush=True)
        out_dir = osp.join(args.output_dir, seq)
        os.makedirs(out_dir, exist_ok=True)
        root = osp.join(args.raw_dir, seq)
        for f in sorted(os.listdir(osp.join(root, "cams"))):
            if not f.startswith("pair"):
                process_blendedmvs_frame(root, f[:-8], out_dir)
    # verify every pair's frames exist (:53-58), then ship the pairs file
    pairs = np.load(args.pairs_dir)
    for seqh, seql, img1, img2, _score in pairs:
        for view_index in (img1, img2):
            impath = osp.join(args.output_dir,
                              f"{int(seqh):08x}{int(seql):016x}",
                              f"{int(view_index):08n}.jpg")
            assert osp.isfile(impath), f"missing image {impath}"
    shutil.copyfile(args.pairs_dir,
                    osp.join(args.output_dir, "blendedmvs_pairs.npy"))
    print(f"preprocessed tree -> {args.output_dir}")


# -------------------------------------------------------- StaticThings3D
def process_staticthings_frame(db_root: str, relpath_: str, camera: str,
                               num: str, out_dir: str) -> None:
    """(preprocess_staticthings3d.py:57-85)."""
    relpath = osp.join(relpath_, camera, num)
    if osp.isfile(osp.join(out_dir, relpath + ".npz")):
        return
    os.makedirs(osp.join(out_dir, relpath_, camera), exist_ok=True)
    K = read_float3(osp.join(db_root, "intrinsics", relpath_,
                             num + ".float3"))
    cam2world = np.linalg.inv(read_float3(
        osp.join(db_root, "poses", relpath + ".float3")))
    depth = read_float3(osp.join(db_root, "depths", relpath + ".float3"))
    img_clean = _open_rgb(osp.join(db_root, "frames_cleanpass",
                                     relpath + ".png"))
    img_final = _open_rgb(osp.join(db_root, "frames_finalpass",
                                     relpath + ".png"))
    assert img_clean.shape[:2] == (540, 960) and img_final.shape[:2] == (540, 960)
    # one joint geometry: depth+K ride the clean pass; the final pass is
    # the same deterministic Lanczos resample (the reference feeds both
    # through one rescale_image_depthmap call)
    clean_out, depth_out, K_out = rescale_view(img_clean, depth, K,
                                               (512, 384))
    final_out, _, _ = rescale_view(img_final, None, K, (512, 384))
    save_jpeg(osp.join(out_dir, relpath + "_clean.jpg"), clean_out, quality=80)
    save_jpeg(osp.join(out_dir, relpath + "_final.jpg"), final_out, quality=80)
    write_depth_float(osp.join(out_dir, relpath + ".exr"), depth_out)
    np.savez(osp.join(out_dir, relpath + ".npz"), intrinsics=K_out,
             cam2world=cam2world)


def run_staticthings3d(args) -> None:
    """python -m gd3d_torch.cli.preprocess --dataset staticthings3d --raw-dir <StaticThings3D>
    --pairs-dir <staticthings_pairs.npy> --output-dir."""
    if args.pairs_dir is None:
        raise SystemExit("--pairs-dir (the precomputed "
                         "staticthings_pairs.npy) is required")
    scenes: List[Tuple[str, str, str]] = []
    for split in ("TRAIN",):  # :95-105
        for subsplit in "ABC":
            sub = osp.join(args.raw_dir, "intrinsics", split, subsplit)
            if not osp.isdir(sub):
                continue
            for seq in sorted(os.listdir(sub)):
                scenes.append((split, subsplit, seq))
    assert scenes, f"found no scenes at {args.raw_dir}"
    for split, subsplit, seq in scenes:
        print(f"processing {split}/{subsplit}/{seq}", flush=True)
        for camera in ("left", "right"):
            for n in range(6, 16):  # :40-41
                process_staticthings_frame(
                    args.raw_dir, osp.join(split, subsplit, seq),
                    camera, f"{n:04d}", args.output_dir)
    CAM = {b"l": "left", b"r": "right", "l": "left", "r": "right"}
    pairs = np.load(args.pairs_dir)
    for scene, seq, cam1, im1, cam2, im2 in pairs:
        scene = scene.decode("ascii") if isinstance(scene, bytes) \
            else str(scene)
        seq_path = osp.join("TRAIN", scene, f"{int(seq):04d}")
        for cam, idx in ((CAM[cam1], im1), (CAM[cam2], im2)):
            for ext in ("clean", "final"):
                impath = osp.join(args.output_dir, seq_path, cam,
                                  f"{int(idx):04n}_{ext}.jpg")
                assert osp.isfile(impath), f"missing image {impath}"
    shutil.copyfile(args.pairs_dir,
                    osp.join(args.output_dir, "staticthings_pairs.npy"))
    print(f"preprocessed tree -> {args.output_dir}")


# ------------------------------------------------------------ MegaDepth
def load_megadepth_sfm(root: str, scene: str, subscene: str):
    """COLMAP 'manhattan' text model: SIMPLE_RADIAL cameras + image
    poses (preprocess_megadepth.py:106-150). Returns
    {img: w2cam 4x4}, {img: ((w, h), K, distortion)}."""
    sfm = osp.join(root, scene, "sparse", "manhattan", subscene)
    with open(osp.join(sfm, "cameras.txt")) as f:
        raw = f.readlines()[3:]
    cams: Dict[int, tuple] = {}
    for camera in raw:
        camera = camera.split(" ")
        width, height, focal, cx, cy, k0 = [float(e) for e in camera[2:]]
        K = np.eye(3)
        K[0, 0] = K[1, 1] = focal
        K[0, 2], K[1, 2] = cx, cy
        cams[int(camera[0])] = ((int(width), int(height)), K,
                                (k0, 0, 0, 0))
    with open(osp.join(sfm, "images.txt")) as f:
        raw = f.read().splitlines()[4:]
    poses, intrinsics = {}, {}
    for image in raw[0::2]:
        image = image.split(" ")
        img_id = image[-1]
        qw, qx, qy, qz, tx, ty, tz = [float(e) for e in image[1:-2]]
        q = np.array([qw, qx, qy, qz])
        w, x, y, z = q / np.linalg.norm(q)
        R = np.array([  # :165-185 (w2cam)
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
             2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
             2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
             1 - 2 * x * x - 2 * y * y]])
        pose = np.eye(4)
        pose[:3, :3] = R
        pose[:3, 3] = (tx, ty, tz)
        poses[img_id] = pose
        intrinsics[img_id] = cams[int(image[-2])]
    return poses, intrinsics


def process_megadepth_image(in_dir: str, tag: str, K_pre_rectif,
                            pose_w2cam: np.ndarray, out_dir: str) -> None:
    """(preprocess_megadepth.py:65-103)."""
    if osp.isfile(osp.join(out_dir, tag + ".npz")):
        return
    image = _open_rgb(osp.join(in_dir, "imgs", tag))
    depth = hdf5.read_dataset(osp.join(in_dir, "depths", osp.splitext(tag)[0] + ".h5"),
                              "depth")
    imsize_pre, K_pre, distortion = K_pre_rectif
    size = (image.shape[1], image.shape[0])
    K_post = optimal_new_camera_matrix(np.asarray(K_pre, np.float64),
                                       np.asarray(distortion, np.float64), imsize_pre, 0,
                                       new_size=size, center_principal_point=True)
    # orientation-aware target, no upscaling (:95-100, force=False)
    W, H = size
    res = sorted((800, 600))[::+1 if W < H else -1]
    image, depth, K_out = rescale_view(image, depth, K_post, res, force=False)
    save_jpeg(osp.join(out_dir, tag + ".jpg"), image, quality=90)
    write_depth_float(osp.join(out_dir, tag + ".exr"), depth)
    cam2world = np.linalg.inv(pose_w2cam)
    np.savez(osp.join(out_dir, tag + ".npz"), intrinsics=K_out, cam2world=cam2world)


def run_megadepth(args) -> None:
    """python -m gd3d_torch.cli.preprocess --dataset megadepth --raw-dir <MegaDepth_v1>
    --pairs-dir <megadepth pairs npz> --output-dir."""
    if args.pairs_dir is None:
        raise SystemExit("--pairs-dir (the precomputed megadepth pairs "
                         "npz) is required")
    data = np.load(args.pairs_dir, allow_pickle=True)
    scenes, images, pairs = data["scenes"], data["images"], data["pairs"]
    todo: Dict[int, set] = {}
    for scene, im1, im2, _score in pairs:
        todo.setdefault(int(scene), set()).update((int(im1), int(im2)))
    for scene_id, im_idxs in todo.items():
        scene, subscene = str(scenes[scene_id]).split()
        print(f"processing {scene}/{subscene}", flush=True)
        out_dir = osp.join(args.output_dir, scene, subscene)
        os.makedirs(out_dir, exist_ok=True)
        poses, intrinsics = load_megadepth_sfm(args.raw_dir, scene,
                                               subscene)
        in_dir = osp.join(args.raw_dir, scene, "dense" + subscene)
        for img in (str(images[i]) for i in sorted(im_idxs)):
            process_megadepth_image(in_dir, img, intrinsics[img],
                                    poses[img], out_dir)
    shutil.copyfile(args.pairs_dir,
                    osp.join(args.output_dir, "all_metadata.npz"))
    print(f"preprocessed tree -> {args.output_dir}")
