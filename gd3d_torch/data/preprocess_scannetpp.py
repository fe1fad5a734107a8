"""Raw ScanNet++ download -> the dust3r-preprocessed pretraining dump
(counterpart of gd3d/data/preprocess_scannetpp.py, followed line for line:
cv2's undistortion is data/undistort.py, PIL's reads, Lanczos rescale and
JPEG writes are data/jpeg.py, data/resample.py and data/jpeg_encode.py,
and the depth pass is data/render_synthetic.py's rasteriser at (H, W),
the arithmetic of gd3d's native library; rendered in face-ordered chunks,
so a scan mesh of 10^5-10^6 faces fits in memory).

Parity target: dust3r/datasets_preprocess/preprocess_scannetpp.py:43-391.
Per scene: parse the DSLR + iPhone COLMAP text reconstructions, undistort
the selected images (OPENCV_FISHEYE via cv2.fisheye with balance=0 and a
re-centered principal point, plain OPENCV via getOptimalNewCameraMatrix
alpha=1 — :136-178), coverage-rescale to (target, target*3/4) with the
colmap<->opencv half-pixel convention dance of the reference (:271-282),
render each view's depth from the laser-scan mesh at znear=0.05/zfar=20
(:184-300 — pyrender there; gd3d's native C++ z-buffer rasterizer here,
with a numpy fallback), invalidate depth under the anonymization mask,
write mm-uint16 pngs + per-scene scene_metadata.npz, then concatenate
everything into the all_metadata.npz that
data/stereo_views.py's `ScanNetppViews` consumes (:302-382).

The reference's load_sfm also parses points3D.txt and per-image sparse
observations (:106-121) that nothing downstream of this script reads;
skipped here. The raster depth differs from pyrender's OpenGL depth only
by sampling (both are perspective-correct z-buffers at pixel centers).
"""
from __future__ import annotations

import json
import os
import os.path as osp
import re
from typing import Dict, List, Tuple

import numpy as np

from gd3d_torch.data import undistort as ud
from gd3d_torch.data.jpeg import decode_jpeg
from gd3d_torch.data.jpeg_encode import save_jpeg
from gd3d_torch.data.png import decode_png, encode_png, pil_rgb
from gd3d_torch.data.stereo_views import (
    colmap_to_opencv_K,
    opencv_to_colmap_K,
    rescale_view,
)

REGEXPR_DSLR = re.compile(r"^DSC(?P<frameid>\d+).JPG$")
REGEXPR_IPHONE = re.compile(r"frame_(?P<frameid>\d+).jpg$")

# scannetpp's own render config (preprocess_scannetpp.py:184-187)
ZNEAR = 0.05
ZFAR = 20.0


# ------------------------------------------------------------ PLY mesh
_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal PLY reader for scan meshes (mesh_aligned_0.05.ply):
    vertex x/y/z (any extra per-vertex properties are skipped) + triangle
    faces. Supports binary_little_endian and ascii. Returns
    (verts float64 (V, 3), faces int32 (F, 3))."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply", "not a PLY file"
        fmt = None
        elements: List[Tuple[str, int, list]] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unterminated PLY header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok or tok[0] == "comment":
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                elements.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property":
                if tok[1] == "list":
                    elements[-1][2].append(
                        (tok[4], "list", _PLY_DTYPES[tok[2]],
                         _PLY_DTYPES[tok[3]]))
                else:
                    elements[-1][2].append((tok[2], _PLY_DTYPES[tok[1]]))
            elif tok[0] == "end_header":
                break
        assert fmt in ("ascii", "binary_little_endian"), fmt

        verts = faces = None
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    cols = [p[0] for p in props]
                    xi, yi, zi = (cols.index(c) for c in ("x", "y", "z"))
                    verts = np.array(
                        [[r[xi], r[yi], r[zi]] for r in rows], np.float64)
                elif name == "face":
                    faces = np.array(
                        [r[1:4] for r in rows], np.int64)
                    assert all(int(r[0]) == 3 for r in rows), \
                        "non-triangle face"
            else:
                if any(p[1] == "list" for p in props):
                    # face element: uniform-arity list (triangles)
                    (fname, _, cnt_t, idx_t), = props
                    cnt_sz = np.dtype(cnt_t).itemsize
                    first = f.peek(cnt_sz)[:cnt_sz]
                    if len(first) < cnt_sz:
                        first = f.read(cnt_sz)
                        f.seek(-cnt_sz, 1)
                    arity = int(np.frombuffer(first, f"<{cnt_t}")[0])
                    assert arity == 3, f"non-triangle face arity {arity}"
                    dt = np.dtype([("n", f"<{cnt_t}"),
                                   ("v", f"<{idx_t}", (3,))])
                    buf = f.read(dt.itemsize * count)
                    rec = np.frombuffer(buf, dt, count)
                    assert (rec["n"] == 3).all(), "mixed-arity faces"
                    if name == "face":
                        faces = rec["v"].astype(np.int64)
                else:
                    dt = np.dtype([(p[0], f"<{p[1]}") for p in props])
                    buf = f.read(dt.itemsize * count)
                    rec = np.frombuffer(buf, dt, count)
                    if name == "vertex":
                        verts = np.stack(
                            [rec["x"], rec["y"], rec["z"]],
                            -1).astype(np.float64)
    assert verts is not None and faces is not None
    return verts, faces.astype(np.int32)


def _read_image(path: str) -> np.ndarray:
    """np.array(Image.open(path)) of an RGB JPEG, or of a PNG: grey as
    (H, W), RGB as (H, W, 3), 8 bits."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    png = decode_png(data)
    if png.bit_depth != 8 or png.color_type not in (0, 2):
        raise ValueError(f"{path}: expected an 8-bit grey or RGB PNG")
    return png.samples[..., 0] if png.color_type == 0 else pil_rgb(png)


# ------------------------------------------------------------ COLMAP sfm
def pose_from_qwxyz_txyz(elems) -> np.ndarray:
    """COLMAP image line (qw qx qy qz tx ty tz, world2cam) -> cam2world
    (preprocess_scannetpp.py:53-58)."""
    from scipy.spatial.transform import Rotation

    qw, qx, qy, qz, tx, ty, tz = map(float, elems)
    pose = np.eye(4)
    pose[:3, :3] = Rotation.from_quat((qx, qy, qz, qw)).as_matrix()
    pose[:3, 3] = (tx, ty, tz)
    return np.linalg.inv(pose)


def get_frame_number(name: str, cam_type: str = "dslr") -> str:
    regex = REGEXPR_DSLR if cam_type == "dslr" else REGEXPR_IPHONE
    return re.match(regex, name)["frameid"]


def load_sfm(sfm_dir: str, cam_type: str = "dslr"):
    """cameras.txt + images.txt -> (img_idx name->id, img_infos id->dict)
    (preprocess_scannetpp.py:72-104; the reference also parses points3D
    observations that this flow never reads — skipped)."""
    with open(osp.join(sfm_dir, "cameras.txt")) as f:
        raw = f.read().splitlines()[3:]  # skip the 3 header lines
    intrinsics: Dict[int, list] = {}
    for camera in raw:
        camera = camera.split(" ")
        intrinsics[int(camera[0])] = (
            [camera[1]] + [float(c) for c in camera[2:]])

    with open(osp.join(sfm_dir, "images.txt")) as f:
        raw = [ln for ln in f.read().splitlines()
               if not ln.startswith("#")]

    img_idx: Dict[str, str] = {}
    img_infos: Dict[str, dict] = {}
    for image in raw[0::2]:  # every other line is the 2D-point list
        image = image.split(" ")
        idx, img_name = image[0], image[-1]
        assert img_name not in img_idx, "duplicate db image: " + img_name
        img_idx[img_name] = idx
        img_infos[idx] = dict(
            intrinsics=intrinsics[int(image[-2])],
            path=img_name,
            frame_id=get_frame_number(img_name, cam_type),
            cam_to_world=pose_from_qwxyz_txyz(image[1:-2]),
        )
    return img_idx, img_infos


# ---------------------------------------------------------- undistortion
def undistort_image(intrinsics: list, rgb: np.ndarray, mask: np.ndarray):
    """cv2 undistortion, both ScanNet++ camera models
    (preprocess_scannetpp.py:136-178), through data/undistort.py. Returns
    (new_K opencv-convention, undistorted rgb, undistorted mask)."""
    camera_type = intrinsics[0]
    width, height = int(intrinsics[1]), int(intrinsics[2])
    fx, fy, cx, cy = intrinsics[3:7]
    distortion = np.array(intrinsics[7:])

    K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    K = colmap_to_opencv_K(K).astype(np.float64)
    if camera_type == "OPENCV_FISHEYE":
        assert len(distortion) == 4
        new_K = ud.fisheye_new_camera_matrix(K, distortion, (width, height), np.eye(3),
                                             balance=0.0)
        # re-center the principal point (:165-167)
        new_K[0, 2] = width / 2.0
        new_K[1, 2] = height / 2.0
        map1, map2 = ud.fisheye_undistort_rectify_map(K, distortion, np.eye(3), new_K,
                                                      (width, height))
    else:
        new_K = ud.optimal_new_camera_matrix(K, distortion, (width, height), 1,
                                             (width, height), True)
        map1, map2 = ud.undistort_rectify_map(K, distortion, np.eye(3), new_K,
                                              (width, height))
    rgb_u = ud.remap_linear(rgb, map1, map2, ud.BORDER_REFLECT_101)
    mask_u = ud.remap_linear(mask, map1, map2, ud.BORDER_CONSTANT, 255)
    return new_K, rgb_u, mask_u


# ----------------------------------------------------------- depth render
def render_depth(verts: np.ndarray, faces: np.ndarray,
                 cam_to_world: np.ndarray, K: np.ndarray,
                 h: int, w: int) -> np.ndarray:
    """Z-buffer depth of the scan mesh from one camera, meters, 0 where
    empty/outside [ZNEAR, ZFAR] (the reference's pyrender DEPTH_ONLY pass,
    preprocess_scannetpp.py:287-294; the port's rasteriser here, depth
    only)."""
    w2c = np.linalg.inv(cam_to_world)
    cam = verts @ w2c[:3, :3].T + w2c[:3, 3]

    from gd3d_torch.data.render_synthetic import rasterize_mesh

    depth = rasterize_mesh(cam, faces, None, K, h, w)[1]
    depth = np.where(np.isfinite(depth), depth, 0.0)
    return np.where((depth >= ZNEAR) & (depth <= ZFAR), depth, 0.0)


# ------------------------------------------------------ pipeline
def process_scene(scene: str, root: str, pairsdir: str, output_dir: str,
                  target_resolution: int) -> None:
    """One scene -> images/ + depth/ + scene_metadata.npz
    (preprocess_scannetpp.py:196-324)."""
    data_dir = osp.join(root, "data", scene)
    dir_dslr = osp.join(data_dir, "dslr")
    dir_iphone = osp.join(data_dir, "iphone")
    dir_scans = osp.join(data_dir, "scans")
    assert osp.isdir(data_dir) and osp.isdir(dir_dslr) \
        and osp.isdir(dir_iphone) and osp.isdir(dir_scans)

    out_scene = osp.join(output_dir, scene)
    meta_path = osp.join(out_scene, "scene_metadata.npz")
    if osp.isfile(meta_path):
        return

    sel_npz = np.load(osp.join(pairsdir, scene, "selected_pairs.npz"))
    selection, pairs = sel_npz["selection"], sel_npz["pairs"]

    out_rgb = osp.join(out_scene, "images")
    out_depth = osp.join(out_scene, "depth")
    os.makedirs(out_rgb, exist_ok=True)
    os.makedirs(out_depth, exist_ok=True)

    verts, faces = read_ply_mesh(
        osp.join(dir_scans, "mesh_aligned_0.05.ply"))

    img_idx_dslr, img_infos_dslr = load_sfm(
        osp.join(dir_dslr, "colmap"), cam_type="dslr")
    img_idx_iphone, img_infos_iphone = load_sfm(
        osp.join(dir_iphone, "colmap"), cam_type="iphone")

    sel_dslr = [n + ".JPG" for n in selection if str(n).startswith("DSC")]
    sel_iphone = [n + ".jpg" for n in selection
                  if str(n).startswith("frame_")]
    cam_sets = [
        (sel_dslr, img_idx_dslr, img_infos_dslr,
         osp.join(dir_dslr, "resized_images"),
         osp.join(dir_dslr, "resized_anon_masks")),
        (sel_iphone, img_idx_iphone, img_infos_iphone,
         osp.join(dir_iphone, "rgb"),
         osp.join(dir_iphone, "rgb_masks")),
    ]
    for sel_cam, img_idx, img_infos, rgb_dir, mask_dir in cam_sets:
        for imgname in sel_cam:
            info = img_infos[img_idx[imgname]]
            rgb = _read_image(osp.join(rgb_dir, info["path"]))
            mask = _read_image(osp.join(mask_dir, info["path"][:-3] + "png"))

            new_K, rgb, mask = undistort_image(
                info["intrinsics"], rgb, mask)

            # the reference's convention dance (:273-279): shift new_K
            # into opencv pixel centers for the rescale, back to colmap
            # for storage/rendering
            K_cv = colmap_to_opencv_K(new_K)
            image, mask, K_cv = rescale_view(
                rgb, mask.astype(np.float32), K_cv,
                (target_resolution, target_resolution * 3.0 / 4))
            H, W = image.shape[:2]
            K_colmap = opencv_to_colmap_K(K_cv)
            info["intrinsics"] = K_colmap

            save_jpeg(osp.join(out_rgb, info["path"][:-3] + "jpg"), image)

            depth = render_depth(
                verts, faces, info["cam_to_world"], K_colmap, H, W)
            depth = (depth * 1000).astype(np.uint16)
            depth[mask < 255] = 0  # anonymization mask invalidates (:298)
            with open(osp.join(out_depth, info["path"][:-3] + "png"), "wb") as f:
                f.write(encode_png(depth))

    trajectories, intrinsics = [], []
    for imgname in selection:
        imgname = str(imgname)
        if imgname.startswith("DSC"):
            info = img_infos_dslr[img_idx_dslr[imgname + ".JPG"]]
        elif imgname.startswith("frame_"):
            info = img_infos_iphone[img_idx_iphone[imgname + ".jpg"]]
        else:
            raise ValueError(f"invalid image name {imgname}")
        intrinsics.append(info["intrinsics"])
        trajectories.append(info["cam_to_world"])

    np.savez(meta_path,
             trajectories=np.stack(trajectories),
             intrinsics=np.stack(intrinsics),
             images=selection,
             pairs=pairs)


def merge_scene_metadata(output_dir: str, scenes: List[str]) -> None:
    """Concatenate per-scene metadata into all_metadata.npz with
    globally-offset pair indices (preprocess_scannetpp.py:329-381)."""
    offset = 0
    counts, sceneids, images = [], [], []
    intrinsics, trajectories, pairs = [], [], []
    for scene_idx, scene in enumerate(scenes):
        with np.load(osp.join(output_dir, scene,
                              "scene_metadata.npz")) as data:
            n = data["images"].shape[0]
            sceneids.extend([scene_idx] * n)
            images.append(data["images"])
            intrinsics.append(data["intrinsics"])
            trajectories.append(data["trajectories"])
            img_pairs = data["pairs"].copy()
            img_pairs[:, 0:2] += offset
            pairs.append(img_pairs)
            counts.append(offset)
            offset += n
    np.savez(osp.join(output_dir, "all_metadata.npz"),
             counts=counts,
             scenes=scenes,
             sceneids=sceneids,
             images=np.concatenate(images, axis=0),
             intrinsics=np.concatenate(intrinsics, axis=0),
             trajectories=np.concatenate(trajectories, axis=0),
             pairs=np.concatenate(pairs, axis=0))


def run_scannetpp(args) -> None:
    """python -m gd3d_torch.cli.preprocess --dataset scannetpp --raw-dir <scannetpp> --pairs-dir
    <precomputed pairs> --output-dir <out>."""
    if args.pairs_dir is None:
        raise SystemExit("--pairs-dir is required for --dataset scannetpp")
    with open(osp.join(args.pairs_dir, "scene_list.json")) as f:
        scenes = json.load(f)
    os.makedirs(args.output_dir, exist_ok=True)
    for scene in scenes:
        print(f"processing {scene}", flush=True)
        process_scene(scene, args.raw_dir, args.pairs_dir,
                      args.output_dir, args.target_resolution)
    merge_scene_metadata(args.output_dir, scenes)
    print(f"preprocessed tree -> {args.output_dir}")
