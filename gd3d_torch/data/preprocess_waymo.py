"""Waymo Open raw ``.tfrecord`` downloads -> the dust3r-preprocessed tree
(counterpart of gd3d/data/preprocess_waymo.py, followed line for line:
the camera JPEGs are decoded by data/jpeg.py, rescaled by
data/resample.py and written by data/jpeg_encode.py at quality 80, where
gd3d uses PIL).

Parity target: ``dust3r/datasets_preprocess/preprocess_waymo.py:47-252``
(extract_frames -> make_crops -> pair check). The reference leans on
``tensorflow`` + the ``waymo_open_dataset`` package for three things this
image does not ship, so this module carries self-contained equivalents:

  1. **TFRecord framing** (`read_tfrecords`): length-prefixed records with
     masked crc32c checksums — a ~40-line pure-python reader.
  2. **The ``Frame`` proto** (`parse_frame`): a minimal protobuf
     wire-format decoder for exactly the field subset the reference
     consumes (context name + camera/laser calibrations, frame pose,
     camera images with pose/timestamp, lidar range images + camera
     projections; field numbers from waymo_open_dataset/dataset.proto
     v1.4.2). Both packed and unpacked repeated-scalar encodings are
     accepted, as the protobuf spec requires of parsers.
  3. **Range-image -> point-cloud conversion**
     (`frame_point_cloud`, numpy): the
     ``frame_utils.parse_range_image_and_camera_projection`` +
     ``convert_range_image_to_point_cloud`` chain — zlib-compressed
     MatrixFloat/MatrixInt32 decode, beam-inclination recovery,
     spherical->cartesian with per-pixel top-lidar pose correction.

Output tree (identical to the reference's, consumed by
data/stereo_views.py's ``WaymoViews``): per sequence dir, per frame
``{frame:05d}_{cam}.jpg`` (long side 512, q80) + float32 depth ``.exr``
(or ``.exr.npy`` where cv2 lacks the codec, see preprocess_mvs) +
``.npz`` (intrinsics, cam2world, distortion), plus ``waymo_pairs.npz``
copied into the root.

Deviation from the reference (documented, not behavioral): the tmp stage
stores each camera's ORIGINAL jpeg bytes instead of decode+re-encode
(preprocess_waymo.py:97-98 pays a second jpeg generation loss for
nothing); the crop stage decodes once.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import shutil
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from gd3d_torch.data.jpeg import decode_jpeg
from gd3d_torch.data.jpeg_encode import save_jpeg
from gd3d_torch.data.preprocess_mvs import write_depth_float
from gd3d_torch.data.stereo_views import rescale_view

# waymo_open_dataset/label.proto enums (dataset.proto v1.4.2)
CAMERA_FRONT = 1  # CameraName.Name: FRONT..SIDE_RIGHT = 1..5
LASER_TOP = 1     # LaserName.Name: TOP, FRONT, SIDE_LEFT, SIDE_RIGHT, REAR


# --------------------------------------------------------------- crc32c
def _crc32c_table() -> np.ndarray:
    poly = 0x82F63B78  # Castagnoli, reflected
    table = np.empty(256, np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table[i] = crc
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = int(table[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's rotated+offset crc mask (tensorflow crc32c.h)."""
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def read_tfrecords(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file.

    Framing: u64le length, u32le masked-crc(length), payload, u32le
    masked-crc(payload). The length crc is always checked (it guards the
    framing itself); the payload crc only under ``verify_crc`` — the
    pure-python crc is O(bytes) and Waymo sequences run to ~1 GB.
    """
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:12])
            if masked_crc32c(header[:8]) != len_crc:
                raise ValueError(f"{path}: corrupt record length crc")
            payload = f.read(length)
            if len(payload) < length:
                raise ValueError(f"{path}: truncated record payload")
            (data_crc,) = struct.unpack("<I", f.read(4))
            if verify_crc and masked_crc32c(payload) != data_crc:
                raise ValueError(f"{path}: corrupt record payload crc")
            yield payload


# ------------------------------------------------- protobuf wire format
def iter_proto_fields(buf: bytes):
    """Yield (field_number, wire_type, value) triples from one message.

    varint fields decode to int; fixed32/fixed64 and length-delimited
    fields yield their raw bytes (callers reinterpret).
    """
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:  # length-delimited
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:  # 32-bit
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        result |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return result, pos
        shift += 7


def proto_fields(buf: bytes) -> Dict[int, List[Tuple[int, object]]]:
    out: Dict[int, List[Tuple[int, object]]] = {}
    for field, wire, value in iter_proto_fields(buf):
        out.setdefault(field, []).append((wire, value))
    return out


def decode_packed_varints(buf: bytes) -> np.ndarray:
    """Vectorized packed-varint decode -> uint64 array (numpy; a python
    per-byte loop over the ~1M camera-projection ints per top-lidar frame
    would dominate the extraction wall clock)."""
    a = np.frombuffer(buf, np.uint8)
    if a.size == 0:
        return np.zeros(0, np.uint64)
    ends = np.flatnonzero((a & 0x80) == 0)
    starts = np.concatenate([[0], ends[:-1] + 1])
    idx = np.arange(a.size)
    group = np.searchsorted(ends, idx)
    shift = ((idx - starts[group]) * 7).astype(np.uint64)
    vals = np.zeros(ends.size, np.uint64)
    np.bitwise_or.at(vals, group, (a & 0x7F).astype(np.uint64) << shift)
    return vals


def _scalars(entries, n_expected: Optional[int], kind: str) -> np.ndarray:
    """Merge packed (wire 2) + unpacked encodings of a repeated scalar."""
    chunks = []
    for wire, value in entries:
        if kind == "double":
            # packed buffer (wire 2) or a single 8-byte fixed64 (wire 1)
            chunks.append(np.frombuffer(value, "<f8"))
        elif kind == "float":
            chunks.append(np.frombuffer(value, "<f4"))
        elif kind == "int32":
            if wire == 2:
                v = decode_packed_varints(value).astype(np.int64)
            else:
                v = np.asarray([value], np.int64)
            chunks.append(v.astype(np.int32))
        else:  # pragma: no cover
            raise ValueError(kind)
    out = np.concatenate(chunks) if chunks else np.zeros(0)
    if n_expected is not None and out.size != n_expected:
        raise ValueError(f"expected {n_expected} {kind}s, got {out.size}")
    return out


def _transform(buf: bytes) -> np.ndarray:
    """Transform proto (field 1: repeated double, 16 entries) -> (4, 4)."""
    fields = proto_fields(buf)
    return _scalars(fields.get(1, []), 16, "double").reshape(4, 4)


def _matrix(compressed: bytes, kind: str) -> np.ndarray:
    """zlib MatrixFloat/MatrixInt32 (data=1 packed, shape=2{dims=1})."""
    fields = proto_fields(zlib.decompress(compressed))
    data = _scalars(fields.get(1, []), None, kind)
    (_, shape_buf), = fields[2]
    dims = _scalars(proto_fields(shape_buf).get(1, []), None, "int32")
    return data.reshape(tuple(int(d) for d in dims))


def _double(entries) -> float:
    (_, value), = entries
    return struct.unpack("<d", value)[0]


# -------------------------------------------------- Frame proto subset
class WaymoFrame:
    """The Frame subset the preprocessor consumes (dataset.proto)."""

    def __init__(self, buf: bytes):
        fields = proto_fields(buf)
        (_, ctx), = fields[1]                       # Context context = 1
        ctx_fields = proto_fields(ctx)
        (_, name), = ctx_fields[1]                  # string name = 1
        self.context_name: str = name.decode()
        # CameraCalibration: name=1 width=4 height=5 intrinsic=2(double x9)
        # extrinsic=3(Transform)
        self.camera_calibrations: List[dict] = []
        for _, cal in ctx_fields.get(2, []):
            c = proto_fields(cal)
            self.camera_calibrations.append(dict(
                name=c[1][0][1],
                intrinsic=_scalars(c[2], 9, "double"),
                extrinsic=_transform(c[3][0][1]),
                width=c[4][0][1], height=c[5][0][1]))
        # LaserCalibration: name=1 beam_inclinations=2 min=3 max=4
        # extrinsic=5
        self.laser_calibrations: List[dict] = []
        for _, cal in ctx_fields.get(3, []):
            c = proto_fields(cal)
            self.laser_calibrations.append(dict(
                name=c[1][0][1],
                beam_inclinations=_scalars(c.get(2, []), None, "double"),
                beam_inclination_min=_double(c[3]) if 3 in c else 0.0,
                beam_inclination_max=_double(c[4]) if 4 in c else 0.0,
                extrinsic=_transform(c[5][0][1])))
        self.pose = _transform(fields[3][0][1])     # Transform pose = 3
        # CameraImage: name=1 image=2 pose=3 pose_timestamp=5
        self.images: List[dict] = []
        for _, img in fields.get(4, []):
            c = proto_fields(img)
            self.images.append(dict(
                name=c[1][0][1], image=c[2][0][1],
                pose=_transform(c[3][0][1]),
                pose_timestamp=_double(c[5]) if 5 in c else 0.0))
        # Laser: name=1 ri_return1=2; RangeImage: range_image_compressed=2
        # camera_projection_compressed=3 range_image_pose_compressed=4
        self.lasers: Dict[int, dict] = {}
        for _, laser in fields.get(5, []):
            c = proto_fields(laser)
            ri = proto_fields(c[2][0][1])
            self.lasers[c[1][0][1]] = dict(
                range_image=ri[2][0][1],
                camera_projection=ri[3][0][1],
                range_image_pose=ri[4][0][1] if 4 in ri else None)


# ------------------------------------- range image -> point cloud (numpy)
def compute_inclination(incl_min: float, incl_max: float,
                        height: int) -> np.ndarray:
    """range_image_utils.compute_inclination: beam centers, bottom-up."""
    return incl_min + (0.5 + np.arange(height)) / height * \
        (incl_max - incl_min)


def _rotation_zyx(roll, pitch, yaw) -> np.ndarray:
    """transform_utils.get_rotation_matrix: R_z(yaw)R_y(pitch)R_x(roll),
    elementwise over leading dims -> (..., 3, 3)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    one, zero = np.ones_like(cr), np.zeros_like(cr)
    r_x = np.stack([one, zero, zero,
                    zero, cr, -sr,
                    zero, sr, cr], -1).reshape(roll.shape + (3, 3))
    r_y = np.stack([cp, zero, sp,
                    zero, one, zero,
                    -sp, zero, cp], -1).reshape(roll.shape + (3, 3))
    r_z = np.stack([cy, -sy, zero,
                    sy, cy, zero,
                    zero, zero, one], -1).reshape(roll.shape + (3, 3))
    return r_z @ r_y @ r_x


def range_image_to_cartesian(
        range_img: np.ndarray, extrinsic: np.ndarray,
        inclination: np.ndarray, pixel_pose: Optional[np.ndarray] = None,
        frame_pose: Optional[np.ndarray] = None) -> np.ndarray:
    """range_image_utils.extract_point_cloud_from_range_image (numpy).

    range_img (H, W) meters; extrinsic sensor->vehicle (4, 4);
    inclination (H,) TOP-DOWN (row 0 = highest beam, i.e. already
    reversed as frame_utils does); pixel_pose (H, W, 4, 4) per-pixel
    vehicle->world for the top lidar; frame_pose world<-vehicle of the
    frame. Returns (H, W, 3) points in the frame's vehicle frame.
    """
    H, W = range_img.shape
    az_correction = float(np.arctan2(extrinsic[1, 0], extrinsic[0, 0]))
    ratios = (np.arange(W, 0, -1) - 0.5) / W
    azimuth = (ratios * 2 - 1) * np.pi - az_correction          # (W,)
    cos_incl = np.cos(inclination)[:, None]
    x = np.cos(azimuth)[None, :] * cos_incl * range_img
    y = np.sin(azimuth)[None, :] * cos_incl * range_img
    z = np.sin(inclination)[:, None] * np.ones((1, W)) * range_img
    pts = np.stack([x, y, z], -1)
    pts = pts @ extrinsic[:3, :3].T + extrinsic[:3, 3]
    if pixel_pose is not None:
        pts = np.einsum("hwij,hwj->hwi", pixel_pose[..., :3, :3], pts) \
            + pixel_pose[..., :3, 3]
        world2vehicle = np.linalg.inv(frame_pose)
        pts = pts @ world2vehicle[:3, :3].T + world2vehicle[:3, 3]
    return pts


def frame_point_cloud(frame: WaymoFrame) -> Tuple[np.ndarray, np.ndarray]:
    """frame_utils.convert_range_image_to_point_cloud (first return):
    concatenated (N, 3) vehicle-frame points + (N, 6) camera projections
    over all lasers, ordered by laser name as the reference is."""
    top_pose = None
    if LASER_TOP in frame.lasers and \
            frame.lasers[LASER_TOP]["range_image_pose"] is not None:
        rit = _matrix(frame.lasers[LASER_TOP]["range_image_pose"], "float")
        rotation = _rotation_zyx(rit[..., 0], rit[..., 1], rit[..., 2])
        top_pose = np.zeros(rit.shape[:2] + (4, 4))
        top_pose[..., :3, :3] = rotation
        top_pose[..., :3, 3] = rit[..., 3:6]
        top_pose[..., 3, 3] = 1.0
    points, cp_points = [], []
    for cal in sorted(frame.laser_calibrations, key=lambda c: c["name"]):
        laser = frame.lasers.get(cal["name"])
        if laser is None:
            continue
        ri = _matrix(laser["range_image"], "float")      # (H, W, 4)
        cp = _matrix(laser["camera_projection"], "int32")  # (H, W, 6)
        if cal["beam_inclinations"].size:
            inclination = np.asarray(cal["beam_inclinations"])
        else:
            inclination = compute_inclination(
                cal["beam_inclination_min"], cal["beam_inclination_max"],
                ri.shape[0])
        inclination = inclination[::-1]  # row 0 = top beam
        pixel_pose = top_pose if cal["name"] == LASER_TOP else None
        pts = range_image_to_cartesian(
            ri[..., 0], cal["extrinsic"], inclination,
            pixel_pose=pixel_pose,
            frame_pose=frame.pose if pixel_pose is not None else None)
        mask = ri[..., 0] > 0
        points.append(pts[mask])
        cp_points.append(cp[mask])
    if not points:
        return np.zeros((0, 3)), np.zeros((0, 6), np.int32)
    return np.concatenate(points), np.concatenate(cp_points)


# ------------------------------------------------------- pipeline stages
def extract_frames_one_seq(path: str, verify_crc: bool = False):
    """(preprocess_waymo.py:105-167) -> (calib list, frames list of
    (context_name, {cam_idx: view dict}))."""
    calib = None
    frames = []
    for record in read_tfrecords(path, verify_crc=verify_crc):
        frame = WaymoFrame(record)
        if calib is None:
            calib = [(int(c["name"]),
                      dict(width=int(c["width"]), height=int(c["height"]),
                           intrinsics=[float(v) for v in c["intrinsic"]],
                           extrinsics=[float(v) for v in
                                       c["extrinsic"].ravel()]))
                     for c in frame.camera_calibrations]
        points_all, cp_points_all = frame_point_cloud(frame)
        views = {}
        frames.append((frame.context_name, views))
        for img in frame.images:
            cam = int(img["name"])
            mask = cp_points_all[:, 0] == cam
            views[cam] = dict(
                jpeg=img["image"], pose=img["pose"],
                # first-projection (x, y) only, like the reference's
                # cp_points[..., 1:3]
                pixels=np.round(cp_points_all[mask, 1:3]).astype(np.int16),
                pts3d=points_all[mask].astype(np.float32),
                timestamp=img["pose_timestamp"])
    return calib, frames


def process_one_seq(db_root: str, tmp_dir: str, seq: str,
                    verify_crc: bool = False) -> None:
    """(preprocess_waymo.py:81-102): write per-(frame, cam) jpg + npz and
    calib.json into tmp_dir/seq; idempotent via calib.json."""
    out_dir = osp.join(tmp_dir, seq)
    os.makedirs(out_dir, exist_ok=True)
    calib_path = osp.join(out_dir, "calib.json")
    if osp.isfile(calib_path):
        return
    calib, frames = extract_frames_one_seq(
        osp.join(db_root, seq), verify_crc=verify_crc)
    for f, (_name, views) in enumerate(frames):
        for cam_idx, view in views.items():
            with open(osp.join(out_dir, f"{f:05d}_{cam_idx}.jpg"),
                      "wb") as fh:
                fh.write(view["jpeg"])  # original camera jpeg bytes
            np.savez(osp.join(out_dir, f"{f:05d}_{cam_idx}.npz"),
                     pose=view["pose"], pixels=view["pixels"],
                     pts3d=view["pts3d"], timestamp=view["timestamp"])
    with open(calib_path, "w") as fh:
        json.dump(calib, fh)


# X=LEFT_RIGHT y=ALTITUDE z=DEPTH (preprocess_waymo.py:192-196)
AXES_TRANSFORMATION = np.array([
    [0, -1, 0, 0],
    [0, 0, -1, 0],
    [1, 0, 0, 0],
    [0, 0, 0, 1]], np.float64)


def crop_one_seq(input_dir: str, output_dir: str, seq: str,
                 resolution: int = 512) -> None:
    """(preprocess_waymo.py:177-251): rescale to long-side `resolution`,
    scatter lidar z into a depth map, save camera params."""
    seq_dir = osp.join(input_dir, seq)
    out_dir = osp.join(output_dir, seq)
    os.makedirs(out_dir, exist_ok=True)
    with open(osp.join(seq_dir, "calib.json")) as fh:
        calib = json.load(fh)

    cam_K, cam_distortion, cam_to_car = {}, {}, {}
    for cam_idx, cam_info in calib:
        cam_idx = str(cam_idx)
        f1, f2, cx, cy, k1, k2, p1, p2, k3 = cam_info["intrinsics"]
        cam_K[cam_idx] = np.asarray(
            [(f1, 0, cx), (0, f2, cy), (0, 0, 1)], np.float64)
        cam_distortion[cam_idx] = np.asarray([k1, k2, p1, p2, k3])
        cam_to_car[cam_idx] = np.asarray(
            cam_info["extrinsics"]).reshape(4, 4)

    frames = sorted(f[:-3] for f in os.listdir(seq_dir)
                    if f.endswith(".jpg"))
    for frame in frames:
        cam_idx = frame[-2]  # '{frame:05d}_{cam}.' -> cam char
        assert cam_idx in "12345", f"bad {cam_idx=} in {frame=}"
        data = np.load(osp.join(seq_dir, frame + "npz"))
        car_to_world = data["pose"]

        # lidar points -> camera frame with z = depth
        pos2d = data["pixels"].round().astype(np.int64)
        trf = AXES_TRANSFORMATION @ np.linalg.inv(cam_to_car[cam_idx])
        pts3d = data["pts3d"] @ trf[:3, :3].T + trf[:3, 3]

        image = decode_jpeg(osp.join(seq_dir, frame + "jpg"))
        H, W = image.shape[:2]
        # long-side `resolution` (reference passes (512, 1) / (1, 512))
        output_resolution = (resolution, 1) if W > H else (1, resolution)
        image, _, intrinsics2 = rescale_view(
            image, None, cam_K[cam_idx], output_resolution)
        save_jpeg(osp.join(out_dir, frame + "jpg"), image, quality=80)

        H, W = image.shape[:2]
        depthmap = np.zeros((H, W), np.float32)
        scale = intrinsics2 @ np.linalg.inv(cam_K[cam_idx])
        pos2d = np.round(
            pos2d @ scale[:2, :2].T + scale[:2, 2]).astype(np.int64)
        x, y = pos2d.T
        # the reference CLIPS out-of-frame points onto the border rather
        # than dropping them (:242) — kept, it's what the shipped trees
        # contain
        depthmap[y.clip(0, H - 1), x.clip(0, W - 1)] = pts3d[:, 2]
        write_depth_float(osp.join(out_dir, frame + "exr"), depthmap)

        cam2world = car_to_world @ cam_to_car[cam_idx] @ \
            np.linalg.inv(AXES_TRANSFORMATION)
        np.savez(osp.join(out_dir, frame + "npz"),
                 intrinsics=intrinsics2, cam2world=cam2world,
                 distortion=cam_distortion[cam_idx])


def run_waymo(args) -> None:
    """python -m gd3d_torch.cli.preprocess --dataset waymo --raw-dir <dir of .tfrecord>
    --pairs-dir <waymo_pairs.npz> --output-dir <out>."""
    if args.pairs_dir is None:
        raise SystemExit(
            "--pairs-dir (the precomputed waymo_pairs.npz) is required")
    sequences = sorted(f for f in os.listdir(args.raw_dir)
                       if f.endswith(".tfrecord"))
    assert sequences, f"no .tfrecord files at {args.raw_dir}"
    tmp_dir = osp.join(args.output_dir, "tmp")
    for seq in sequences:
        print(f"extracting {seq}", flush=True)
        process_one_seq(args.raw_dir, tmp_dir, seq)
    for seq in sequences:
        print(f"cropping {seq}", flush=True)
        crop_one_seq(tmp_dir, args.output_dir, seq)

    # pair check (:52-60) + ship the pairs file where WaymoViews reads it
    with np.load(args.pairs_dir) as data:
        scenes, frames, pairs = \
            data["scenes"], data["frames"], data["pairs"]
    for scene_id, im1_id, im2_id in pairs:
        for im_id in (im1_id, im2_id):
            path = osp.join(args.output_dir, str(scenes[int(scene_id)]),
                            str(frames[int(im_id)]) + ".jpg")
            assert osp.isfile(path), (
                f"Missing a file at {path=}\n"
                "Did you download all .tfrecord files?")
    shutil.copyfile(args.pairs_dir,
                    osp.join(args.output_dir, "waymo_pairs.npz"))
    shutil.rmtree(tmp_dir)
    print(f"preprocessed tree -> {args.output_dir}")
