"""Raw ARKitScenes download -> the dust3r-preprocessed pretraining tree
(counterpart of gd3d/data/preprocess_arkitscenes.py, followed line for
line: PIL's transposes are np.rot90, its PNG reads and JPEG writes
data/png.py and data/jpeg_encode.py (quality 75), and cv2's
INTER_NEAREST_EXACT depth resize data/resample.py's
resize_nearest_exact_cv).

Parity target: dust3r/datasets_preprocess/preprocess_arkitscenes.py:93-349.
Per scene: parse lowres_wide.traj (world->device angle-axis + translation
per timestamp, :60-90), SQUAD-interpolate device poses at the selected
frame timestamps (:269-305), detect the scene's sky direction from the
mean device up/right vectors and rotate every image/depth upright
(:308-349 + :170-188), look up per-frame .pincam intrinsics with the
reference's +/-1 ms filename fallback (:286-291, swapping fx/fy for
LEFT/RIGHT scenes :299-302), re-encode RGB as jpg and nearest-resize the
lowres depth to the RGB size (:190-196), then write per-scene
scene_metadata.npz and the per-split all_metadata.npz that
data/stereo_views.py's `ARKitScenesViews` consumes (:198-266).

The reference interpolates rotations with numpy-quaternion's squad; that
package is not in this image, so the cubic SQUAD spline is implemented
here in plain numpy (same Shoemake construction: inner quadrangle points
s_i = q_i exp(-(log(q_i^-1 q_{i+1}) + log(q_i^-1 q_{i-1}))/4), bilinear
slerp blend) — identical up to fp rounding. cv2.Rodrigues is replaced by
scipy's Rotation.from_rotvec (same axis-angle convention).
"""
from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, List, Tuple

import numpy as np

from gd3d_torch.data.jpeg_encode import save_jpeg
from gd3d_torch.data.png import decode_png, encode_png, pil_rgb
from gd3d_torch.data.resample import resize_nearest_exact_cv

# ------------------------------------------------------------ quaternions
# minimal (w, x, y, z) unit-quaternion toolkit for the SQUAD spline


def _qmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _qconj(q: np.ndarray) -> np.ndarray:
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _qlog(q: np.ndarray) -> np.ndarray:
    """Unit quaternion -> tangent vector (pure-imaginary part of log)."""
    v = q[1:]
    nv = np.linalg.norm(v)
    if nv < 1e-12:
        return np.zeros(3)
    theta = np.arctan2(nv, np.clip(q[0], -1.0, 1.0))
    return v / nv * theta


def _qexp(v: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(v)
    if theta < 1e-12:
        return np.array([1.0, 0.0, 0.0, 0.0])
    return np.concatenate([[np.cos(theta)], np.sin(theta) * v / theta])


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float,
           shortest: bool = True) -> np.ndarray:
    """Spherical lerp. Inside the SQUAD spline `shortest` must be False:
    flipping mid-curve as dot(a, b) crosses zero would make the composed
    path discontinuous (numpy-quaternion's slerp does not flip either —
    hemisphere consistency comes from unflip_rotors instead)."""
    d = float(np.clip(np.dot(q0, q1), -1.0, 1.0))
    if shortest and d < 0:
        q1, d = -q1, -d
    if abs(d) > 1 - 1e-10:  # (anti)parallel: lerp-normalize
        out = (1 - t) * q0 + t * q1
        n = np.linalg.norm(out)
        return out / n if n > 1e-12 else q0
    theta = np.arccos(d)
    return (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) \
        / np.sin(theta)


def unflip_rotors(quats: np.ndarray) -> np.ndarray:
    """Make consecutive quaternions live on the same hemisphere
    (quaternion.unflip_rotors — sign flips break interpolation)."""
    out = quats.copy()
    for i in range(1, len(out)):
        if np.dot(out[i], out[i - 1]) < 0:
            out[i] = -out[i]
    return out


def squad(quats: np.ndarray, times: np.ndarray,
          t_eval: np.ndarray) -> np.ndarray:
    """Shoemake SQUAD spline through (times, quats), evaluated at t_eval
    (the numpy-quaternion `squad` the reference calls at :279). Returns
    (len(t_eval), 4) unit quaternions, wxyz."""
    n = len(quats)
    assert n == len(times) >= 1
    if n == 1:
        return np.repeat(quats, len(t_eval), axis=0)
    # inner quadrangle points; endpoints use the knot itself
    s = quats.copy()
    for i in range(1, n - 1):
        qinv = _qconj(quats[i])
        arg = -(_qlog(_qmul(qinv, quats[i + 1]))
                + _qlog(_qmul(qinv, quats[i - 1]))) / 4.0
        s[i] = _qmul(quats[i], _qexp(arg))
    out = np.empty((len(t_eval), 4))
    for k, t in enumerate(np.clip(t_eval, times[0], times[-1])):
        i = int(np.searchsorted(times, t, side="right") - 1)
        i = min(max(i, 0), n - 2)
        dt = times[i + 1] - times[i]
        u = 0.0 if dt <= 0 else float((t - times[i]) / dt)
        a = _slerp(quats[i], quats[i + 1], u, shortest=False)
        b = _slerp(s[i], s[i + 1], u, shortest=False)
        out[k] = _slerp(a, b, 2 * u * (1 - u), shortest=False)
    return out


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    return Rotation.from_quat(q[[1, 2, 3, 0]]).as_matrix()  # wxyz -> xyzw


def matrix_to_quat(R: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(R).as_quat()  # xyzw
    return q[[3, 0, 1, 2]]


# ------------------------------------------------------------ trajectory
def read_traj(traj_path: str):
    """lowres_wide.traj lines: ts rx ry rz tx ty tz (world->device
    angle-axis + translation, preprocess_arkitscenes.py:60-90). Returns
    (timestamps (ms-rounded), positions, quaternions wxyz, poses_p2w)."""
    from scipy.spatial.transform import Rotation

    timestamps, positions, quats, poses_p_to_w = [], [], [], []
    with open(traj_path) as f:
        for line in f:
            tok = line.split()
            assert len(tok) == 7, traj_path
            # the reference rounds through decimal at 3 places (:32-34,
            # :72); round-half-up matches for positive timestamps
            ts = float(tok[0])
            timestamps.append(np.floor(ts * 1000 + 0.5) / 1000)
            pose_w2p = np.eye(4)
            pose_w2p[:3, :3] = Rotation.from_rotvec(
                [float(t) for t in tok[1:4]]).as_matrix()
            pose_w2p[:3, 3] = [float(t) for t in tok[4:7]]
            pose_p2w = np.linalg.inv(pose_w2p)
            poses_p_to_w.append(pose_p2w)
            positions.append(pose_p2w[:3, 3])
            quats.append(matrix_to_quat(pose_p2w[:3, :3]))
    return (np.asarray(timestamps), np.asarray(positions),
            np.asarray(quats), poses_p_to_w)


# -------------------------------------------------------- sky direction
def find_scene_orientation(poses_cam_to_world: List[np.ndarray]):
    """Mean device up/right vs world up -> sky direction + the rotation
    that uprights the camera frame (preprocess_arkitscenes.py:308-349)."""
    from scipy.spatial.transform import Rotation

    if poses_cam_to_world:
        up = np.mean([p @ np.array([0.0, -1.0, 0.0, 0.0])
                      for p in poses_cam_to_world], axis=0)
        right = np.mean([p @ np.array([1.0, 0.0, 0.0, 0.0])
                         for p in poses_cam_to_world], axis=0)
    else:
        up = np.array([0.0, -1.0, 0.0, 0.0])
        right = np.array([1.0, 0.0, 0.0, 0.0])
    up_world = np.array([0.0, 0.0, 1.0, 0.0])

    def angle(v):
        return float(np.degrees(np.arccos(
            np.clip(np.dot(up_world, v), -1.0, 1.0))))

    up_angle, right_angle = angle(up), angle(right)
    if abs(up_angle - 90.0) < abs(right_angle - 90.0):
        assert abs(up_angle - 90.0) < 45.0
        if right_angle > 90.0:
            sky, rotvec = "LEFT", [0.0, 0.0, np.pi / 2]
        else:
            sky, rotvec = "RIGHT", [0.0, 0.0, -np.pi / 2]
    else:
        assert abs(right_angle - 90.0) < 45.0
        if up_angle > 90.0:
            sky, rotvec = "DOWN", [0.0, 0.0, np.pi]
        else:
            sky, rotvec = "UP", [0.0, 0.0, 0.0]
    cam_to_rotated = np.eye(4)
    cam_to_rotated[:3, :3] = Rotation.from_rotvec(rotvec).as_matrix()
    return sky, np.linalg.inv(cam_to_rotated)


# ---------------------------------------------------------- scene convert
def convert_scene_metadata(scene: str, intrinsics_dir: str,
                           timestamps: np.ndarray, quats: np.ndarray,
                           positions: np.ndarray,
                           poses_cam_to_world: List[np.ndarray],
                           selected_images: List[Tuple[str, str]]):
    """Selected frames -> (sky, poses, [w h fx fy hw hh] intrinsics,
    basenames) — preprocess_arkitscenes.py:269-305."""
    sky, rotated_to_cam = find_scene_orientation(poses_cam_to_world)

    t_sel = np.array([float(fid) for _, fid in selected_images])
    # positions: per-axis linear interpolation (:278-280); clamp inside
    # the knot range like scipy's default bounds check would reject
    t_cl = np.clip(t_sel, timestamps[0], timestamps[-1])
    interp_pos = np.stack([np.interp(t_cl, timestamps, positions[:, a])
                           for a in range(3)], axis=-1)
    interp_rot = squad(quats, timestamps, t_sel)

    trajectories, intrinsics, images = [], [], []
    for i, (basename, frame_id) in enumerate(selected_images):
        fn = osp.join(intrinsics_dir, f"{scene}_{frame_id}.pincam")
        if not osp.exists(fn):  # +/-1 ms fallback (:287-290)
            fn = osp.join(intrinsics_dir,
                          f"{scene}_{float(frame_id) - 0.001:.3f}.pincam")
        if not osp.exists(fn):
            fn = osp.join(intrinsics_dir,
                          f"{scene}_{float(frame_id) + 0.001:.3f}.pincam")
        assert osp.exists(fn), fn
        w, h, fx, fy, hw, hh = np.loadtxt(fn)

        pose = np.eye(4)
        pose[:3, :3] = quat_to_matrix(interp_rot[i])
        pose[:3, 3] = interp_pos[i]

        images.append(basename)
        if sky in ("RIGHT", "LEFT"):  # swapped intrinsics (:299-300)
            intrinsics.append([h, w, fy, fx, hh, hw])
        else:
            intrinsics.append([w, h, fx, fy, hw, hh])
        trajectories.append(pose @ rotated_to_cam)
    return sky, trajectories, intrinsics, images


# --------------------------------------------------------------- images
# PIL's ROTATE_90 / ROTATE_270 / ROTATE_180 (counter-clockwise) as
# np.rot90 turns; cv2.ROTATE_90_COUNTERCLOCKWISE == 1 turn
_NP_ROT_K = {"RIGHT": 1, "LEFT": 3, "DOWN": 2}


def _resize_depth_nearest_exact(depth: np.ndarray, wh) -> np.ndarray:
    """cv2.INTER_NEAREST_EXACT (:194), which gd3d uses wherever cv2
    imports."""
    return resize_nearest_exact_cv(depth, (int(wh[0]), int(wh[1])))


def _read_rgb_png(path: str) -> np.ndarray:
    """Image.open(path) of an RGB PNG (the mode a JPEG can be saved from)."""
    png = decode_png(path)
    if png.color_type != 2:
        raise ValueError(f"{path}: expected an RGB PNG, got colour type {png.color_type}")
    return pil_rgb(png)


def convert_images(scene_dir: str, out_scene: str, images: List[str],
                   sky: str) -> None:
    """Rotate upright, jpg-encode RGB, nearest-resize depth to the RGB
    size (preprocess_arkitscenes.py:155-196)."""
    os.makedirs(osp.join(out_scene, "vga_wide"), exist_ok=True)
    os.makedirs(osp.join(out_scene, "lowres_depth"), exist_ok=True)
    for basename in images:
        img_out = osp.join(out_scene, "vga_wide",
                           basename.replace(".png", ".jpg"))
        depth_out = osp.join(out_scene, "lowres_depth", basename)
        if osp.isfile(img_out) and osp.isfile(depth_out):
            continue
        img = _read_rgb_png(osp.join(scene_dir, "vga_wide", basename))
        depth = decode_png(osp.join(scene_dir, "lowres_depth", basename)).samples[..., 0]
        if sky in _NP_ROT_K:
            img = np.rot90(img, k=_NP_ROT_K[sky])
            depth = np.rot90(depth, k=_NP_ROT_K[sky])
        H, W = img.shape[:2]
        if not osp.isfile(img_out):
            save_jpeg(img_out, np.ascontiguousarray(img))
        depth = _resize_depth_nearest_exact(np.ascontiguousarray(depth),
                                            (W, H))
        if not osp.isfile(depth_out):
            with open(depth_out, "wb") as f:
                f.write(encode_png(depth))


# ------------------------------------------------------ pipeline
def process_scene(scene: str, rootdir: str, pairsdir: str, outsubdir: str,
                  subdir: str) -> bool:
    """One scene -> converted images + scene_metadata.npz; returns False
    for scenes whose precomputed selection is empty (:118-126)."""
    scene_dir = osp.join(rootdir, subdir, scene)
    sel = np.load(osp.join(pairsdir, subdir, scene, "selected_pairs.npz"))
    selection, pairs = sel["selection"], sel["pairs"]
    sel_sky = str(sel["sky_direction_scene"][0])
    if len(selection) == 0 or len(pairs) == 0:
        return False

    out_scene = osp.join(outsubdir, scene)
    os.makedirs(out_scene, exist_ok=True)
    meta_path = osp.join(out_scene, "scene_metadata.npz")
    if osp.isfile(meta_path):
        return True

    timestamps, positions, quats, poses_p2w = read_traj(
        osp.join(scene_dir, "lowres_wide.traj"))
    quats = unflip_rotors(quats)
    selected_images = [
        (str(b), str(b).split(".png")[0].split("_")[1]) for b in selection]

    sky, trajectories, intrinsics, images = convert_scene_metadata(
        scene, osp.join(scene_dir, "vga_wide_intrinsics"),
        timestamps, quats, positions, poses_p2w, selected_images)
    assert sel_sky == sky, (scene, sel_sky, sky)  # :153

    convert_images(scene_dir, out_scene, images, sky)
    np.savez(meta_path, trajectories=trajectories, intrinsics=intrinsics,
             images=images, pairs=pairs)
    return True


def merge_split_metadata(outsubdir: str, scenes: List[str]) -> None:
    """Per-scene metadata -> all_metadata.npz with globally-offset pairs
    and intrinsics assembled into 3x3 K (:209-266)."""
    offset = 0
    counts, sceneids, images = [], [], []
    Ks, trajectories, pairs = [], [], []
    for scene_idx, scene in enumerate(scenes):
        with np.load(osp.join(outsubdir, scene,
                              "scene_metadata.npz")) as data:
            n = data["images"].shape[0]
            sceneids.extend([scene_idx] * n)
            images.append(data["images"])
            K = np.tile(np.eye(3), (n, 1, 1))
            intr = data["intrinsics"]  # rows of [w h fx fy hw hh]
            K[:, 0, 0], K[:, 1, 1] = intr[:, 2], intr[:, 3]
            K[:, 0, 2], K[:, 1, 2] = intr[:, 4], intr[:, 5]
            Ks.append(K)
            trajectories.append(data["trajectories"])
            img_pairs = data["pairs"].copy()
            img_pairs[:, 0:2] += offset
            pairs.append(img_pairs)
            counts.append(offset)
            offset += n
    np.savez(osp.join(outsubdir, "all_metadata.npz"),
             counts=counts, scenes=scenes, sceneids=sceneids,
             images=np.concatenate(images, axis=0),
             intrinsics=np.concatenate(Ks, axis=0),
             trajectories=np.concatenate(trajectories, axis=0),
             pairs=np.concatenate(pairs, axis=0))


def run_arkitscenes(args) -> None:
    """python -m gd3d_torch.cli.preprocess --dataset arkitscenes --raw-dir <arkitscenes>
    --pairs-dir <precomputed pairs> --output-dir <out>."""
    if args.pairs_dir is None:
        raise SystemExit("--pairs-dir is required for --dataset "
                         "arkitscenes")
    for subdir in ("Test", "Training"):  # :96-97
        if not osp.isdir(osp.join(args.raw_dir, subdir)):
            continue
        outsubdir = osp.join(args.output_dir, subdir)
        os.makedirs(outsubdir, exist_ok=True)
        with open(osp.join(args.pairs_dir, subdir,
                           "scene_list.json")) as f:
            scene_dirs = json.load(f)
        valid_scenes = []
        for scene in scene_dirs:
            print(f"processing {subdir}/{scene}", flush=True)
            if process_scene(scene, args.raw_dir, args.pairs_dir,
                             outsubdir, subdir):
                valid_scenes.append(scene)
        with open(osp.join(outsubdir, "scene_list.json"), "w") as f:
            json.dump(valid_scenes, f)
        merge_split_metadata(outsubdir, valid_scenes)
    print(f"preprocessed tree -> {args.output_dir}")
