"""Habitat multiview pretraining-data generation (python -m
gd3d_torch.cli.preprocess --dataset habitat; counterpart of
gd3d/data/preprocess_habitat.py, which it follows line for line with the
port's renderer, data/render_synthetic.py, and JPEG encoder,
data/jpeg_encode.py, in place of gd3d's native library and PIL).

Parity target: dust3r/croco/datasets/habitat_sim/ — the reference drives
habitat-sim to render 5 co-visible views per sampled viewpoint of each
scene, writing per view `<key>_<i>.jpeg`, `<key>_<i>_depth.exr` and
`<key>_<i>_camera_params.json` {camera_intrinsics, R_cam2world,
t_cam2world} (generate_multiview_images.py:86-96), plus a
`Habitat_<size>_scenes_<split>.txt` scene list that
data/stereo_views.py's `HabitatViews` consumes.

habitat-sim (a C++ simulator with GB-scale scene datasets) is not
installable in this image, so gd3d ships two modes:

* default — a **synthetic-equivalent generator**: procedurally-built
  scenes (several bumpy shaded objects over a ground plane) rendered by
  gd3d's own offline rasterizer (here the port's) into the EXACT reference tree layout.
  The output is fully loadable by HabitatViews and exercises every
  downstream code path (crop/resize, pose graph, pairing); only the
  image CONTENT differs from real Habitat renders. Depth is written as
  the `.exr.npy` float32 sibling this image's cv2 (no EXR codec) reads.
* ``--habitat-sim`` — real generation. Requires the upstream stack; in
  its absence the command fails with the documented recipe instead of
  silently falling back.
"""
from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np

HABITAT_RECIPE = """\
real Habitat generation needs habitat-sim, which is not installed.
Recipe (upstream croco/datasets/habitat_sim/README.MD):
  1. conda install habitat-sim headless -c conda-forge -c aihabitat
  2. download the scene datasets (HM3D / ScanNet / Replica / ...) with
     habitat_sim.utils.datasets_download
  3. re-run: gd3d-preprocess --dataset habitat --habitat-sim \\
       --raw-dir <scene_datasets_root> --output-dir <out>
Until then, omit --habitat-sim to generate the synthetic-equivalent
tree (same layout, procedural content)."""


def _look_at(cam_pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World->cam extrinsic looking from cam_pos to target (OpenCV axes:
    +x right, +y down, +z forward — the convention HabitatViews' poses
    invert, multiview_habitat_sim_generator.py:23-25)."""
    fwd = target - cam_pos
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    if abs(float(np.dot(up, fwd))) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    E = np.eye(4, dtype=np.float64)
    E[:3, :3] = R
    E[:3, 3] = -R @ cam_pos
    return E


def _scene_mesh(rng: np.random.RandomState):
    """A small procedural 'room': 3-5 shaded objects scattered on a ground
    plane (one merged mesh)."""
    from gd3d_torch.data.glb import vertex_normals
    from gd3d_torch.data.render_synthetic import procedural_object

    all_v, all_f, all_c = [], [], []
    n_obj = 3 + rng.randint(3)
    for _ in range(n_obj):
        v, f, c = procedural_object(rng)
        v = v * (1.0 + rng.rand()) + np.array(
            [rng.uniform(-1.2, 1.2), rng.uniform(-1.2, 1.2),
             rng.uniform(0.0, 0.6)])
        all_f.append(f + sum(len(x) for x in all_v))
        all_v.append(v)
        all_c.append(c)
    # ground plane: an 8x8 tessellated grid, not one big quad — the
    # rasterizer near-clips whole triangles when any vertex falls behind
    # the camera, so giant triangles would vanish from oblique views
    g0 = sum(len(x) for x in all_v)
    s, n_grid = 4.0, 8
    xs = np.linspace(-s, s, n_grid + 1)
    gx, gy = np.meshgrid(xs, xs)
    gverts = np.stack([gx.ravel(), gy.ravel(),
                       np.full(gx.size, -0.6)], -1)
    gfaces = []
    for r in range(n_grid):
        for c in range(n_grid):
            a = g0 + r * (n_grid + 1) + c
            b, d_, e = a + 1, a + n_grid + 1, a + n_grid + 2
            gfaces += [[a, b, e], [a, e, d_]]
    all_v.append(gverts)
    all_f.append(np.array(gfaces))
    all_c.append(np.full((len(gverts), 3), 0.55))
    verts = np.concatenate(all_v).astype(np.float64)
    faces = np.concatenate(all_f).astype(np.int64)
    colors = np.concatenate(all_c).astype(np.float32)
    return verts, faces, colors, vertex_normals(verts, faces)


def generate_scene(out_dir: str, key: str, rng: np.random.RandomState,
                   size: int = 256, hfov_deg: float = 60.0) -> None:
    """Render 5 co-visible views of one procedural scene into the
    reference layout: view 1 is the central reference view, 2-5 are
    nearby perturbed viewpoints (the generator's connected-to-view-0
    structure HabitatViews pairs on, habitat.py:60-70)."""
    from gd3d_torch.data.jpeg_encode import save_jpeg
    from gd3d_torch.data.render_synthetic import render_mesh

    verts, faces, colors, normals = _scene_mesh(rng)
    f = size / 2.0 / np.tan(np.deg2rad(hfov_deg) / 2.0)
    K = np.array([[f, 0, size / 2.0], [0, f, size / 2.0], [0, 0, 1.0]])

    target = np.array([0.0, 0.0, 0.0])
    base_dir = rng.randn(3)
    base_dir[2] = abs(base_dir[2]) * 0.4 + 0.3
    base_dir /= np.linalg.norm(base_dir)
    radius = 3.0 + rng.rand()
    os.makedirs(out_dir, exist_ok=True)
    for i in range(1, 6):
        d = base_dir if i == 1 else base_dir + rng.randn(3) * 0.18
        d = d / np.linalg.norm(d)
        cam_pos = d * radius
        E = _look_at(cam_pos, target + (0 if i == 1
                                        else rng.randn(3) * 0.15))
        rgb, depth, _mask = render_mesh(
            verts, faces, colors, E, K, size, normals=normals)
        save_jpeg(osp.join(out_dir, f"{key}_{i}.jpeg"), rgb, quality=95)
        # .exr.npy: the float32 sibling read_depth_float falls back to on
        # cv2 builds without the EXR codec (stereo_views.py:601-619)
        np.save(osp.join(out_dir, f"{key}_{i}_depth.exr.npy"),
                depth.astype(np.float32))
        R_c2w = E[:3, :3].T
        t_c2w = -R_c2w @ E[:3, 3]
        with open(osp.join(out_dir, f"{key}_{i}_camera_params.json"),
                  "w") as fp:
            json.dump({"camera_intrinsics": K.tolist(),
                       "R_cam2world": R_c2w.tolist(),
                       "t_cam2world": t_c2w.tolist()}, fp)


def run_habitat(args) -> None:
    """gd3d-preprocess --dataset habitat: write a HabitatViews-loadable
    tree. --num-sequences-per-object doubles as scenes-per-split."""
    if getattr(args, "habitat_sim", False):
        try:
            import habitat_sim  # noqa: F401
        except ImportError:
            raise SystemExit(HABITAT_RECIPE)
        raise SystemExit(
            "habitat-sim detected, but this build drives only the "
            "synthetic-equivalent generator; use the upstream recipe for "
            "real scene renders:\n" + HABITAT_RECIPE)
    size = args.img_size
    n_scenes = args.num_sequences_per_object
    for split, n in (("train", n_scenes),
                     ("val", max(1, n_scenes // 10))):
        entries = []
        for si in range(n):
            rng = np.random.RandomState(args.seed + si * 7919
                                        + (0 if split == "train" else 1))
            scene = f"synthetic/{split}_{si:05d}"
            key = "00000"
            generate_scene(osp.join(args.output_dir, scene), key, rng,
                           size=size)
            entries.append(f"{scene}/{key}")
        with open(osp.join(args.output_dir,
                           f"Habitat_{size}_scenes_{split}.txt"),
                  "w") as fp:
            fp.write("\n".join(entries) + "\n")
        print(f"habitat[{split}]: {n} scenes x 5 views -> "
              f"{args.output_dir}")
