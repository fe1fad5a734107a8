"""Offline dataset renderer CLI (counterpart of gd3d/cli/render.py).

    python -m gd3d_torch.cli.render --output DIR [--num-objects N |
        --objects names.txt] [--glb-root DIR] [--views 42] [--size 512]
        [--seed 0] [--poses data/obj_poses.npy] [--workers N]

Renders each object into <output>/<name>/{color,depth,mask}_%06d.png (the
reference's BlenderProc layout: RGB, depth in mm as uint16, mask 0 / 255)
with data/render_synthetic.py, and writes the poses to
<output>/obj_poses.npy. Objects are procedural meshes, or the .glb assets
of --glb-root (names from --objects, else every *.glb there). The tree is
the one gd3d's CLI writes from the same arguments: the same files, PNGs
that decode to the same pixels.

Everything runs on the host in numpy, as gd3d's does; the module imports
no torch, since its --workers processes (spawned) re-run its top level.
With --workers N the names are cut into contiguous chunks, each seeded by
its start index, so every object gets the same mesh whatever N is.
"""
from __future__ import annotations

import argparse
import multiprocessing
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Render procedural or .glb object trees (BlenderProc-stage substitute)")
    p.add_argument("--output", required=True, help="dataset root to write")
    p.add_argument("--num-objects", type=int, default=8,
                   help="number of procedural objects (ignored with --objects)")
    p.add_argument("--objects", default=None,
                   help="text file of object names, one per line (the reference's 10k.txt "
                        "analogue)")
    p.add_argument("--glb-root", default=None,
                   help="directory of <name>.glb assets (the reference's --cad_root); names "
                        "come from --objects or every *.glb under the root. Without it, "
                        "objects are procedural meshes")
    p.add_argument("--views", type=int, default=42,
                   help="views per object (reference: 42 fixed poses)")
    p.add_argument("--size", type=int, default=512, help="render resolution (reference: 512)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--poses", default=None, metavar="NPY",
                   help="camera extrinsics .npy to render with, e.g. data/obj_poses.npy, the "
                        "reference's 42 BlenderProc poses (default: procedural "
                        "Fibonacci-sphere poses)")
    p.add_argument("--workers", type=int, default=0,
                   help="process pool size; 0 = in-process")
    return p.parse_args(argv)


def _render_chunk(args_tuple):
    out_dir, names, views, size, seed, glb_root, poses = args_tuple
    from gd3d_torch.data.render_synthetic import render_object_tree

    return render_object_tree(out_dir, names, n_views=views, size=size, seed=seed,
                              glb_root=glb_root, poses=poses)


def object_names(args) -> list:
    if args.objects:
        return [line.strip() for line in Path(args.objects).read_text().splitlines()
                if line.strip()]
    if args.glb_root:
        return sorted(p.name for p in Path(args.glb_root).glob("*.glb"))
    return [f"obj_{i:05d}" for i in range(args.num_objects)]


def main(argv=None) -> np.ndarray:
    """Render the tree; returns the poses written to obj_poses.npy."""
    args = parse_args(argv)
    names = object_names(args)
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    pose_override = np.load(args.poses) if args.poses else None

    if args.workers > 0:
        # contiguous chunks with seed = global start index, so every object
        # gets the same procedural mesh regardless of the worker count
        step = (len(names) + args.workers - 1) // args.workers
        chunks = [(str(out), names[i:i + step], args.views, args.size, args.seed + i,
                   args.glb_root, pose_override) for i in range(0, len(names), step)]
        with multiprocessing.get_context("spawn").Pool(len(chunks)) as pool:
            all_poses = pool.map(_render_chunk, chunks)
        # every chunk renders the same pose array; assert that before
        # keeping only the first
        assert all_poses and all(np.array_equal(p, all_poses[0]) for p in all_poses[1:])
        poses = all_poses[0]
    else:
        poses = _render_chunk((str(out), names, args.views, args.size, args.seed,
                               args.glb_root, pose_override))

    np.save(out / "obj_poses.npy", poses)
    print(f"rendered {len(names)} objects x {args.views} views -> {out}")
    return poses


if __name__ == "__main__":
    main()
