"""Visual localization CLI of the port: query images -> poses in an aligned
scene (counterpart of gd3d/cli/localize.py; dust3r's visloc flow).

Usage:
  python -m gd3d_torch.cli.localize --scene <align out>/scene.npz \\
      --images <files or one directory> --output <dir> [--teacher-ckpt mast3r.pth] \\
      [--coarse-to-fine [--fine-size N]] [--device cuda]

Reads the dense scene.npz that gd3d_torch.cli.align (or gd3d's) writes and
writes query_poses.npz (poses, names, n_matches), as gd3d does. It runs on
the card unless --device says otherwise; asking for cuda without one raises.
The module imports torch inside its functions only.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m gd3d_torch.cli.localize",
                                description="Localize query images against an aligned scene")
    p.add_argument("--scene", required=True,
                   help="scene.npz from the align CLI (needs images/pts3d)")
    p.add_argument("--images", required=True, nargs="+",
                   help="query image files (or one directory)")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--teacher-ckpt", default=None, help="MASt3R torch state_dict (.pth)")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--top-k", type=int, default=None,
                   help="limit map views per query (default: all)")
    p.add_argument("--min-conf", type=float, default=1.5,
                   help="scene-confidence gate for matched map pixels")
    p.add_argument("--reproj-px", type=float, default=5.0,
                   help="PnP RANSAC reprojection error (visloc.py default)")
    p.add_argument("--coarse-to-fine", action="store_true",
                   help="second matching pass through crop windows of the "
                        "higher-resolution query (mast3r coarse_to_fine)")
    p.add_argument("--fine-size", type=int, default=None,
                   help="long side for the fine-pass query (default 2x --size)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    p.add_argument("--tiny", action="store_true", help="tiny random teacher (CPU smoke tests)")
    return p.parse_args(argv)


def main(argv=None, teacher=None) -> dict:
    """Parse, localize each query, write query_poses.npz. `teacher` takes
    the place of the one the flags would build. Returns the output dir, the
    poses and stats (seconds and matches per query)."""
    args = parse_args(argv)
    from gd3d_torch.cli.align import (_collect_images, build_teacher, check_readable,
                                      resolve_device, sync)
    from gd3d_torch.data.images import load_image_mast3r
    from gd3d_torch.visloc import localize_image

    device = resolve_device(args.device)
    z = np.load(args.scene)
    scene_images = z["images"]          # (n, H, W, 3) in [-1, 1]
    scene_pts3d = z["pts3d"]
    scene_conf = z["confidence"] if "confidence" in z.files else None
    if scene_pts3d.ndim != 4:
        raise SystemExit("--scene must be a dense scene.npz (align with --sparse 0)")
    if scene_conf is not None:  # stored flat (n, H*W) by the align CLI
        scene_conf = scene_conf.reshape(scene_pts3d.shape[:3])

    files = _collect_images(args.images)
    check_readable(files)
    if teacher is None:
        teacher = build_teacher(args, device)

    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    poses, names, n_matches, seconds = [], [], [], []
    fine_size = args.fine_size or 2 * args.size
    for f in files:
        t0 = sync(device)
        img = load_image_mast3r(str(f), size=args.size)["img"]
        assert img.shape == scene_images.shape[1:], (
            f"query {f} resizes to {img.shape}, scene is {scene_images.shape[1:]}: use a "
            "matching aspect and size")
        hires = (load_image_mast3r(str(f), size=fine_size)["img"]
                 if args.coarse_to_fine else None)
        res = localize_image(
            teacher, img, scene_images, scene_pts3d, scene_conf, top_k=args.top_k,
            min_conf=args.min_conf, reproj_px=args.reproj_px,
            coarse_to_fine=args.coarse_to_fine, query_hires=hires)
        seconds.append(sync(device) - t0)
        poses.append(res["pose"])
        names.append(str(f))
        n_matches.append(res["n_matches"])
        print(f"{f}: {res['n_matches']} matches, t={np.round(res['pose'][:3, 3], 3)}")
    np.savez(outdir / "query_poses.npz", poses=np.stack(poses), names=np.asarray(names),
             n_matches=np.asarray(n_matches))
    print(f"localized {len(files)} queries -> {outdir / 'query_poses.npz'}")
    return {"out_dir": outdir, "poses": np.stack(poses),
            "stats": {"seconds": seconds, "n_matches": n_matches}}


if __name__ == "__main__":
    main()
