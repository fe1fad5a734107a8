"""Multi-view reconstruction CLI of the port: MASt3R pairs -> global
alignment (counterpart of gd3d/cli/align.py).

Usage:
  python -m gd3d_torch.cli.align --images <files or one directory> \\
      --output <dir> [--teacher-ckpt mast3r.pth] [--size 512] [--niter 300] \\
      [--pairs complete|swin-W|logwin-W|oneref-R|sliding] [--pair-filter seqN|cycN] \\
      [--sparse K] [--tsdf THRESH] [--colmap] [--colmap-db] [--ply] [--html] \\
      [--sparse-ga [--ga-niter1 500] [--ga-niter2 500] [--ga-subsample 8]] \\
      [--device cuda]

gd3d's flags and outputs: scene.npz (poses, focals, principal_points,
depthmaps, pts3d, confidence, images, losses) and, on request, a COLMAP text
model (colmap/), a COLMAP database (database.db), a colored pointcloud.ply
and a browser viewer (scene.html). It runs on the card unless --device says
otherwise; asking for cuda without one raises. The teacher runs all ordered
pairs of the scene graph in one batched call, the alignment is Adam on the
device (gd3d_torch/align.py). Images are read by gd3d_torch/data/images.py,
which decodes JPEG and PNG; another format (gd3d also takes .bmp and
.webp through PIL) raises an error that names the file. --sparse-ga runs
MASt3R's two-stage sparse global alignment instead (gd3d_torch/sparse_ga.py:
the teacher over the unordered pairs, pair_chunk at a time, then the coarse
and fine stages on the device) and writes gd3d's sparse-GA scene.npz (poses,
focals, principal_points, depthmaps, pts3d densified from the anchors,
images) with the .ply and .html on request; --tsdf and --colmap* warn and are
ignored there, as in gd3d. The module imports torch inside its functions
only.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

# what gd3d collects from a directory; data/images.py::open_rgb reads the first three
COLLECTED = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
READABLE = (".png", ".jpg", ".jpeg")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m gd3d_torch.cli.align",
        description="Globally align MASt3R pairwise predictions into a posed multi-view scene")
    p.add_argument("--images", required=True, nargs="+",
                   help="image files (or one directory), JPEG or PNG; all must share one "
                        "post-resize shape")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--teacher-ckpt", default=None,
                   help="MASt3R torch state_dict (.pth); random weights with a warning "
                        "otherwise")
    p.add_argument("--size", type=int, default=512, help="MASt3R long-side resize (512 or 224)")
    p.add_argument("--niter", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--schedule", choices=("cosine", "linear"), default="cosine")
    p.add_argument("--pairs", default="complete",
                   help="scene graph (dust3r make_pairs strategies): complete | "
                        "swin-W[-noncyclic] | logwin-W[-noncyclic] | oneref-R; 'sliding' is "
                        "an alias for swin-2-noncyclic")
    p.add_argument("--pair-filter", default=None, metavar="seqN|cycN",
                   help="drop edges more than N frames apart (cyclic distance with cycN)")
    p.add_argument("--sparse", type=int, default=-1, metavar="K",
                   help="optimize only the top-K most confident anchor pixels per image "
                        "(MASt3R sparse-GA analogue; ~HW/K x cheaper, sparse depth outputs). "
                        "Default -1 = auto: sparse 1024 when the scene exceeds 200k dense "
                        "points; 0 forces dense")
    p.add_argument("--sparse-ga", action="store_true",
                   help="MASt3R's two-stage sparse global alignment (canonical pointmaps, "
                        "kinematic-chain cameras, a coarse 3D-matching stage then a fine "
                        "2D-reprojection stage) instead of the PointCloudOptimizer loop; "
                        "depth maps and points are densified from the optimized anchors. "
                        "--niter/--lr/--sparse/--tsdf/--colmap* apply to the default path only")
    p.add_argument("--ga-niter1", type=int, default=500, help="--sparse-ga coarse iterations")
    p.add_argument("--ga-niter2", type=int, default=500, help="--sparse-ga fine iterations")
    p.add_argument("--ga-subsample", type=int, default=8, help="--sparse-ga anchor stride")
    p.add_argument("--tsdf", type=float, default=0.0, metavar="THRESH",
                   help="TSDF depth refinement after alignment (MASt3R TSDFPostProcess "
                        "analogue; dense scenes only; THRESH ~ the expected depth noise)")
    p.add_argument("--tsdf-samples", type=int, default=128,
                   help="candidate depths per pixel for --tsdf")
    p.add_argument("--colmap", action="store_true",
                   help="also export a COLMAP text model (cameras/images/points3D.txt; "
                        "dense scenes only)")
    p.add_argument("--colmap-db", action="store_true",
                   help="also write a COLMAP matching database (database.db: reciprocal-NN "
                        "correspondences as keypoints/matches + pose/intrinsic priors)")
    p.add_argument("--db-subsample", type=int, default=8,
                   help="correspondence grid stride for --colmap-db")
    p.add_argument("--min-len-track", type=int, default=2,
                   help="drop --colmap-db tracks with fewer observations")
    p.add_argument("--ply", action="store_true",
                   help="also write a confidence-filtered colored pointcloud.ply")
    p.add_argument("--html", action="store_true",
                   help="also write scene.html, a self-contained browser viewer (points + "
                        "camera frusta, no server)")
    p.add_argument("--min-conf", type=float, default=1.5,
                   help="confidence threshold for the .ply export")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    p.add_argument("--tiny", action="store_true", help="tiny random teacher (CPU smoke tests)")
    return p.parse_args(argv)


def _collect_images(paths):
    if len(paths) == 1 and Path(paths[0]).is_dir():
        return sorted(p for p in Path(paths[0]).iterdir() if p.suffix.lower() in COLLECTED)
    return [Path(p) for p in paths]


def check_readable(files) -> None:
    """Raise on a file the port cannot decode, naming it."""
    for f in files:
        if Path(f).suffix.lower() not in READABLE:
            raise ValueError(f"{f}: the port reads JPEG and PNG images only "
                             f"(gd3d_torch/data/images.py), not {Path(f).suffix}")


def teacher_config(tiny: bool):
    """gd3d's align/localize teacher: the full MASt3R, or its tiny one."""
    from gd3d_torch.models.croco import CrocoConfig
    from gd3d_torch.models.mast3r import Mast3rConfig

    if not tiny:
        return Mast3rConfig()
    return Mast3rConfig(
        croco=CrocoConfig(patch_size=16, enc_embed_dim=32, enc_depth=2, enc_num_heads=2,
                          dec_embed_dim=16, dec_depth=2, dec_num_heads=2),
        local_feat_dim=6, dpt_feature_dim=16, dpt_last_dim=8)


def resolve_device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asks for a card, and torch sees none "
                           "(pass --device cpu to run on the CPU)")
    return device


def build_teacher(args, device):
    """The frozen MASt3R teacher on `device`: --teacher-ckpt's weights, or
    seeded random ones (torch.Generator seed 0)."""
    import torch

    from gd3d_torch.teachers.mast3r import Mast3rTeacher

    with device:
        teacher = Mast3rTeacher(teacher_config(args.tiny))
    if args.teacher_ckpt:
        from gd3d_torch.cli.train import load_upstream

        load_upstream(teacher.model, args.teacher_ckpt)
    else:
        print("WARNING: no --teacher-ckpt; random MASt3R weights")
        teacher.init_params(torch.Generator(device=device).manual_seed(0))
    return teacher.eval()


def sync(device) -> float:
    """Wait for the device; the host clock after it."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def write_ply(path: Path, pts: np.ndarray, cols: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        f.writelines(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} {c[0]} {c[1]} {c[2]}\n"
                     for p, c in zip(pts, cols))


def main(argv=None, teacher=None) -> dict:
    """Parse, run the teacher over the pairs, align, export. `teacher` (a
    Mast3rTeacher on the device) takes the place of the one the flags
    would build. Returns the output dir, the Scene, the alignment's outputs
    (host arrays) and stats: teacher_s, align_s, align_ms_per_iter, tsdf_s,
    export_s, pairs, points."""
    args = parse_args(argv)
    import torch

    from gd3d_torch.align import _host, global_align, scene_from_mast3r, sparse_from_scene
    from gd3d_torch.data.images import load_image_mast3r
    from gd3d_torch.data.scene_graph import make_pair_indices

    device = resolve_device(args.device)
    files = _collect_images(args.images)
    assert len(files) >= 2, "need at least two images"
    check_readable(files)
    loaded = [load_image_mast3r(str(f), size=args.size) for f in files]
    shapes = {tuple(x["img"].shape) for x in loaded}
    assert len(shapes) == 1, (
        f"all images must share one post-resize shape, got {shapes}: align "
        "same-aspect-ratio groups separately")
    images_np = np.stack([x["img"] for x in loaded])
    images = torch.from_numpy(images_np).to(device)
    if teacher is None:
        teacher = build_teacher(args, device)

    n = images.shape[0]
    graph = "swin-2-noncyclic" if args.pairs == "sliding" else args.pairs
    if graph == "complete" and args.pair_filter is None:
        pairs = None  # scene_from_mast3r's complete graph
    else:
        pairs = make_pair_indices(n, graph, prefilter=args.pair_filter)
    if args.sparse_ga:
        return run_sparse_ga(args, teacher, images, images_np, pairs, device)
    stats = {}
    t0 = sync(device)
    desc_i = desc_j = None
    if args.colmap_db:
        scene, desc_i, desc_j = scene_from_mast3r(teacher, images, pairs=pairs, return_desc=True)
    else:
        scene = scene_from_mast3r(teacher, images, pairs=pairs)
    t1 = sync(device)
    stats.update(teacher_s=t1 - t0, pairs=len(scene.edges))
    sparse_k = args.sparse
    if sparse_k < 0:  # auto: dense only for small scenes
        H_im, W_im = scene.hw
        sparse_k = 1024 if n * H_im * W_im > 200_000 else 0
        if sparse_k:
            print(f"auto-selected sparse anchors (k={sparse_k}); pass --sparse 0 to force dense")
    if sparse_k > 0:
        scene = sparse_from_scene(scene, k=sparse_k)
    t1 = sync(device)
    out = global_align(scene, niter=args.niter, lr=args.lr, schedule=args.schedule)
    t2 = sync(device)
    stats.update(align_s=t2 - t1, align_ms_per_iter=(t2 - t1) * 1e3 / max(args.niter, 1),
                 points=int(scene.pred_i.shape[0] * scene.pred_i.shape[1]))
    if args.tsdf > 0:
        if scene.pix is not None:
            print("WARNING: --tsdf needs dense depth maps; skipping (rerun with --sparse 0)")
        else:
            from gd3d_torch.tsdf import tsdf_refine

            out = tsdf_refine(scene, out, thresh=args.tsdf, nsamples=args.tsdf_samples)
            t3 = sync(device)
            stats["tsdf_s"] = t3 - t2
            print(f"TSDF-refined depthmaps (thresh={args.tsdf})")
    t3 = time.perf_counter()
    out = {k: _host(v) for k, v in out.items()}

    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    P = scene.pred_i.shape[1]
    conf = np.zeros((n, P), np.float32)
    conf_i = _host(scene.conf_i)
    for e, (i, _) in enumerate(scene.edges):
        conf[int(i)] = np.maximum(conf[int(i)], conf_i[e].reshape(P))
    np.savez(outdir / "scene.npz", poses=out["poses"], focals=out["focals"],
             principal_points=out["principal_points"], depthmaps=out["depthmaps"],
             pts3d=out["pts3d"], confidence=conf, images=images_np, losses=out["losses"])
    print(f"aligned {n} images in {len(scene.edges)} pairs; final loss "
          f"{float(out['losses'][-1]):.4f} -> {outdir / 'scene.npz'}")
    names = [Path(f).name for f in files]

    if args.colmap:
        if scene.pix is not None:
            print("WARNING: --colmap needs a dense scene; skipping")
        else:
            from gd3d_torch.colmap_export import export_colmap_text

            export_colmap_text(
                {k: out[k] for k in ("poses", "focals", "principal_points", "pts3d")},
                str(outdir / "colmap"), images=images_np, confidence=conf,
                min_conf=args.min_conf, image_names=names)
            print(f"COLMAP text model -> {outdir / 'colmap'}")

    if args.colmap_db:
        from gd3d_torch.colmap_db import write_colmap_database
        from gd3d_torch.distill.keypoints import reciprocal_nn_grid

        H_im, W_im = scene.hw
        matches = {}
        for e, (i, j) in enumerate(map(tuple, scene.edges)):
            i, j = int(i), int(j)
            if i >= j:  # one direction per unordered pair
                continue
            xy1, xy2, ok = map(_host, reciprocal_nn_grid(desc_i[e], desc_j[e], H_im, W_im,
                                                         subsample=args.db_subsample))
            xy1, xy2 = xy1[ok], xy2[ok]
            px1 = np.stack([xy1 % W_im, xy1 // W_im], -1).astype(np.float32)
            px2 = np.stack([xy2 % W_im, xy2 // W_im], -1).astype(np.float32)
            matches[(i, j)] = (px1 + 0.5, px2 + 0.5)  # pixel centers
        db = write_colmap_database(
            str(outdir / "database.db"), names, scene.hw, matches, focals=out["focals"],
            principal_points=out["principal_points"], poses_c2w=out["poses"],
            min_len_track=args.min_len_track)
        stats["colmap_db"] = db
        print(f"COLMAP database: {db['images']} images, {db['keypoints']} keypoints, "
              f"{db['matches']} matches -> {outdir / 'database.db'}")

    if args.ply or args.html:
        pts = out["pts3d"].reshape(-1, 3)
        rgb = ((images_np + 1) * 127.5).clip(0, 255).astype(np.uint8).reshape(n, -1, 3)
        if scene.pix is not None:
            W_im = images_np.shape[2]
            lin = (scene.pix[..., 1] * W_im + scene.pix[..., 0]).astype(int)
            rgb = np.take_along_axis(rgb, lin[..., None], axis=1)
        cols = rgb.reshape(-1, 3)
        keep = conf.reshape(-1) > args.min_conf
        pts, cols = pts[keep], cols[keep]

    if args.html:
        from gd3d_torch.utils.html_viewer import write_html_viewer

        html = write_html_viewer(str(outdir / "scene.html"), pts, cols, out["poses"],
                                 out["focals"], hw=scene.hw)
        print(f"browser viewer -> {html}")

    if args.ply:
        write_ply(outdir / "pointcloud.ply", pts, cols)
        print(f"wrote {len(pts)} points -> {outdir / 'pointcloud.ply'}")
    stats["export_s"] = time.perf_counter() - t3
    return {"out_dir": outdir, "scene": scene, "out": out, "stats": stats}


def run_sparse_ga(args, teacher, images, images_np, pairs, device) -> dict:
    """The --sparse-ga path (gd3d's _run_sparse_ga): the two-stage sparse
    global alignment and the anchors densified, the same scene.npz, .ply and
    .html. Returns the output dir, the SparseScene, the alignment's result
    and stats: teacher_s, coarse_s, fine_s, their ms a step, export_s,
    pairs, correspondences."""
    from gd3d_torch.sparse_ga import (build_scene_from_mast3r, dense_pts3d,
                                      sparse_scene_optimizer)

    for flag in ("tsdf", "colmap", "colmap_db"):
        if getattr(args, flag):
            print(f"WARNING: --{flag.replace('_', '-')} applies to the dense path; ignored "
                  "under --sparse-ga")
    n = int(images.shape[0])
    t0 = sync(device)
    scene = build_scene_from_mast3r(teacher, images, pairs, subsample=args.ga_subsample)
    t1 = sync(device)
    res = sparse_scene_optimizer(scene, niter1=args.ga_niter1, niter2=args.ga_niter2,
                                 device=device)
    t2 = time.perf_counter()
    secs = res["seconds"]
    stats = {"teacher_s": t1 - t0, "pairs": len(scene.e_i),
             "correspondences": int(scene.valid.sum()),
             "coarse_s": secs["coarse"], "fine_s": secs.get("fine", 0.0),
             "coarse_ms_per_iter": secs["coarse"] * 1e3 / max(args.ga_niter1, 1),
             "fine_ms_per_iter": secs.get("fine", 0.0) * 1e3 / max(args.ga_niter2, 1)}
    best = res["fine"] if res["fine"] is not None else res["coarse"]
    pts_list, depth_list = dense_pts3d(scene, best)
    K = np.asarray(best["intrinsics"])
    pts3d = np.stack(pts_list).astype(np.float32)  # (N, H*W, 3)

    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    np.savez(outdir / "scene.npz", poses=np.asarray(best["cam2w"], np.float32),
             focals=K[:, 0, 0].astype(np.float32),
             principal_points=K[:, :2, 2].astype(np.float32),
             depthmaps=np.stack(depth_list).astype(np.float32), pts3d=pts3d, images=images_np)
    stage = "fine" if res["fine"] is not None else "coarse"
    print(f"sparse-GA aligned {n} images ({stage} stage, {int(scene.valid.sum())} "
          f"correspondences) -> {outdir / 'scene.npz'}")

    if args.ply or args.html:
        pts = pts3d.reshape(-1, 3)
        cols = ((images_np + 1) * 127.5).clip(0, 255).astype(np.uint8).reshape(-1, 3)
    if args.html:
        from gd3d_torch.utils.html_viewer import write_html_viewer

        html = write_html_viewer(str(outdir / "scene.html"), pts, cols,
                                 np.asarray(best["cam2w"]), K[:, 0, 0], hw=scene.hw)
        print(f"browser viewer -> {html}")
    if args.ply:
        write_ply(outdir / "pointcloud.ply", pts, cols)
        print(f"wrote {len(pts)} points -> {outdir / 'pointcloud.ply'}")
    stats["export_s"] = time.perf_counter() - t2
    return {"out_dir": outdir, "scene": scene, "res": res, "stats": stats}


if __name__ == "__main__":
    main()
