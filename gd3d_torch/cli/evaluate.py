"""Evaluation CLI of the port (counterpart of gd3d/cli/evaluate.py).

Usage:
  python -m gd3d_torch.cli.evaluate [--ckpt <run>/ckpt_epoch_0010] \\
      [--matcher mast3r|vggt|me|vanilla] [--transfer] [--tracking] [--pose] \\
      [--same-view] [--data-root data] [--out evaluation_output] [--device cuda]

gd3d's flags and output layout, <out>/timm/<matcher>/ViT-B-16/<dataset>/<ts>/
with pose_estimation.csv (OnePose-LowTexture), tracking.csv (TAP-Vid DAVIS)
and semantic_transfer.csv (PF-PASCAL PCK, one view mode), in that order,
written as gd3d's DataFrame.to_csv writes them. The matcher
sets the student: `me` has LoRA from block 8 and no adapters, `vanilla` LoRA
from block 12 (none) and no refine conv, the others the default student.
Weights: seeded with torch.Generator(42) (gd3d's key 42), then
--student-ckpt (a timm ViT state dict) and the adapters from --ckpt (the
port's own adapter checkpoint) or --adapter-ckpt (the reference's Lightning
layout). It runs on the card unless --device says otherwise; asking for
cuda without one raises.

--pose estimates poses with gd3d_torch/eval/pnp.py, which repeats
cv2.solvePnPRansac (EPnP, 8 px, 10 000 iterations) operation for operation:
OpenCV's RANSAC seeds its own generator with a constant, so its subsets
depend only on the point count, and tests/test_torch_pnp.py holds the port
to cv2's inlier sets and poses on seeded scenes. The descriptors and the
matching run on the device, the RANSAC on the host.
--tiny (a 4-block, 32-wide student with a 64^2 PCK canvas and 64 x 96
tracking frames, decoded in this process) is the port's own; otherwise
JPEGs and PNGs are decoded in one pool of min(8, CPUs) spawned processes
for the run. The module imports torch inside its functions only, so those
processes, which re-run its top level, start without it.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import TYPE_CHECKING

from gd3d_torch.eval.images import eval_workers, make_pool

if TYPE_CHECKING:
    import torch

    from gd3d_torch.core.config import StudentConfig
    from gd3d_torch.models.student import Student


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m gd3d_torch.cli.evaluate")
    p.add_argument("--ckpt", default=None, help="the port's adapter checkpoint file")
    p.add_argument("--adapter-ckpt", default=None,
                   help="reference Lightning .ckpt with w_a_*/adapter_* keys")
    p.add_argument("--matcher", default="mast3r", choices=["mast3r", "vggt", "me", "vanilla"])
    p.add_argument("--student-ckpt", default=None,
                   help="torch state_dict (.pth) of the pretrained timm student")
    p.add_argument("--transfer", action="store_true", help="PF-PASCAL semantic transfer (PCK)")
    p.add_argument("--tracking", action="store_true", help="TAP-Vid DAVIS tracking")
    p.add_argument("--pose", action="store_true", help="OnePose-LowTexture pose estimation")
    p.add_argument("--same-view", action="store_true")
    p.add_argument("--num-cats", type=int, default=None)
    p.add_argument("--num-videos", type=int, default=30)
    p.add_argument("--data-root", default="data")
    p.add_argument("--dataset", default="scannetpp",
                   help="run-dir tag only (evaluation_output layout)")
    p.add_argument("--out", default="evaluation_output")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default: the card)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny student and sizes (CPU smoke testing)")
    return p.parse_args(argv)


def student_config(matcher: str, tiny: bool = False) -> StudentConfig:
    from gd3d_torch.core.config import StudentConfig

    if matcher == "me":
        cfg = StudentConfig(lora_start_block=8, use_adapters=False)
    elif matcher == "vanilla":
        cfg = StudentConfig(lora_start_block=12, use_adapters=False)
    else:
        cfg = StudentConfig()
    if tiny:
        cfg = dataclasses.replace(cfg, embed_dim=32, depth=4, num_heads=2,
                                  pretrain_img_size=32, adapter_bottleneck=8,
                                  depth_head_hidden=16,
                                  lora_start_block=cfg.lora_start_block * 4 // 12)
    return cfg


def build_student(args, device: torch.device) -> Student:
    """The matcher's student on `device`: seeded weights, then the timm
    checkpoint and the adapters where given."""
    import torch

    from gd3d_torch.cli.train import load_upstream
    from gd3d_torch.core.checkpoint import (import_reference_layout,
                                            load_reference_checkpoint, restore_checkpoint)
    from gd3d_torch.models.student import Student, split_params
    from gd3d_torch.models.vit import init_params_

    cfg = student_config(args.matcher, args.tiny)
    with device:
        student = Student(cfg)
    init_params_(student, torch.Generator(device=device).manual_seed(42))
    if args.student_ckpt:
        load_upstream(student.vit, args.student_ckpt, may_miss=(".lora_", ".adapter."))
    else:
        print("WARNING: no --student-ckpt; the student has seeded random weights "
              "(torch.Generator seed 42)")
    trainable, _ = split_params(student)
    if args.ckpt:
        restore_checkpoint(args.ckpt, trainable, cfg)
    elif args.adapter_ckpt:
        import_reference_layout(trainable, load_reference_checkpoint(args.adapter_ckpt), cfg)
    student.requires_grad_(False)
    return student.eval()


def main(argv=None) -> dict:
    """Parse, build the student, run the asked evals. Returns the output
    dir, the tables by method and each method's stats (decode_s, wall_s,
    pairs or frames; tracking's also features_s, tracker_s and each
    video's own under "videos"; pose's also descriptors_s, nn_s, pnp_s,
    ransac_iterations and each test frame's under "frames_detail")."""
    import torch

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asks for a card, and torch sees none "
                           "(pass --device cpu to evaluate on the CPU)")
    student = build_student(args, device)
    refine = args.matcher != "vanilla"  # vanilla has no refine conv in the reference
    img_size, tracking_size = (64, (64, 96)) if args.tiny else (640, (476, 854))
    out_dir = (Path(args.out) / "timm" / args.matcher / "ViT-B-16" / args.dataset
               / time.strftime("%Y%m%d_%H%M%S"))
    out_dir.mkdir(parents=True, exist_ok=True)
    tables, stats = {}, {}

    with make_pool(eval_workers(args.tiny)) as pool:
        if args.pose:
            from gd3d_torch.eval.onepose import oneposepp

            stats["pose"] = {}
            tables["pose"] = oneposepp(
                student, root=f"{args.data_root}/lowtexture_test_data",
                sfm_dir=f"{args.data_root}/sfm_output/outputs_softmax_loftr_loftr",
                refine=refine, pool=pool, stats=stats["pose"])
            tables["pose"].to_csv(out_dir / "pose_estimation.csv")
            print(tables["pose"].mean())

        if args.tracking:
            from gd3d_torch.eval.tracking import tracking

            stats["tracking"] = {}
            tables["tracking"] = tracking(
                student, num_videos=args.num_videos,
                benchmark_pkl=f"{args.data_root}/tapvid_davis_data_strided.pkl",
                video_root=f"{args.data_root}/davis_480", refine=refine,
                size_hw=tracking_size, pool=pool, stats=stats["tracking"])
            tables["tracking"].to_csv(out_dir / "tracking.csv")
            print(tables["tracking"].mean())

        if args.transfer:
            from gd3d_torch.eval.pck import PASCAL_CATEGORIES, semantic_transfer

            cats = None if args.num_cats is None else PASCAL_CATEGORIES[: args.num_cats]
            stats["semantic_transfer"] = {}
            tables["semantic_transfer"] = semantic_transfer(
                student, f"{args.data_root}/PF-dataset-PASCAL", categories=cats,
                same_view=args.same_view, img_size=img_size, refine=refine, pool=pool,
                stats=stats["semantic_transfer"])
            tables["semantic_transfer"].to_csv(out_dir / "semantic_transfer.csv")
            print(tables["semantic_transfer"].mean())

    print(f"results saved under {out_dir}")
    return {"out_dir": out_dir, "tables": tables, "stats": stats}


if __name__ == "__main__":
    main()
