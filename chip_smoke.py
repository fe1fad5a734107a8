#!/usr/bin/env python3
"""Smoke run of the gd3d_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

It needs one card and takes no arguments. It prints the card's name and
power limit (nvidia-smi) and builds the CUDA kernels from gd3d_torch/csrc
with nvcc, one process per source (timed, with ptxas's register and spill
report), then runs these phases in order, one or more printed lines each:
  1. kernels  K1-K5 against their plain PyTorch twins at every main-path
              shape of both steps and of the train phase (ME, objaverse
              MASt3R): max abs error against the stated
              tolerance, the median device time of each (the host enqueues
              behind a long matrix product, so its own time per call,
              host_us, is printed apart), the time of one PyTorch call that
              computes the same function where there is one (library_ms,
              timed here only, with the name of the device kernel it ran),
              and the bound: the larger of
              bytes over 3.35 TB/s and operations over the peak of their
              type (989 TFLOP/s bf16, 67 TFLOP/s fp32 off the tensor cores;
              the fp32 K2, three TF32 products for each fp32 one, against
              495 / 3 = 165 TFLOP/s, its share of the 67 TFLOP/s bound
              printed beside), with the achieved TFLOP/s (those operations
              over the kernel's time) and the share of the bound reached; K1
              and K2 in bf16 and fp32 at the four student shapes, and fp32 at
              the CroCo-Stereo / CroCo-Flow training shapes (with K5); K2 at
              the MASt3R student's main shape in both dtypes and at the
              training shapes, and K4 and K4b at
              the MASt3R keypoint count, run twice and must give the same
              bits; K5 on one tensor and on each main-path layer's q and k in
              one launch; K1 and K2 at head dims 16 and 8 in both dtypes (the
              --tiny stereo model, zero-padded to 64 by the wrappers); one
              view off 16 bytes each for K1, K2, K3 and K5 (the wrappers copy
              it); K4 and K4b at a depth-head width of 48. The build line
              before it lists the bf16 flash kernels on TMA and wgmma
              (*_sm90_kernel) with their registers, static shared memory and
              spills;
  2. steps    two full-width MASt3R distillation steps (ViT-B/16 bf16
              student, MASt3R ViT-L/Base-decoder fp32 teacher, 336x512
              teacher and 512^2 student frames), two more with the
              student at its configured fp32 (the named config as gd3d's
              trainer runs it: 12 fp32 K2 and 20 fp32 K1 launches at the
              student's lengths a step, asserted), then two full-width
              VGGT steps (the bf16 student, VGGT-1B teacher with its
              aggregator in bf16 and its heads fp32, 518^2 frames): one pair
              per step,
              random weights from a seed (the teachers' last depth conv
              rescaled on the batch: Mast3rTeacher.face_forward,
              VggtTeacher.spread_depth); losses, keypoint count, step time,
              peak memory; the trainable parameters must change (all but the
              depth head's depth_attention branch, which training never
              calls), the frozen and teacher ones not, and every kernel must
              have launched in each path's run (counts set to 0 just before
              it and read just after); then K4 once more on the last step's
              own keypoints against its plain twin, with the sum of the valid
              keypoints' indices and depths (which keypoints the teacher
              selected, to compare two runs by), and the full-width MASt3R
              teacher with the fp32 K1 against the same teacher on K1's plain
              twin (fp32 tolerance), with the count of rasterised depth
              pixels that the rounding difference moves;
  3. profile  one more step of each path under torch.profiler: device time
              by kernel and the device's idle share of the step;
  4. agree    each step's losses and gradients on a small input, CUDA
              kernels against the CPU plain path, with shared weights, in
              fp32, and the MASt3R student once more under its bf16 autocast
              (the bf16 tensor-core K1 and K2);
  5. train    the training entry point, gd3d_torch.cli.train.main, in this
              process at full width on synthetic data with the named
              configs' fp32 students: (a) the ME baseline
              (finetune_timm_me_objaverse, 512^2 views resized to 1280^2,
              3000 keypoints), two epochs of one step straight, and one
              epoch resumed from its restart state to two, whose epoch-1
              loss and final state (trainable tensors, AdamW's moments and
              step counts, the accumulation buffer) must equal the straight
              run's (RESUME_TOL, STATE_TOL; the counts exactly); (b) the
              objaverse MASt3R path (384x512 teacher frames, the batch's
              depth maps), --dev --multistep 2; (c) VGGT ScanNet++, --dev.
              Each run prints its step records (losses, ap_pos_overflow for
              ME), median step time and peak memory, and asserts finite
              metrics, changed trainable tensors, unchanged frozen and
              teacher ones, and its kernel launches (counts set to 0 after
              the run's set-up, before its first step): fp32 K1 and K2 at
              the students' lengths, and every kernel on the teacher paths;
              then profiles one more group of each run's step, as phase 3;
  6. eval     (a) the JPEG decoder and the Lanczos resize on the committed
              fixtures (gd3d_torch/eval/testdata/) against PIL's SHA-256
              digests, with host ms per decode and resize, the
              progressive fixture among them; (b) the fp32 K1 at the eval's
              shapes, (8,1601,12,64) and (4,5986,12,64), in the kernels
              phase's format; (c) the card against the CPU plain path on
              shared weights: dense_grid_features at stride 8 on a 232x424
              frame and at stride 16 on a 640^2 canvas (TOL), and
              infer_tracks on identical features (TRACK_PX, TRACK_SHARE);
              (d) the evaluation entry point, gd3d_torch.cli.evaluate.main,
              in this process at full width (ViT-B/16 fp32 student, seeded
              weights, refine conv): --transfer and --tracking on fabricated
              PF-PASCAL (2 categories x 8 pairs) and DAVIS (2 videos x 12
              frames, the fixtures' known shifts as ground truth) trees;
              gd3d's CSV headers, finite values, exactly 24 K1 launches at N
              = 1601 a batch of 8 pairs and 12 at N = 5986 a batch of 4
              frames (counts set to 0 just before the run); pairs/s,
              frames/s, the decode share of each wall, peak memory; then one
              tracking feature batch under the profiler;
  7. data     the real-data readers (gd3d_torch/data/, check_data): (a) the
              committed PNG, JPEG, loader and augmentation fixtures
              (gd3d_torch/data/testdata/) against the digests of cv2's,
              PIL's and gd3d's outputs, and one worker's host seconds a pair
              by stage; (b) finetune_timm_mast3r_scannetpp (fp32 student)
              through the CLI on a fabricated ScanNet++ tree of 1752x1168
              JPEGs, --workers min(8, CPUs), 4 steps: 20 fp32 K1 at the
              student's lengths and 48 at the teacher's, 12 fp32 K2, 2 K3,
              1 K4, 1 K4b, 72 K5 a step, asserted; the steady step time, the
              host-wait share of the epoch and the idle share of one more
              epoch under the profiler; (c) finetune_timm_me_objaverse and
              finetune_timm_vggt_objaverse, 2 steps each, on a fabricated
              Objaverse tree (PNG colour, depth and mask); (d) the first two
              host batches at --workers 0 against gd3d's committed digests,
              and at --workers W against --workers 1;
  8. pose     OnePose-LowTexture, FiT3D and the DUSt3R tracker
              (check_pose): (a) gd3d_torch/eval/pnp.py against cv2 5.0.0's
              solvePnPRansac answers on 33 of the 39 recorded scenes
              (gd3d_torch/eval/testdata/pnp_cv2.npz; PNP_SKIP, the slowest,
              for the script's time): the same inlier sets,
              poses within 1e-6 of their norm, host ms a RANSAC call and its
              iterations; (b) the fp32 K1 at (1,4097,12,64) in the kernels
              phase's format, and the card against the CPU plain path:
              frame_descriptors of a 512^2 frame (TOL) and mutual_nn_match
              on identical descriptors (the card's bank, equal indices); (c)
              gd3d_torch.cli.evaluate.main(["--pose", ...]) at full width on
              a fabricated tree (a known-answer object, asserted 1.0 at every
              threshold, and a 128 000-row template bank): 12 fp32 K1
              launches at N = 4097 a frame, seconds a frame by stage, RANSAC
              iterations, frames/s, peak memory; (d) the FiT3D harness's
              compare with run_pose (refine=False asserted) on a smaller
              tree of the same kind (FIT3D_TREE: 4 bank frames, 1 test); (e) the DUSt3R
              tracker on 4 frames of 336x512: 48 K1 and 72 K5 a pair
              forward, tracks against the plain twins' (TRACK_EQUAL_SHARE).

  9. surface gd3d's step options, TensorBoard and data-parallel training
              (check_surface): (a) two MASt3R steps in bench.py's bf16
              envelope (bf16 student with bf16_stream, teacher_dtype
              bfloat16): 48 bf16 K1 and 72 bf16 K5 launches a step at the
              CroCo length 672, no fp32 K1 there, and the bf16 teacher's
              features against the fp32 teacher's (BF16_TEACHER_TOL); (b) the
              default-config loss and backward with StudentConfig.remat
              against the plain student on shared weights (REMAT_TOL), both
              peak memories, and one more fp32 K1 for each K2; (c)
              gd3d_torch.cli.train --tensorboard --multihost --fsdp-teacher
              on finetune_timm_vggt_scannetpp --dev at world size 1 against
              the train phase's plain run of the same batches, and its event
              file against metrics.jsonl; (d) that config's step (fp32
              student) on ScanNet++'s 350x518 frames: its teacher runs the
              fp32 K1 at N = 930 (48 a step) and 1860 (24), no bf16 K1 there,
              and the step time. The kernels phase holds the new shapes:
              bf16 K1 at the CroCo shapes, bf16 K5 on the CroCo q and k, fp32
              K1 at the 350x518 VGGT shapes.
 10. align    multi-view reconstruction (check_align): (a) global_align on
              the card, 300 cosine steps, on gd3d's synthetic scene at the
              align CLI's working size (4 views of 384x512, 12 ordered edges,
              196 608 points a view): gd3d's recovery bounds (relative
              rotation and translation direction < 2 degrees, focal within
              10%), the loop's ms a step, peak memory and profiled idle share;
              (b) the card against the port's CPU run on that scene with 0.03
              noise (ALIGN_AGREE_ITERS steps; losses 1e-3, outputs 1e-2);
              (c) the teacher call of the path (the full MASt3R, seeded
              weights, face_forward; all 12 ordered pairs of 4 frames in one
              extract_features): fp32 K1 and K5 on the operands it hands them
              (N = 768) against their plain twins in the kernels phase's
              format, and the call on both twins on the card (pts3d_1, conf_1,
              desc_1 within TOL); (d) the entry points in this process on 4
              windows of the DSLR fixture (gd3d_torch/data/testdata/dslr.jpg,
              512x384 after the resize): gd3d_torch.cli.align.main dense
              (--sparse 0 --tsdf 0.3 --colmap --colmap-db --ply --html; its
              launches exactly one teacher call's, 48 fp32 K1 at N = 768 and
              72 K5) and by default (auto-sparse), gd3d_torch.cli.localize.main
              for 2 queries with --coarse-to-fine, and one upload of 2 frames to
              gd3d_torch.cli.demo's server: every file, gd3d's keys and shapes,
              finite values, the COLMAP database read back through sqlite3; the
              teacher call's, alignment's, TSDF's and a query's seconds.
 11. sparse_ga MASt3R's two-stage sparse global alignment (check_sparse_ga):
              (a) gd3d's synthetic sphere scene, 300 + 300 steps on the card,
              held to tests/test_sparse_ga.py's recovery bounds; (b) the card
              against the CPU on that scene with noisy correspondences and
              the DUSt3R fallback live, 20 steps of each stage (SGA_TOL, poses
              and points in the MST root's frame); (c)
              gd3d_torch.cli.align.main --sparse-ga --ply --html at the CLI's
              subsample 8 (SGA_CLI_STEPS = 200 + 200 steps) on the align phase's 4
              windows: its launches exactly one teacher call's (the 6 pairs in
              one chunk), scene.npz's keys and shapes, the teacher's and each
              stage's seconds and ms a step, the idle share of 20 + 20
              profiled steps.
 12. stereoflow CroCo-Stereo / CroCo-Flow (check_stereoflow): (a)
              gd3d_torch.cli.stereoflow.main train at full width (CroCo v2
              ViT-L encoder, Base decoder, DPT; batch 2) for 2 steps of each
              task on a generic tree it writes (PNG pairs, PFM disparities
              with +inf holes, .flo flows), from a seeded init file: 36 fp32
              K1, 36 fp32 K2, 48 K5 forward and 48 K5 backward a step at the
              crop's length (968 stereo, 480 flow), finite losses, every
              trained tensor moved, step time and peak memory, then one more
              step profiled (each kernel's share); (b) one AdamW step of a
              small model (head dim 64) on the card against the CPU: the loss
              (SF_LOSS_TOL), the gradients, AdamW's moments and the weights
              (SF_STATE_TOL); and two steps of the CLI's train --tiny (head
              dims 16 and 8) on the card against the CPU (the same bounds on
              the loss, the moments and the weights); (c) eval on 1 pair of
              a KITTI 2015 tree at 375x1242 (8 tiles a pair in one forward)
              and predict on one: the files, their shapes, the launches.
 13. pretrain CroCo and MASt3R pretraining (check_pretrain): (a) fp32 K1
              and K2 at the pretraining shapes, (16,20,16,64) (the CroCo
              net's masked encoder: 20 visible tokens of 196, under one
              64-row tile), (16,196,16|12,64) and (4,1024,16|12,64), and K5
              on their q and k (the masked rows on each row's own gathered
              positions), in the kernels phase's format; (b)
              gd3d_torch.cli.pretrain.main --objective croco --export-dust3r
              at full width (CroCo v2 ViT-L/16 encoder, Base decoder; 224^2,
              batch 16, mask 0.9), 2 steps on procedural pairs: 60 K1, 60 K2,
              72 K5 forward and 72 backward a step (24 K1 at N = 20, 36 at
              196), finite losses, every trained tensor moved from its
              weights before step 0 (the CLI's on_start hook keeps them and
              sets the counts to 0), step time, peak memory, then one more
              step profiled; (c) --objective mast3r --init-trunk on (b)'s
              dust3r_trunk.npz at 512^2, batch 2, 2 steps (48, 48, 72, 72 a
              step at N = 1024), the weights before step 0 holding the
              trunk bit for bit, the heads' last conv face-forwarded on
              step 0's batch (pt_face_forward: flax's init overflows
              expm1 and exp there at full width); (d) the same objective at
              224^2 on a fabricated Co3D-v2 tree (fixtures.write_co3d_tree),
              2 steps;
              (e) one step of each objective on a small model (head dim 64)
              on the card against the CPU (PT_LOSS_TOL, PT_STATE_TOL,
              RESUME_TOL on the weights), and through the CLI a straight 4-step run
              against a 2 + 2 resumed one.
 14. datagen  dataset creation (check_datagen), on the host as gd3d's runs:
              (a) gd3d_torch.cli.render.main, 2 procedural objects x 6 views
              at 512^2, and the fixture .glb (fixtures.write_glb) x 4 views
              with Lambert shading and shadow maps, --workers 2: every PNG
              decoded, each tree's digests against the committed ones of
              gd3d's (gd3d_torch/data/testdata/datagen_digests.json), seconds
              a view; (b) gd3d_torch.cli.preprocess.main on each fabricated
              raw tree (fixtures.write_raw_tree: Co3D-v2, WildRGB-D,
              ScanNet++, ARKitScenes, BlendedMVS, StaticThings3D, Waymo) and
              the Habitat generator: the digests, the tree read by the port's
              reader for its dataset and one pretraining batch drawn from it
              (views_pretrain_batch), seconds a frame (MegaDepth: the formats
              phase); (c) gd3d_torch.cli.train at full
              width, --config finetune_timm_mast3r_objaverse, 2 steps on
              (a)'s tree (--data-root): finite losses, its K1-K5 launches.

 15. formats  the decoders of every file gd3d reads (check_formats), on the
              host: (a) every committed fixture of
              gd3d_torch/data/testdata/formats (tests/torch_formats_gen.py)
              to its digest: PIL's RGB of progressive, CMYK, YCCK and 4:1:1
              JPEG, lossy, lossless and alpha WebP, RLE8, 5-6-5 and 32-bit
              BMP, Adam7 and 2-bit PNG; the EXR writer's values of ZIP, PIZ
              and RLE depth; h5py's arrays of HDF5 depth at both file
              formats; with host ms per decode at the sizes users meet (854x480
              4:2:0 progressive JPEG, 512x384 lossy and lossless WebP, a
              512x384 24-bit BMP, a 1024x768 ZIP EXR and a 1024x768 chunked
              gzip HDF5 depth, the last three written here and read back
              equal); (b) gd3d_torch.cli.align (dense, --niter FORMATS_NITER)
              with the fp32 MASt3R teacher at full width on the four views
              (progressive JPEG, lossy WebP, 24-bit BMP, Adam7 PNG): the
              loaded [-1, 1] arrays against gd3d's load_image_mast3r
              digests, the teacher's K1 and K5 launches, scene.npz as the
              align phase checks it; (c) MegaDepth preprocessed from its
              .h5 depth to gd3d's digests (datagen_digests.json) and read
              through MegaDepthViews; (d) BlendedMVS read from an EXR-only
              tree equals the same tree with .npy depth; (e) a .h5
              disparity and a .flo5 flow through flowio.read_gt to gd3d's
              digests, and a write_flo5 round trip. The phase's seconds.

Then one JSON line of the kernels (launches: the steps, train, eval, data,
pose, surface, align, sparse_ga, stereoflow, pretrain, datagen and formats
phases' runs together; "K2 bf16", the bf16 K2 at the student's main pass beside the
fp32 K2 entry, counts the bf16 K2 launches of the steps phase and of the
surface phase's step runs), the card line, and last the JSON result line.
Exits non-zero, printing no result, without a CUDA device or if any phase
fails. The kernels and agree phases compare fp32 results too, so they
run without TF32; the steps run with PyTorch's defaults (the teachers turn TF32
off themselves).
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# id -> (name, source, TPU kernel it replaces)
# K1's entry holds its designated case, bf16 at the student's main pass
# (flash_fwd_sm90.cu; fp32 and head dim 128 run flash_fwd.cu); K2's the fp32
# one and "K2 bf16" the bf16 one at the same shape, whose launches are the
# bf16 K2 launches of the step runs (run_steps: the steps phase and the
# surface phase's bf16 envelope), also counted in K2's
REPLACES = {
    "K1": ("flash_attention_fwd", "gd3d_torch/csrc/flash_fwd_sm90.cu",
           "gd3d/ops/attention.py:180"),
    "K2": ("flash_attention_bwd_fused", "gd3d_torch/csrc/flash_bwd.cu",
           "gd3d/kernels/flash_bwd_fused.py:262"),
    "K2 bf16": ("flash_attention_bwd_fused", "gd3d_torch/csrc/flash_bwd_sm90.cu",
                "gd3d/kernels/flash_bwd_fused.py:262"),
    "K3": ("masked_softmax_kl_rows", "gd3d_torch/csrc/cost_kl.cu",
           "gd3d/kernels/cost_kl.py:59"),
    "K4": ("pairwise_rank_fwd", "gd3d_torch/csrc/pairwise_rank.cu",
           "gd3d/kernels/pairwise_rank.py:235"),
    "K4b": ("pairwise_rank_bwd", "gd3d_torch/csrc/pairwise_rank.cu",
            "gd3d/kernels/pairwise_rank.py:309"),
    "K5": ("rope2d_fwd", "gd3d_torch/csrc/rope2d.cu", "gd3d/kernels/rope2d.py:58"),
}
# the kernels' launch counters (gd3d_torch.kernels.launch_counts), which a
# run that must launch every kernel checks
KERNELS = tuple(k for k in REPLACES if k != "K2 bf16")
# Tolerance: max abs error <= TOL[dtype] * max(1, max |plain|). fp32: the
# kernels and the plain twins sum in different orders (<= 6401 terms);
# bf16: both round an fp32 result to bf16 (8 mantissa bits), so one ulp of
# the largest value can separate them; the bf16 K1 and K2 also round P and
# dS to bf16 before their tensor-core products (at most 2^-9 relative per
# term), and K5's twin rounds cos and sin to bf16 first, as gd3d does. K1's
# log-sum-exp is fp32 whatever the operands, so it is held to the fp32
# tolerance in every case.
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# The ME run resumed from its restart state against the straight run: the
# epoch-1 loss, and the final trainable tensors and accumulation buffer,
# each kind as ||resumed - straight|| / ||straight|| over all its tensors.
# The same bits are expected, but scatter-adds of the keypoint
# interpolation's backward (atomics) may order the gradient's sums
# otherwise. 1e-5 is far below any change of the state: one update moves
# the loss by ~1e-3.
RESUME_TOL = 1e-5
# The same for AdamW's moments, which hold the gradients themselves. AdamW's
# first update moves an element by about lr * sign(grad), so where a
# gradient sits near zero, sums in another order can flip it; LoRA B starts
# at zero and LoRA A's next gradient passes through it, so the moments
# agree to ~1e-4 (LoRA A of the first LoRA block the worst). A resume that
# dropped AdamW's state would leave the moments of one gradient where the
# straight run holds two (off by their own size), and unequal step counts,
# which are compared exactly.
STATE_TOL = 1e-3
# the CroCo-Stereo / CroCo-Flow training crops' token grids (352x704 and
# 320x384 at patch 16) and lengths
STEREOFLOW_GRIDS = {"CroCo-Stereo": (22, 44), "CroCo-Flow": (20, 24)}
STEREOFLOW_LENGTHS = {t: gh * gw for t, (gh, gw) in STEREOFLOW_GRIDS.items()}
HBM_BYTES_PER_S = 3.35e12
# H100 SXM, dense. "tf32x3": the fp32 K2's route, three TF32 products on the
# tensor cores (495 TFLOP/s) for each fp32 product
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def device_kernel_name(fn) -> str:
    """The device kernel that took the most time in one profiled call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # a profile now and then comes back without device events
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
        if rows:
            return max(rows, key=lambda e: e.device_time_total).key
    return "none seen"


def bound(nbytes: float, ops: float, peak: str):
    """The least time the card could take: (ms, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[peak]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def sm90_resources(report: str) -> list:
    """From nvcc's ptxas report, one line for each bf16 flash kernel on
    Hopper's machinery (name ending in _sm90_kernel, with its number of
    consumer warpgroups): registers, static shared memory (the tiles are
    dynamic shared memory, which ptxas does not print) and spills. ptxas
    counts the registers a thread has at launch; setmaxnreg then moves them
    from the producer warpgroup (24) to the consumers (232 or 240)."""
    import re

    lines, name, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\w*?(flash_\w+_sm90_kernel)(?:ILi(\d)E)?", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            continue
        if name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
        elif "Compiling entry function" in line:
            name = None
    return lines


def max_err(got, want) -> tuple[float, float]:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()), float(want.abs().max())


class KernelReport:
    """Errors, times and bounds per kernel case; one designated case per
    kernel fills its entry of the JSON line (its error, times and bound);
    every case is held to its tolerance and logged on its own line."""

    def __init__(self):
        self.results = {k: {"max_abs_err": None, "ms": None, "plain_ms": None,
                            "bound_ms": None, "bound_by": None, "library_ms": None}
                        for k in REPLACES}
        self.ok = True

    def check(self, kern, where, pairs, run, run_plain, nbytes, ops, dtype, iters,
              run_library=None, designated=False, peak=None, entry=None):
        import torch

        from gd3d_torch.kernels.timing import time_ms

        torch.cuda.synchronize()
        worst, line_ok, parts = 0.0, True, []
        for name, a, b, tol_dt in pairs:
            err, mag = max_err(a, b)
            tol = TOL[tol_dt] * max(1.0, mag)
            line_ok &= math.isfinite(err) and err <= tol
            worst = max(worst, err)
            parts.append(f"{name} err={err:.3e} tol={tol:.1e}")
        (ms, host_us), (plain_ms, _) = time_ms(run, iters), time_ms(run_plain, iters)
        lib_ms, lib = None, "none"
        if run_library is not None:
            lib_ms = time_ms(run_library, iters)[0]
            lib = f"{lib_ms:.4f} ({device_kernel_name(run_library)[:60]})"
        b_ms, b_by = bound(nbytes, ops, peak or dtype)
        also = ""
        if peak not in (None, dtype):  # the dtype's own bound beside the route's
            d_ms, d_by = bound(nbytes, ops, dtype)
            also = f" {dtype}_cores_bound_ms={d_ms:.4g} ({d_by}) share={d_ms / ms:.3f}"
        log(f"kernels: {kern} {where}: {' '.join(parts)} {'OK' if line_ok else 'FAIL'} "
            f"kernel_ms={ms:.4f} host_us={host_us:.1f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib} bound_ms={b_ms:.4g} ({b_by}, {peak or dtype}) "
            f"tflops={ops / ms / 1e9:.2f} bound_share={b_ms / ms:.3f}{also}")
        self.ok &= line_ok
        if designated:
            self.results[entry or kern].update(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                      library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def attn_case(rep, g, dev, kern, where, B, N, H, D, dt, designated, repeat=False):
    """K1 or K2 against its plain twin at one shape, q, k, v as the strided
    (B, N, H, D) views of one qkv projection; a K2 case with `repeat` also
    runs twice and must repeat its bits."""
    import torch
    import torch.nn.functional as F

    from gd3d_torch.kernels.flash_bwd_fused import (
        flash_attention_bwd_fused, flash_attention_bwd_plain)
    from gd3d_torch.kernels.flash_fwd import flash_attention_fwd, flash_attention_fwd_plain

    qkv = torch.randn((B, N, 3, H, D), generator=g, device=dev).to(dt)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = D ** -0.5
    elt, dname = q.element_size(), str(dt).split(".")[-1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    tag = f"{where} B={B} N={N} H={H} D={D} {dname}"
    iters = 10 if N > 1000 else 30
    if kern == "K1":
        o, lse = flash_attention_fwd(q, k, v, scale)
        o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, scale)
        rep.check(
            kern, tag, [("o", o, o_ref, dname), ("lse", lse, lse_ref, "float32")],
            lambda: flash_attention_fwd(q, k, v, scale),
            lambda: flash_attention_fwd_plain(q, k, v, scale),
            nbytes=4 * B * N * H * D * elt + B * H * N * 4,
            ops=4.0 * B * H * N * N * D, dtype=dname, iters=iters,
            run_library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale),
            designated=designated)
    else:
        o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, scale)
        do = torch.randn((B, N, H, D), generator=g, device=dev).to(dt)
        di = torch.einsum("bnhd,bnhd->bhn", o_ref.float(), do.float()).contiguous()
        grads = flash_attention_bwd_fused(q, k, v, lse_ref, do, di, scale)
        refs = flash_attention_bwd_plain(q, k, v, lse_ref, do, di, scale)
        if repeat:
            # every sum runs in a fixed order: the same bits again
            again = flash_attention_bwd_fused(q, k, v, lse_ref, do, di, scale)
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            log(f"kernels: K2 {tag} repeat bit-identical {same} "
                f"{'OK' if same else 'FAIL'}")
            rep.ok &= same
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (qh, kh, vh))
        out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
        doh = do.transpose(1, 2)
        rep.check(
            kern, tag,
            [(n, a, b, dname) for n, a, b in zip(("dq", "dk", "dv"), grads, refs)],
            lambda: flash_attention_bwd_fused(q, k, v, lse_ref, do, di, scale),
            lambda: flash_attention_bwd_plain(q, k, v, lse_ref, do, di, scale),
            nbytes=7 * B * N * H * D * elt + 2 * B * H * N * 4,
            ops=10.0 * B * H * N * N * D, dtype=dname, iters=iters,
            run_library=lambda: torch.autograd.grad(out, (ql, kl, vl), doh,
                                                    retain_graph=True),
            designated=designated, entry="K2" if dt == torch.float32 else "K2 bf16",
            peak="tf32x3" if dt == torch.float32 else None)


def rope_pair_case(rep, g, dev, where, B, N, H, dt, kind, qpos, kpos, designated=False):
    """K5 on q and k in one launch, forward and backward (-f0), against the
    plain twin: q and k as a main path hands them over, (B, H, N, D) views
    of a (B, N, 3, H, D) projection ("qkv") or of separate ones. A
    designated case fills K5's JSON entry with its forward."""
    import torch

    from gd3d_torch.kernels.rope2d import rope2d_plain, rope2d_qk_fwd

    if kind == "qkv":
        qkv = torch.randn((B, N, 3, H, 64), generator=g, device=dev).to(dt)
        q, k = qkv[:, :, 0].transpose(1, 2), qkv[:, :, 1].transpose(1, 2)
    else:
        q, k = (torch.randn((B, N, H, 64), generator=g, device=dev).to(dt).transpose(1, 2)
                for _ in range(2))
    dname, elt = str(dt).split(".")[-1], q.element_size()
    for direction, f0 in (("fwd", 1.0), ("bwd", -1.0)):
        yq, yk = rope2d_qk_fwd(q, qpos, k, kpos, 100.0, f0)
        rep.check(
            "K5", f"pair {direction} {where} q, k (B,N,H,D)=({B},{N},{H},64) {dname}",
            [("q", yq, rope2d_plain(q, qpos, 100.0, f0), dname),
             ("k", yk, rope2d_plain(k, kpos, 100.0, f0), dname)],
            lambda: rope2d_qk_fwd(q, qpos, k, kpos, 100.0, f0),
            lambda: (rope2d_plain(q, qpos, 100.0, f0), rope2d_plain(k, kpos, 100.0, f0)),
            nbytes=2 * (2 * B * N * H * 64 * elt + B * N * 2 * 8),
            ops=2 * 3.0 * B * N * H * 64, dtype=dname, iters=50,
            designated=designated and f0 > 0)


def misaligned_cases(rep, g, dev) -> None:
    """One view off 16 bytes for each kernel that reads 16-byte vectors, at
    the student's cost-pass shape: K1 with q sliced from a projection whose
    row step is off 16 bytes, K2 with k at an address 2 bytes off, K3 with
    the cost map 4 bytes off the teacher map, K5 on tokens 4 bytes off. The
    wrappers copy such a view; the results must equal the plain twins'."""
    import torch

    from gd3d_torch.kernels.cost_kl import _reference_rows, masked_softmax_kl_fwd
    from gd3d_torch.kernels.flash_bwd_fused import (
        flash_attention_bwd_fused, flash_attention_bwd_plain)
    from gd3d_torch.kernels.flash_fwd import (
        aligned_16, flash_attention_fwd, flash_attention_fwd_plain)
    from gd3d_torch.kernels.rope2d import rope2d_fwd, rope2d_plain
    from gd3d_torch.ops.masks import masked_patch_cost
    from gd3d_torch.ops.rope2d import grid_positions

    bf16 = torch.bfloat16
    B, N, H, D = 2, 673, 12, 64
    wide = torch.randn((B, N, 3 * H * D + 4), generator=g, device=dev).to(bf16)
    q = wide[..., :3 * H * D].reshape(B, N, 3, H, D)[:, :, 0]
    k, v, do = (torch.randn((B, N, H, D), generator=g, device=dev).to(bf16) for _ in range(3))
    k_off = torch.empty(k.numel() + 1, dtype=bf16, device=dev)[1:].view(k.shape).copy_(k)
    assert not aligned_16(q) and not aligned_16(k_off)
    elt, tag = 2, f"B={B} N={N} H={H} D={D} bfloat16"
    rep.check("K1", f"misaligned q (row step off 16 bytes) {tag}",
              [(n, a, b, dt) for n, a, b, dt in zip(
                  ("o", "lse"), flash_attention_fwd(q, k, v, 0.125),
                  flash_attention_fwd_plain(q, k, v, 0.125), ("bfloat16", "float32"))],
              lambda: flash_attention_fwd(q, k, v, 0.125),
              lambda: flash_attention_fwd_plain(q, k, v, 0.125),
              nbytes=4 * B * N * H * D * elt + B * H * N * 4, ops=4.0 * B * H * N * N * D,
              dtype="bfloat16", iters=20)
    o, lse = flash_attention_fwd_plain(q, k_off, v, 0.125)
    di = torch.einsum("bnhd,bnhd->bhn", o.float(), do.float()).contiguous()
    args = (q, k_off, v, lse, do, di, 0.125)
    rep.check("K2", f"misaligned q (row step) and k (address off 2 bytes) {tag}",
              [(n, a, b, "bfloat16") for n, a, b in zip(
                  ("dq", "dk", "dv"), flash_attention_bwd_fused(*args),
                  flash_attention_bwd_plain(*args))],
              lambda: flash_attention_bwd_fused(*args), lambda: flash_attention_bwd_plain(*args),
              nbytes=7 * B * N * H * D * elt + 2 * B * H * N * 4, ops=10.0 * B * H * N * N * D,
              dtype="bfloat16", iters=20)
    raw = torch.rand((1, 672, 672), generator=g, device=dev)
    mask = torch.rand((1, 672), generator=g, device=dev) > 0.3
    teacher_p = masked_patch_cost(raw, mask[0])
    cost = torch.empty(672 * 672 + 1, device=dev)[1:].view(1, 672, 672).copy_(
        torch.rand((1, 672, 672), generator=g, device=dev) * 2 - 1)
    kept = int(mask.sum())
    rep.check("K3", "cost map 4 bytes off the teacher map B=1 N=672 M=672 float32",
              [("kl", masked_softmax_kl_fwd(teacher_p, cost, mask),
                _reference_rows(teacher_p, cost, mask, 1e-8), "float32")],
              lambda: masked_softmax_kl_fwd(teacher_p, cost, mask),
              lambda: _reference_rows(teacher_p, cost, mask, 1e-8),
              nbytes=(672 + kept) * 672 * 4 + 672 + 672 * 4, ops=8.0 * 672 * 672,
              dtype="float32", iters=20)
    x = torch.empty(2 * 672 * 16 * 64 + 1, device=dev)[1:].view(2, 672, 16, 64).copy_(
        torch.randn((2, 672, 16, 64), generator=g, device=dev)).transpose(1, 2)
    pos = grid_positions(21, 32, 2, device=dev)
    rep.check("K5", "tokens 4 bytes off (B,N,H,D)=(2,672,16,64) float32",
              [("out", rope2d_fwd(x, pos), rope2d_plain(x, pos), "float32")],
              lambda: rope2d_fwd(x, pos), lambda: rope2d_plain(x, pos),
              nbytes=2 * 2 * 672 * 16 * 64 * 4 + 2 * 672 * 2 * 8, ops=3.0 * 2 * 672 * 16 * 64,
              dtype="float32", iters=20)


def check_kernels(dev) -> dict:
    """Each kernel against its plain twin on the same inputs, at the shapes
    the main paths give it."""
    import torch

    from gd3d_torch.kernels.cost_kl import _reference_rows, masked_softmax_kl_fwd
    from gd3d_torch.kernels.pairwise_rank import (
        pairwise_rank_bwd, pairwise_rank_bwd_plain, pairwise_rank_fwd,
        pairwise_rank_sums_plain, pairwise_ranking_sums)
    from gd3d_torch.kernels.rope2d import rope2d_fwd, rope2d_plain
    from gd3d_torch.kernels.timing import time_ms
    from gd3d_torch.ops.masks import masked_patch_cost
    from gd3d_torch.ops.rope2d import grid_positions

    g = torch.Generator(device=dev).manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    rep = KernelReport()
    # what a launch costs with no work to speak of, timed the same way: the
    # floor under the short kernels' times (K3, K5, the camera trunk's K1)
    one = torch.zeros(1, device=dev)
    floor_ms, floor_us = time_ms(lambda: one.add_(1.0), 50)
    log(f"kernels: launch floor (a PyTorch add of one element) kernel_ms={floor_ms:.4f} "
        f"host_us={floor_us:.1f}")
    # the student's four lengths, in bf16 (bench.py's student) and in fp32
    # (the named configs' compute_dtype, which gd3d's trainer keeps)
    student = [("MASt3R student main pass", 2, 4161), ("MASt3R student cost pass", 2, 673),
               ("VGGT student main pass", 2, 6401), ("VGGT student cost pass", 2, 1370)]
    attn_cases = [
        # (kernel, where on the main paths, B, N, H, D, dtype, designated);
        # a designated K2 case also runs twice and must repeat its bits
        *[("K1", where, B, N, 12, 64, dt, (dt, N) == (bf16, 4161))
          for dt in (bf16, f32) for where, B, N in student],
        ("K1", "CroCo encoder", 2, 672, 16, 64, f32, False),
        ("K1", "CroCo decoder", 2, 672, 12, 64, f32, False),
        ("K1", "DINOv2 + VGGT frame attention", 2, 1374, 16, 64, bf16, False),
        ("K1", "VGGT global attention", 1, 2748, 16, 64, bf16, False),
        ("K1", "VGGT camera trunk", 1, 2, 16, 128, f32, False),
        # the bf16 MASt3R teacher (bench.py's bf16 envelope), and the VGGT
        # teacher on ScanNet++'s 350x518 frames, whose aggregator runs fp32
        ("K1", "CroCo encoder (bf16 teacher)", 2, 672, 16, 64, bf16, False),
        ("K1", "CroCo decoder (bf16 teacher)", 2, 672, 12, 64, bf16, False),
        ("K1", "DINOv2 + VGGT frame attention 350x518", 2, 930, 16, 64, f32, False),
        ("K1", "VGGT global attention 350x518", 1, 1860, 16, 64, f32, False),
        *[("K2", where, B, N, 12, 64, dt, N == 4161)
          for dt in (bf16, f32) for where, B, N in student],
        # the train phase's own shapes: the ME student (one view a call,
        # 512^2 -> 1280^2) and the objaverse MASt3R path (384x512 frames),
        # fp32 as the named configs run
        *[(kern, where, B, N, H, 64, f32, False) for kern, where, B, N, H in (
            ("K1", "ME student (one view)", 1, 6401, 12),
            ("K1", "objaverse MASt3R student main pass", 2, 4801, 12),
            ("K1", "objaverse MASt3R student cost pass", 2, 769, 12),
            ("K1", "objaverse CroCo encoder", 2, 768, 16),
            ("K1", "objaverse CroCo decoder", 2, 768, 12),
            ("K2", "ME student (one view)", 1, 6401, 12),
            ("K2", "objaverse MASt3R student main pass", 2, 4801, 12),
            ("K2", "objaverse MASt3R student cost pass", 2, 769, 12))],
        # CroCo-Stereo / CroCo-Flow training (the stereoflow phase): the fp32
        # trunk fine-tuned at the crops' lengths, 352x704 -> 968 tokens and
        # 320x384 -> 480, the encoder over both views of 2 pairs, the decoder
        # over 2; their K2 cases also run twice and must repeat their bits
        *[(kern, f"{task} {part}", B, N, H, 64, f32, False)
          for kern in ("K1", "K2") for task, N in STEREOFLOW_LENGTHS.items()
          for part, B, H in (("encoder", 4, 16), ("decoder", 2, 12))],
        # cli.stereoflow train --tiny (64x96 crops, 24 tokens, batch 2): head
        # dims 16 (encoder, both views) and 8 (decoder), zero-padded to 64
        *[(kern, f"CroCo-Stereo --tiny {part}", B, 24, 2, D, dt, False)
          for kern in ("K1", "K2") for dt in (f32, bf16)
          for part, B, D in (("encoder", 4, 16), ("decoder", 2, 8))],
    ]
    for kern, where, B, N, H, D, dt, designated in attn_cases:
        attn_case(rep, g, dev, kern, where, B, N, H, D, dt, designated,
                  repeat=designated or N in STEREOFLOW_LENGTHS.values())

    # K3 at the cost volume of one pair (M = N on both paths), masked rows in;
    # and an odd M, whose rows start off 16 bytes. The kernel reads no cost
    # row of a masked patch (it is zeroed), so the bound counts kept rows only
    for N, M, designated in ((672, 672, True), (1369, 1369, False), (672, 37, False),
                             (768, 768, False)):
        raw = torch.rand((1, N, M), generator=g, device=dev)
        mask = torch.rand((1, N), generator=g, device=dev) > 0.3
        kept = int(mask.sum())
        teacher_p = masked_patch_cost(raw, mask[0])
        cost = torch.rand((1, N, M), generator=g, device=dev) * 2 - 1
        rep.check(
            "K3", f"cost-volume KL B=1 N={N} M={M} float32 ({N - kept} masked rows)",
            [("kl", masked_softmax_kl_fwd(teacher_p, cost, mask),
              _reference_rows(teacher_p, cost, mask, 1e-8), "float32")],
            lambda: masked_softmax_kl_fwd(teacher_p, cost, mask),
            lambda: _reference_rows(teacher_p, cost, mask, 1e-8),
            nbytes=(N + kept) * M * 4 + N + N * 4, ops=8.0 * N * M, dtype="float32", iters=50,
            designated=designated)

    misaligned_cases(rep, g, dev)

    # K4 forward and both gradient passes at each step's keypoint count, and
    # at a depth-head width that is no multiple of 32 (held padded to 64)
    for N, where, designated, h in ((672, "MASt3R", True, 128), (300, "VGGT", False, 128),
                                    (768, "objaverse MASt3R", False, 128),
                                    (672, "MASt3R, depth head 48 wide,", False, 48)):
        u = torch.randn((2, N, h), generator=g, device=dev) * 0.5
        head = [torch.randn(h, generator=g, device=dev) * 0.1,
                1 + torch.randn(h, generator=g, device=dev) * 0.05,
                torch.randn(h, generator=g, device=dev) * 0.05,
                torch.randn(h, generator=g, device=dev) * 0.2,
                torch.randn(1, generator=g, device=dev) * 0.1]
        depths = torch.rand((2, N), generator=g, device=dev) * 3
        valid = torch.rand((2, N), generator=g, device=dev) > 0.25
        args = (u, *head, depths, valid)
        rows, cnts = pairwise_rank_fwd(*args, 0.05)
        rows_p, cnts_p = pairwise_rank_sums_plain(*args, 0.05)
        n_pairs = float(cnts.sum())
        tag = f"{where} intra-depth u=(2,{N},{h}) float32 ({int(n_pairs)} valid pairs)"
        g_rows = torch.rand((2, N), generator=g, device=dev)
        if designated:  # partials summed in a fixed order, no atomics: the same bits again
            same = all(torch.equal(a, b) for a, b in zip(
                (rows, cnts, *pairwise_rank_bwd(*args, g_rows, 0.05)),
                (*pairwise_rank_fwd(*args, 0.05), *pairwise_rank_bwd(*args, g_rows, 0.05))))
            log(f"kernels: K4 K4b {tag} repeat bit-identical {same} "
                f"{'OK' if same else 'FAIL'}")
            rep.ok &= same
        small = 2 * N * 4 * 3 + (4 * h + 1) * 4
        rep.check("K4", f"fwd {tag}", [("sums", rows, rows_p, "float32"),
                                       ("counts", cnts, cnts_p, "float32")],
                  lambda: pairwise_rank_fwd(*args, 0.05),
                  lambda: pairwise_rank_sums_plain(*args, 0.05),
                  nbytes=2 * N * h * 4 + small, ops=10.0 * h * n_pairs, dtype="float32",
                  iters=30, designated=designated)
        # the gradients through the autograd.Function, against the twin's
        ins = [t.detach().clone().requires_grad_(True) for t in args[:6]]
        (pairwise_ranking_sums(*ins, depths, valid, 0.05)[0] * g_rows).sum().backward()
        refs = pairwise_rank_bwd_plain(*args, g_rows, 0.05)
        names = ("du", "dbias", "dln_s", "dln_b", "dw_out", "db_out")
        rep.check("K4b", f"bwd {tag}",
                  [(n, t.grad, r, "float32") for n, t, r in zip(names, ins, refs)],
                  lambda: pairwise_rank_bwd(*args, g_rows, 0.05),
                  lambda: pairwise_rank_bwd_plain(*args, g_rows, 0.05),
                  nbytes=4 * N * h * 4 + small, ops=50.0 * h * n_pairs, dtype="float32",
                  iters=30, designated=designated)

    # K5 forward and backward (-f0) on the (B, H, N, D) views the models pass
    def vggt_pos(B):
        pos = grid_positions(37, 37, B, device=dev) + 1
        return torch.cat([torch.zeros((B, 5, 2), dtype=pos.dtype, device=dev), pos], 1)

    rope_cases = [
        ("VGGT frame attention", 2, 1374, 16, bf16, vggt_pos(2)),
        ("VGGT global attention", 1, 2748, 16, bf16, vggt_pos(2).reshape(1, 2748, 2)),
        ("CroCo encoder", 2, 672, 16, f32, grid_positions(21, 32, 2, device=dev)),
        ("CroCo decoder", 2, 672, 12, f32, grid_positions(21, 32, 2, device=dev)),
    ]
    for where, B, N, H, dt, pos in rope_cases:
        x = torch.randn((B, N, 3, H, 64), generator=g, device=dev).to(dt)[:, :, 0]
        xt = x.transpose(1, 2)
        dname, elt = str(dt).split(".")[-1], x.element_size()
        for direction, f0 in (("fwd", 1.0), ("bwd", -1.0)):
            rep.check(
                "K5", f"{direction} {where} (B,N,H,D)=({B},{N},{H},64) {dname}",
                [("out", rope2d_fwd(xt, pos, 100.0, f0), rope2d_plain(xt, pos, 100.0, f0),
                  dname)],
                lambda: rope2d_fwd(xt, pos, 100.0, f0),
                lambda: rope2d_plain(xt, pos, 100.0, f0),
                nbytes=2 * B * N * H * 64 * elt + B * N * 2 * 8, ops=3.0 * B * N * H * 64,
                dtype=dname, iters=50)

    # K5 on q and k in one launch, as every attention layer calls it: q and k
    # as the main paths hand them over, (B, H, N, D) views of (B, N, 3, H, D)
    # projections (CroCo self attention), of q_norm/k_norm outputs (VGGT), of
    # separate projections (CroCo cross attention, each side on its own
    # positions); the decoder runs one pair (B = 1) per direction. Every K5
    # launch of both main paths is such a pair, and the teachers are frozen,
    # so the forward pair at the VGGT frame shape fills K5's JSON entry
    grid = grid_positions(21, 32, 1, device=dev)
    grid_o = grid_positions(24, 32, 1, device=dev)  # objaverse's 384x512 frames
    pair_cases = [
        ("VGGT frame attention", 2, 1374, 16, bf16, "normed", vggt_pos(2), vggt_pos(2)),
        ("VGGT global attention", 1, 2748, 16, bf16, "normed", vggt_pos(2).reshape(1, 2748, 2),
         vggt_pos(2).reshape(1, 2748, 2)),
        ("CroCo encoder", 2, 672, 16, f32, "qkv", grid_positions(21, 32, 2, device=dev),
         grid_positions(21, 32, 2, device=dev)),
        ("CroCo decoder self", 1, 672, 12, f32, "qkv", grid, grid),
        ("CroCo decoder cross", 1, 672, 12, f32, "separate", grid, grid.clone()),
        ("objaverse CroCo encoder", 2, 768, 16, f32, "qkv", grid_positions(24, 32, 2, device=dev),
         grid_positions(24, 32, 2, device=dev)),
        ("objaverse CroCo decoder self", 1, 768, 12, f32, "qkv", grid_o, grid_o),
        ("objaverse CroCo decoder cross", 1, 768, 12, f32, "separate", grid_o, grid_o.clone()),
        ("CroCo encoder (bf16 teacher)", 2, 672, 16, bf16, "qkv",
         grid_positions(21, 32, 2, device=dev), grid_positions(21, 32, 2, device=dev)),
        ("CroCo decoder self (bf16 teacher)", 1, 672, 12, bf16, "qkv", grid, grid),
        ("CroCo decoder cross (bf16 teacher)", 1, 672, 12, bf16, "separate", grid,
         grid.clone()),
        # CroCo-Stereo / CroCo-Flow training, forward and (f0 < 0) backward
        *[case for task, (gh, gw) in STEREOFLOW_GRIDS.items() for case in (
            (f"{task} encoder", 4, gh * gw, 16, f32, "qkv", grid_positions(gh, gw, 4, device=dev),
             grid_positions(gh, gw, 4, device=dev)),
            (f"{task} decoder self", 2, gh * gw, 12, f32, "qkv",
             grid_positions(gh, gw, 2, device=dev), grid_positions(gh, gw, 2, device=dev)),
            (f"{task} decoder cross", 2, gh * gw, 12, f32, "separate",
             grid_positions(gh, gw, 2, device=dev), grid_positions(gh, gw, 2, device=dev)))],
    ]
    for where, B, N, H, dt, kind, qpos, kpos in pair_cases:
        rope_pair_case(rep, g, dev, where, B, N, H, dt, kind, qpos, kpos,
                       designated=where == "VGGT frame attention")
    if not rep.ok:
        raise AssertionError("a kernel disagrees with its plain version")
    missing = [k for k, r in rep.results.items() if r["ms"] is None]
    if missing:
        raise AssertionError(f"no designated case for {missing}")
    return rep.results


def mast3r_setup(dev, seed: int = 0, student_dtype: str = "bfloat16",
                 teacher_dtype: str = "float32", bf16_stream: bool = False):
    """Full-width student and MASt3R teacher with seeded random weights, on
    `dev` through the step builder, and one ScanNet++-geometry batch (as
    bench.py builds it). The student computes in `student_dtype`: bf16 as
    bench.py runs it, or fp32, the named config's own compute_dtype; the
    teacher's trunk in `teacher_dtype` (bench.py's bf16 envelope:
    bfloat16 with bf16_stream)."""
    import dataclasses

    import torch

    from gd3d_torch.core.config import DistillConfig
    from gd3d_torch.distill.mast3r_step import build_mast3r_train_step
    from gd3d_torch.distill.train_state import make_optimizer
    from gd3d_torch.models.mast3r import Mast3rConfig
    from gd3d_torch.models.student import Student, split_params
    from gd3d_torch.models.vit import init_params_
    from gd3d_torch.teachers.mast3r import Mast3rTeacher

    cfg = DistillConfig(teacher="mast3r", dataset="scannetpp", teacher_dtype=teacher_dtype)
    cfg = cfg.replace(student=dataclasses.replace(
        cfg.student, compute_dtype=student_dtype, bf16_stream=bf16_stream))
    student, teacher = Student(cfg.student), Mast3rTeacher(Mast3rConfig())
    trainable, frozen = split_params(student)
    step = build_mast3r_train_step(student, teacher, cfg,
                                   make_optimizer(cfg.train, trainable.values()),
                                   has_depth=False, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    init_params_(student, g)
    teacher.init_params(g)
    H, W = 336, 512
    batch = {
        "rgb_1": torch.rand((1, 512, 512, 3), generator=g, device=dev),
        "rgb_2": torch.rand((1, 512, 512, 3), generator=g, device=dev),
        "rgb_mast3r_1": torch.rand((1, H, W, 3), generator=g, device=dev) * 2 - 1,
        "rgb_mast3r_2": torch.rand((1, H, W, 3), generator=g, device=dev) * 2 - 1,
        "intrinsic": torch.tensor([[[256.0, 0, W / 2], [0, 256.0, H / 2], [0, 0, 1]]],
                                  device=dev),
    }
    teacher.face_forward(batch["rgb_mast3r_1"], batch["rgb_mast3r_2"])
    return step, student, teacher, trainable, frozen, batch


def vggt_setup(dev, seed: int = 1, student_dtype: str = "bfloat16", hw=(518, 518)):
    """The finetune_timm_vggt_scannetpp configuration at full width: the
    ViT-B/16 student in `student_dtype` (bf16 as bench.py runs it, fp32 the
    config's own) and the VGGT-1B teacher (bf16 aggregator weights, fp32
    heads), seeded random weights with the two pinned heads of
    bias_params_for_live_keypoints, on `dev` through the step builder; `hw`
    teacher frames (518^2 as bench.py's VGGT line; ScanNet++'s 350x518, where
    gd3d's aggregator runs in fp32) and 512^2 student frames."""
    import dataclasses

    import torch

    from gd3d_torch.core.config import vggt_scannetpp
    from gd3d_torch.distill.train_state import make_optimizer
    from gd3d_torch.distill.vggt_step import build_vggt_train_step
    from gd3d_torch.models.student import Student, split_params
    from gd3d_torch.models.vggt.config import VggtConfig
    from gd3d_torch.models.vit import init_params_
    from gd3d_torch.teachers.vggt import VggtTeacher, bias_params_for_live_keypoints

    cfg = vggt_scannetpp()
    cfg = cfg.replace(student=dataclasses.replace(cfg.student, compute_dtype=student_dtype))
    student, teacher = Student(cfg.student), VggtTeacher(VggtConfig())
    trainable, frozen = split_params(student)
    step = build_vggt_train_step(student, teacher, cfg,
                                 make_optimizer(cfg.train, trainable.values()), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    init_params_(student, g)
    teacher.init_params(g)
    bias_params_for_live_keypoints(teacher)
    batch = {
        "rgb_1": torch.rand((1, 512, 512, 3), generator=g, device=dev),
        "rgb_2": torch.rand((1, 512, 512, 3), generator=g, device=dev),
        "rgb_vggt": torch.rand((1, 2, *hw, 3), generator=g, device=dev),
    }
    teacher.spread_depth(batch["rgb_vggt"], dtype=cfg.teacher_dtype)
    return step, student, teacher, trainable, frozen, batch


def check_step_keypoints(name, args) -> None:
    """K4 on the operands the step itself gave it (N keypoint slots, few of
    them valid with random weights) against its plain twin. The sums of the
    valid keypoints' indices and depths say which keypoints the frozen
    teacher selected: a rounding difference in its fp32 kernels can flip a
    reciprocal match, and the step's losses then differ from another run's
    although every kernel agrees with its twin."""
    import torch

    from gd3d_torch.kernels.pairwise_rank import pairwise_rank_fwd, pairwise_rank_sums_plain

    *head, depths, valid, thr = args[:9]
    rows, cnts = pairwise_rank_fwd(*head, depths, valid, thr)
    rows_p, cnts_p = pairwise_rank_sums_plain(*head, depths, valid, thr)
    err, mag = max_err(rows, rows_p)
    ok = torch.equal(cnts, cnts_p) and err <= TOL["float32"] * max(1.0, mag)
    index_sum = int((valid * torch.arange(valid.shape[1], device=valid.device)).sum())
    log(f"steps: {name} K4 on the step's keypoints u={tuple(head[0].shape)}: "
        f"{int(valid.sum())} valid (index sum {index_sum}, depth sum "
        f"{float((depths * valid).sum()):.6f}), {int(cnts.sum())} pairs, mean pair loss "
        f"{float(rows.sum() / cnts.sum()):.6f}; sums err={err:.3e} "
        f"tol={TOL['float32'] * max(1.0, mag):.1e} counts equal "
        f"{torch.equal(cnts, cnts_p)} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: K4 disagrees with its plain twin on the step's keypoints")


def check_mast3r_teacher(teacher, batch) -> None:
    """The full-width frozen teacher once with K1 and once with K1's plain
    twin in its place: descriptors, point clouds and confidences within the
    fp32 tolerance. Also printed: whether the matched keypoints agree, and
    how many pixels of the depth map rasterised from the point cloud differ.
    That map is a z-buffer, so rounding moves points across pixel borders;
    with random weights this is what moves the depth losses between two
    revisions of an fp32 teacher kernel."""
    import torch

    from gd3d_torch.core.config import DistillConfig
    from gd3d_torch.distill.keypoints import filter_and_match_keypoints
    from gd3d_torch.kernels.flash_fwd import flash_attention_fwd_plain
    from gd3d_torch.ops import attention
    from gd3d_torch.ops.depth import post_process_depth
    from gd3d_torch.ops.geometry import point_cloud_to_depth

    images = batch["rgb_mast3r_1"], batch["rgb_mast3r_2"]
    H, W = images[0].shape[1:3]
    with_kernel = teacher.extract_features(*images, 1.0)
    kernel_fwd = attention.flash_attention_fwd
    attention.flash_attention_fwd = flash_attention_fwd_plain
    try:
        with_twin = teacher.extract_features(*images, 1.0)
    finally:
        attention.flash_attention_fwd = kernel_fwd
    ok, parts = True, []
    for key in ("desc_1", "desc_2", "pts3d_1", "pts3d_2", "conf_1", "conf_2"):
        err, mag = max_err(with_kernel[key], with_twin[key])
        ok &= err <= TOL["float32"] * max(1.0, mag)
        parts.append(f"{key} err={err:.3e} of {mag:.3e}")
    kcfg = DistillConfig(teacher="mast3r", dataset="scannetpp").keypoints

    def keypoints_and_depth(feats):
        kps = filter_and_match_keypoints(
            {k: feats[k][0] for k in ("desc_1", "desc_2", "conf_1", "conf_2")}, H, W,
            subsample=kcfg.nn_subsample, border=kcfg.border,
            min_conf_percent=kcfg.min_conf_percentile)
        depth = post_process_depth(point_cloud_to_depth(
            feats["pts3d_1"][0].reshape(-1, 3), batch["intrinsic"][0], W, H), kernel_size=3)
        return kps, depth

    (kps_k, depth_k), (kps_t, depth_t) = (keypoints_and_depth(f) for f in (with_kernel, with_twin))
    same_kps = all(torch.equal(a, b) for a, b in zip(kps_k, kps_t))
    moved = int(((depth_k - depth_t).abs() > 1e-3).sum())
    log(f"steps: MASt3R teacher with K1 against K1's plain twin (tol {TOL['float32']:g} of "
        f"the max): {' '.join(parts)} {'OK' if ok else 'FAIL'}; keypoints equal {same_kps}; "
        f"rasterised depth differs by more than 1e-3 at {moved} of {depth_k.numel()} pixels")
    if not ok:
        raise AssertionError("MASt3R: the teacher on K1 disagrees with the teacher on its twin")


def run_steps(name, setup, dev, n_steps: int, check_teacher=None, expect=()) -> dict:
    """n_steps steps of one path; `expect` holds (kernel, dtype, lengths,
    launches a step) that the flash kernels' counts by dtype and length must
    show."""
    import torch

    from gd3d_torch.kernels import launch_counts, launch_counts_by, reset_launch_counts
    from gd3d_torch.models import student as student_module

    t0 = time.perf_counter()
    step, student, teacher, trainable, frozen, batch = setup(dev)
    before_t = {k: p.detach().clone() for k, p in trainable.items()}
    before_f = {k: p.detach().clone() for k, p in frozen.items()}
    teacher_sum = sum(float(p.double().sum()) for p in teacher.parameters())
    log(f"steps: {name} set-up {time.perf_counter() - t0:.2f} s; student "
        f"{sum(p.numel() for p in student.parameters())} params "
        f"({sum(p.numel() for p in trainable.values())} trainable), teacher "
        f"{sum(p.numel() for p in teacher.parameters())} params")
    torch.cuda.synchronize()
    k4_entry, k4_args = student_module.pairwise_ranking_sums, []

    def keep_args(*args):  # the step's own K4 operands, for the check after it
        k4_args[:] = [a.detach().clone() if torch.is_tensor(a) else a for a in args]
        return k4_entry(*args)

    student_module.pairwise_ranking_sums = keep_args
    reset_launch_counts()
    for i in range(n_steps):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        m = step(batch, 1.0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        vals = {k: float(v) for k, v in m.items()}
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        log(f"steps: {name} step {i} " + " ".join(f"{k}={v:.6f}" for k, v in vals.items())
            + f" step_s={dt:.4f} peak_mem_gib={peak:.3f}")
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{name}: non-finite metrics at step {i}: {vals}")
        if vals["num_kps"] <= 0:
            raise AssertionError(f"{name}: no keypoints survived the filters")
        if vals["depth_loss"] <= 0 or vals["intra_depth_loss"] <= 0:
            raise AssertionError(f"{name}: a depth loss is 0 at step {i}: {vals}")
    student_module.pairwise_ranking_sums = k4_entry
    counts, counts_by = launch_counts(), launch_counts_by()
    check_step_keypoints(name, k4_args)
    if check_teacher is not None:
        check_teacher(teacher, batch)
    changed = [k for k, p in trainable.items() if not torch.equal(p, before_t[k])]
    moved = [k for k, p in frozen.items() if not torch.equal(p, before_f[k])]
    teacher_after = sum(float(p.double().sum()) for p in teacher.parameters())
    per_step = {k: n / n_steps for k, n in counts.items()}
    log(f"steps: {name} launches {counts} over {n_steps} steps, {per_step} a step; "
        f"trainable tensors changed {len(changed)}/"
        f"{len(trainable)}; frozen tensors changed {len(moved)}/{len(frozen)}; "
        f"teacher unchanged {teacher_after == teacher_sum}")
    unchanged = sorted(set(trainable) - set(changed))
    log(f"steps: {name} trainable tensors unchanged: {unchanged}")
    by_step = {k: {f"{dt} N={n}": c / n_steps for (dt, n), c in sorted(v.items())}
               for k, v in counts_by.items()}
    log(f"steps: {name} flash launches a step by dtype and length: {by_step}")
    for kern, dt, lengths, want in expect:
        got = sum(c for (d, n), c in counts_by[kern].items() if d == dt and n in lengths)
        log(f"steps: {name} {dt} {kern} at N in {lengths}: {got / n_steps:g} a step "
            f"(want {want}) {'OK' if got == want * n_steps else 'FAIL'}")
        if got != want * n_steps:
            raise AssertionError(f"{name}: {dt} {kern} launched {got} times in {n_steps} "
                                 f"steps, not {want} a step")
    # the depth head's depth_attention branch exists for checkpoint parity;
    # training calls the feature-only path (gd3d/models/vit.py:352-354)
    stuck = [k for k in unchanged if not k.startswith("depth_diff_head.depth_attention.")]
    if not changed or stuck:
        raise AssertionError(f"{name}: trainable parameters did not change: {stuck or 'all'}")
    if moved or teacher_after != teacher_sum:
        raise AssertionError(f"{name}: frozen parameters changed: {moved[:5]}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"{name}: a kernel of the path never launched: {counts}")
    profile_step(name, step, batch)
    return {**counts, "K2 bf16": sum(c for (d, _), c in counts_by["K2"].items()
                                     if d == "bfloat16")}


def profile_step(name, step, batch) -> float:
    """Device time by kernel over one step, and the device's idle share of
    the step's wall time (returned)."""
    return profile_call(name, lambda: step(batch, 1.0), "step")


def profile_call(name, fn, what: str) -> float:
    """profile_step for any call: device time by kernel over one call of
    `fn`, and the device's idle share of its wall time (returned)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only: a host op's device time repeats its kernels'
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    busy = []  # union of kernel intervals on the device timeline
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0:
            busy.append((e.time_range.start, e.time_range.end))
    busy.sort()
    covered, end = 0.0, -1.0
    for a, b in busy:
        if b > end:
            covered += b - max(a, end)
            end = b
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    idle = 1 - covered / 1e3 / wall_ms
    log(f"profile: {name} {what} wall {wall_ms:.2f} ms, kernel time {total:.2f} ms, device "
        f"busy {covered / 1e3:.2f} ms, idle share {idle:.3f}")
    # the 20 longest, and every hand-written kernel (namespace gd3d) after them
    for i, (kname, ms, count) in enumerate(rows):
        if i < 20 or "gd3d::" in kname:
            log(f"profile: {name} {ms:9.3f} ms {100 * ms / total:5.1f}% x{count:<5d} "
                f"{kname[:90]}")
    return idle


def _compare(name, dev, run_loss, loss_tol=1e-4, grad_tol=1e-3, grad_l2=False,
             why="fp32 sums in another order") -> None:
    """run_loss(device) -> (metrics, trainable grads); CPU plain path
    against the CUDA kernels. The gradient error is the worst tensor's max
    abs error over its max |grad|, or with grad_l2 the relative L2 error of
    all trainable gradients together."""
    (m_cpu, g_cpu), (m_gpu, g_gpu) = run_loss("cpu"), run_loss(dev)
    loss_err = max(abs(m_cpu[k] - m_gpu[k]) / max(1.0, abs(m_cpu[k])) for k in m_cpu)
    if grad_l2:
        num = sum(float((g_cpu[k] - g_gpu[k]).double().square().sum()) for k in g_cpu)
        den = sum(float(g_cpu[k].double().square().sum()) for k in g_cpu)
        grad_err = math.sqrt(num / den)
    else:
        grad_err = max(float((g_cpu[k] - g_gpu[k]).abs().max())
                       / max(1e-3, float(g_cpu[k].abs().max())) for k in g_cpu)
    ok = (m_cpu["num_kps"] == m_gpu["num_kps"] > 0 and loss_err <= loss_tol
          and grad_err <= grad_tol and g_cpu.keys() == g_gpu.keys())
    log(f"agree: {name} cpu {m_cpu}")
    log(f"agree: {name} gpu {m_gpu}")
    log(f"agree: {name} loss rel err {loss_err:.3e} (tol {loss_tol:g}), grad "
        f"{'rel L2' if grad_l2 else 'rel'} err {grad_err:.3e} (tol {grad_tol:g}, {why}) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the CUDA path disagrees with the CPU plain path")


def _run_loss(student, teacher, batch, loss_fn, device):
    from gd3d_torch.models.student import split_params

    student.to(device)
    teacher.to(device)
    trainable, _ = split_params(student)
    for p in trainable.values():
        p.grad = None
    loss, m = loss_fn({k: v.to(device) for k, v in batch.items()})
    loss.backward()
    return ({k: float(v.detach()) for k, v in m.items()},
            {k: p.grad.detach().cpu().clone() for k, p in trainable.items()
             if p.grad is not None})


def _small_student(cfg_cls, g):
    import torch

    from gd3d_torch.models.student import Student
    from gd3d_torch.models.vit import init_params_

    # head dim 64 and depth-head width 32, as the kernels take
    student = Student(cfg_cls(embed_dim=128, depth=8, num_heads=2, pretrain_img_size=32,
                              adapter_bottleneck=8, target_res=64, depth_head_hidden=32))
    init_params_(student, g)
    with torch.no_grad():
        for n, p in student.named_parameters():
            if ".lora_b_" in n:
                p.normal_(0.0, 0.05, generator=g)
    return student


def check_agreement(dev) -> None:
    """Small inputs: each step's losses and trainable gradients with the
    CUDA kernels against the CPU plain path on shared weights, in fp32, and
    the MASt3R student once more under its bf16 autocast."""
    import dataclasses

    import torch

    from gd3d_torch.core.config import DistillConfig, KeypointConfig, StudentConfig
    from gd3d_torch.core.config import vggt_scannetpp
    from gd3d_torch.distill.mast3r_step import mast3r_distill_loss
    from gd3d_torch.distill.vggt_step import vggt_distill_loss
    from gd3d_torch.models.croco import CrocoConfig
    from gd3d_torch.models.mast3r import Mast3rConfig
    from gd3d_torch.models.student import Student
    from gd3d_torch.models.vggt.config import VggtConfig
    from gd3d_torch.teachers.mast3r import Mast3rTeacher
    from gd3d_torch.teachers.vggt import VggtTeacher, bias_params_for_live_keypoints

    g = torch.Generator().manual_seed(7)
    student = _small_student(StudentConfig, g)
    cfg = DistillConfig(student=student.cfg, keypoints=KeypointConfig(nn_subsample=16))
    teacher = Mast3rTeacher(Mast3rConfig(
        croco=CrocoConfig(enc_embed_dim=128, enc_depth=2, enc_num_heads=2,
                          dec_embed_dim=128, dec_depth=2, dec_num_heads=2),
        local_feat_dim=6, dpt_feature_dim=32, dpt_last_dim=16))
    teacher.init_params(g)
    H, W = 64, 96
    batch = {
        "rgb_1": torch.rand((1, 128, 128, 3), generator=g),
        "rgb_2": torch.rand((1, 128, 128, 3), generator=g),
        "rgb_mast3r_1": torch.rand((1, H, W, 3), generator=g) * 2 - 1,
        "rgb_mast3r_2": torch.rand((1, H, W, 3), generator=g) * 2 - 1,
        "intrinsic": torch.tensor([[[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]]]),
    }
    teacher.face_forward(batch["rgb_mast3r_1"], batch["rgb_mast3r_2"])
    _compare("MASt3R", dev, lambda device: _run_loss(
        student, teacher, batch,
        lambda b: mast3r_distill_loss(student, teacher, cfg, b, 1.0, has_depth=False), device))

    # the same student on the same weights under the step's bf16 autocast:
    # the one composed check of the bf16 tensor-core K1 and K2. Both sides
    # round at the autocast points, but CPU and CUDA bf16 GEMMs, and the
    # kernels' bf16 P and dS against the twins' fp32 ones, put an ulp of
    # bf16 (2^-8) in other places. On this input a whole bf16 rounding
    # against fp32 moves the losses by 4.2e-4 relative and the gradients by
    # 2.5% relative L2 (CPU, plain path), so the tolerances are 5e-3 and 0.1.
    cfg16 = cfg.replace(student=dataclasses.replace(student.cfg, compute_dtype="bfloat16"))
    student16 = Student(cfg16.student)
    student16.load_state_dict(student.state_dict())
    _compare("MASt3R bf16 student", dev, lambda device: _run_loss(
        student16, teacher, batch,
        lambda b: mast3r_distill_loss(student16, teacher, cfg16, b, 1.0, has_depth=False),
        device), loss_tol=5e-3, grad_tol=0.1, grad_l2=True,
        why="bf16 rounded in other places")

    # VGGT: aggregator head dim 64 (K1, K5) and camera trunk head dim 128
    # (K1's D=128 variant); fp32 teacher, so both sides compare in fp32
    student = _small_student(StudentConfig, g)
    cfg = vggt_scannetpp().replace(student=student.cfg, teacher_dtype="float32",
                                   keypoints=KeypointConfig(nms_num=48, nms_min_distance=2))
    teacher = VggtTeacher(VggtConfig(
        img_size=56, embed_dim=128, depth=2, num_heads=2, dino_depth=2, dino_num_heads=2,
        camera_trunk_depth=1, camera_iterations=2, dpt_out_channels=(16, 16, 16, 16),
        dpt_hooks=(0, 0, 1, 1), track_features=16, track_iters=2, corr_levels=3,
        corr_radius=2, track_hidden_size=32, track_depth=2, num_virtual_tracks=4))
    teacher.init_params(g)
    bias_params_for_live_keypoints(teacher)
    batch = {
        "rgb_1": torch.rand((1, 96, 96, 3), generator=g),
        "rgb_2": torch.rand((1, 96, 96, 3), generator=g),
        "rgb_vggt": torch.rand((1, 2, 56, 56, 3), generator=g),
    }
    teacher.spread_depth(batch["rgb_vggt"])
    priority = torch.rand((1, 56 * 56), generator=g)
    _compare("VGGT", dev, lambda device: _run_loss(
        student, teacher, batch,
        lambda b: vggt_distill_loss(student, teacher, cfg, b, 1.0,
                                    priority=priority.to(device)), device))


def run_cli(name, argv, out, expect=(), kernels=(), may_stay=(), profile=True, exact=None,
            profile_epoch=False) -> dict:
    """One training run through gd3d_torch.cli.train (its parse_args, setup
    and train, the steps of its main), in this process, on the card, writing
    to `out`: the counts are set to 0 and the parameters copied after the
    run's set-up, just before its first step. Prints each step's record, the median step time
    and the peak memory; asserts finite metrics, the trainable tensors
    changed (but those whose names start with one of `may_stay`), the
    frozen and teacher ones not, every kernel of `kernels` launched, and
    the flash launches by dtype and length in `expect` ((kernel, dtype,
    lengths, launches a step)). Returns the launches, the step records and
    the run's final state (final_state). With `profile`, then one more group
    of the run's step under the profiler (profile_step). `may_stay`: name parts of trainable
    tensors that may stay unchanged, because the loss does not reach them
    (the depth head's depth_attention branch everywhere, the whole head in
    ME) or, in a run of one step from the init, because their gradient is
    zero there (LoRA A, while LoRA B starts at zero). `exact`: {kernel:
    launches a step} that must hold exactly. With `profile_epoch`, then one
    more epoch of the training loop itself under the profiler (its data
    workers, prefetch and steps: the device's idle share of the loop, in
    "idle"). The run's data workers stop at the end."""
    from gd3d_torch.cli import train

    t0 = time.perf_counter()
    run = train.setup(train.parse_args([*argv, "--output", str(out)]))
    try:
        return _run_cli(name, run, out, t0, expect, kernels, may_stay, profile, exact or {},
                        profile_epoch)
    finally:
        run.close()


def _run_cli(name, run, out, t0, expect, kernels, may_stay, profile, exact, profile_epoch):
    import statistics

    import torch

    from gd3d_torch.cli import train
    from gd3d_torch.data.loader import DeviceCopier
    from gd3d_torch.kernels import launch_counts, launch_counts_by, reset_launch_counts

    def teacher_sum(teacher):  # a sharded teacher's weights gathered first
        return sum(float(getattr(p, "full_tensor", lambda: p)().double().sum())
                   for p in teacher.parameters())

    snap = {"trainable": {k: p.detach().clone() for k, p in run.trainable.items()},
            "frozen": {k: p.detach().clone() for k, p in run.frozen.items()},
            "teacher": None if run.teacher is None else teacher_sum(run.teacher)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    train.train(run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, counts_by = launch_counts(), launch_counts_by()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    records = [r for r in records if r["epoch"] >= run.start_epoch]
    steps = [r for r in records if "step" in r]
    for r in steps:
        log(f"train: {name} epoch {r['epoch']} step {r['step']} " + " ".join(
            f"{k}={v:.6f}" for k, v in r.items() if k not in ("epoch", "step")))
    n = len(steps)
    finite = all(math.isfinite(v) for r in records for v in r.values())
    changed = [k for k, p in run.trainable.items() if not torch.equal(p, snap["trainable"][k])]
    stuck = [k for k in run.trainable if k not in changed and not any(m in k for m in may_stay)]
    moved = [k for k, p in run.frozen.items() if not torch.equal(p, snap["frozen"][k])]
    teacher_same = run.teacher is None or snap["teacher"] == teacher_sum(run.teacher)
    allowed = sorted(set(run.trainable) - set(changed) - set(stuck))
    log(f"train: {name} {n} steps in {wall:.2f} s with the set-up; median step_s "
        f"{statistics.median(r['time_s'] for r in steps):.4f}; peak_mem_gib {peak:.3f}; "
        f"metrics finite {finite}; trainable tensors changed {len(changed)}/"
        f"{len(run.trainable)} ({len(allowed)} unchanged, allowed by {may_stay}); frozen tensors changed {len(moved)}/{len(run.frozen)}; teacher "
        f"unchanged {teacher_same}")
    by_step = {k: {f"{dt} N={m}": c / n for (dt, m), c in sorted(v.items())}
               for k, v in counts_by.items()}
    log(f"train: {name} launches {counts} over {n} steps; flash launches a step by dtype "
        f"and length: {by_step}")
    ok = finite and bool(changed) and not stuck and not moved and teacher_same
    for kern, dt, lengths, want in expect:
        got = sum(c for (d, m), c in counts_by[kern].items() if d == dt and m in lengths)
        log(f"train: {name} {dt} {kern} at N in {lengths}: {got / n:g} a step (want {want}) "
            f"{'OK' if got == want * n else 'FAIL'}")
        ok &= got == want * n
    for kern, want in exact.items():
        log(f"train: {name} {kern} {counts[kern] / n:g} launches a step (want {want}) "
            f"{'OK' if counts[kern] == want * n else 'FAIL'}")
        ok &= counts[kern] == want * n
    silent = [k for k in kernels if counts[k] <= 0]
    if silent or not ok:
        raise AssertionError(f"train {name}: finite={finite} stuck={stuck[:5]} moved={moved[:5]} "
                             f"teacher unchanged={teacher_same} never launched={silent}")
    final = final_state(run)
    idle = None
    if profile:  # one more group of the run's step, on the next epoch's first batch
        _, batch = next(train.host_batches(run, run.epochs))
        idle = profile_step(name, run.run_step, DeviceCopier(run.device)(batch).ready())
    if profile_epoch:  # one more epoch of the loop, data workers and all
        run.start_epoch, run.epochs = run.epochs, run.epochs + 1
        idle = profile_call(name, lambda: train.train(run), "epoch")
    epochs = [r for r in records if "step" not in r]
    return {"counts": counts, "steps": steps, "final": final, "epochs": epochs, "idle": idle}


def final_state(run) -> dict:
    """A copy of what the run's restart state holds, as the run ends: the
    trainable tensors and the optimizer's state (AdamW's moments and step
    counts, the call counts, the accumulation buffer)."""
    import copy

    return {"trainable": {k: p.detach().clone() for k, p in run.trainable.items()},
            "optimizer": copy.deepcopy(run.optimizer.state_dict())}


def resume_errors(straight: dict, resumed: dict) -> tuple:
    """Two final_state()s -> ({kind: (||resumed - straight|| / ||straight||,
    the tensor with the largest such error, its error)} for the trainable
    tensors, the accumulation buffer and AdamW's exp_avg and exp_avg_sq,
    each over all its tensors; whether the step counts, AdamW's of every
    tensor and the optimizer's own, are equal)."""
    so, ro = straight["optimizer"], resumed["optimizer"]
    ss, rs = so["adamw"]["state"], ro["adamw"]["state"]
    names = list(straight["trainable"])  # the optimizer's parameter order

    def rel(pairs):
        num = den = 0.0
        worst = (None, 0.0)
        for name, a, b in pairs:
            d = float((a.double() - b.double()).square().sum())
            n = float(b.double().square().sum())
            num, den = num + d, den + n
            e = math.sqrt(d / n) if n else math.sqrt(d)
            worst = max(worst, (name, e), key=lambda w: w[1])
        return (math.sqrt(num / den) if den else math.sqrt(num), *worst)

    errs = {"trainable": rel((k, resumed["trainable"][k], p)
                             for k, p in straight["trainable"].items()),
            "acc": rel((names[i], a, b) for i, (a, b) in enumerate(zip(ro["acc"], so["acc"])))}
    for m in ("exp_avg", "exp_avg_sq"):
        errs[m] = rel((names[i], rs[i][m], ss[i][m]) for i in ss)
    counts = (so["calls"] == ro["calls"] and so["mini_step"] == ro["mini_step"]
              and ss.keys() == rs.keys()
              and all(float(ss[i]["step"]) == float(rs[i]["step"]) for i in ss))
    return errs, counts


def check_train(dev) -> dict:
    """The train phase: gd3d_torch.cli.train at full width on synthetic
    data, with the named configs' fp32 students and seeded random weights.
    (a) ME: two epochs of one step straight, and one epoch resumed to two,
    which must give the straight run's epoch-1 record and final state
    (resume_errors); (b) objaverse
    MASt3R, --dev --multistep 2 (one group of two steps, the batch's depth
    maps); (c) VGGT ScanNet++, --dev. Returns the launches of all runs, and
    the VGGT run's step records (the surface phase's plain run)."""
    import tempfile
    from pathlib import Path

    fp32 = "float32"
    me_expect = (("K1", fp32, (6401,), 24), ("K2", fp32, (6401,), 8))
    mast3r_expect = (("K1", fp32, (4801, 769), 20), ("K2", fp32, (4801, 769), 12),
                     ("K1", fp32, (768,), 48))
    vggt_expect = (("K1", fp32, (6401, 1370), 20), ("K2", fp32, (6401, 1370), 12))
    every = KERNELS
    total = {k: 0 for k in REPLACES}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        me = ["--config", "finetune_timm_me_objaverse", "--synthetic", "--steps-per-epoch", "1"]
        runs = [
            ("ME straight", [*me, "--epochs", "2"], root / "me_straight", me_expect, ("K1", "K2"),
             ("depth_diff_head.",), True),
            ("ME first epoch", [*me, "--epochs", "1"], root / "me_split", me_expect,
             ("K1", "K2"), ("depth_diff_head.", ".lora_a_"), False),
            ("ME resumed", [*me, "--epochs", "2", "--resume", str(root / "me_split" / "last")],
             root / "me_split", me_expect, ("K1", "K2"), ("depth_diff_head.",), False),
            ("objaverse MASt3R", ["--config", "finetune_timm_mast3r_objaverse", "--dev",
                                  "--multistep", "2"], root / "mast3r", mast3r_expect, every,
             ("depth_diff_head.depth_attention.",), True),
            ("VGGT", ["--config", "finetune_timm_vggt_scannetpp", "--dev"], root / "vggt",
             vggt_expect, every, ("depth_diff_head.depth_attention.",), True),
        ]
        results = {}
        for name, argv, out, expect, kernels, may_stay, profile in runs:
            results[name] = run_cli(name, argv, out, expect, kernels, may_stay, profile)
            for k, c in results[name]["counts"].items():
                total[k] += c
            log(f"phase: train {name} done")
    straight = [r for r in results["ME straight"]["steps"] if r["epoch"] == 1]
    resumed = results["ME resumed"]["steps"]
    keys = [k for k in straight[0] if k != "time_s"]
    same = [{k: r[k] for k in keys} for r in straight] == [{k: r[k] for k in keys}
                                                          for r in resumed]
    err = max(abs(a["loss"] - b["loss"]) / abs(a["loss"]) for a, b in zip(straight, resumed))
    log(f"train: ME epoch 1 resumed against straight: loss {resumed[0]['loss']!r} / "
        f"{straight[0]['loss']!r}, records equal {same}, loss rel err {err:.3e} (tol "
        f"{RESUME_TOL:g}) {'OK' if err <= RESUME_TOL else 'FAIL'}")
    errs, counts = resume_errors(results["ME straight"]["final"], results["ME resumed"]["final"])
    tols = {"trainable": RESUME_TOL, "acc": RESUME_TOL, "exp_avg": STATE_TOL,
            "exp_avg_sq": STATE_TOL}
    state_ok = counts and all(errs[k][0] <= tol for k, tol in tols.items())
    log(f"train: ME final state resumed against straight: step counts equal {counts}; rel err "
        + "; ".join(f"{k} {e:.3e} (tol {tols[k]:g}; worst {w} {we:.3e})"
                    for k, (e, w, we) in errs.items())
        + f" {'OK' if state_ok else 'FAIL'}")
    if err > RESUME_TOL or not state_ok:
        raise AssertionError("ME: the resumed run differs from the straight run")
    return total, results["VGGT"]["steps"]


# The eval phase. The CSV headers that gd3d's DataFrame.to_csv writes for its
# two tables (gd3d/eval/pck.py::semantic_transfer, gd3d/eval/tracking.py::tracking)
PCK_HEADER = ["categories", "PCK0.05", "PCK0.10", "PCK0.15", "Weighted PCK0.05",
              "Weighted PCK0.10", "Weighted PCK0.15"]
TRACKING_HEADER = (["video_idx", "occlusion_accuracy"]
                   + [f"{m}_{t}" for t in (1, 2, 4, 8, 16) for m in ("pts_within", "jaccard")]
                   + ["average_jaccard", "average_pts_within_thresh"])
# Card against CPU, eval features: the fp32 tolerance of the kernels,
# TOL["float32"] * max(1, max |feature|), after 12 ViT-B blocks whose fp32 sums
# run in another order (cuBLAS against the CPU's GEMMs, K1 against its twin).
# The tracker on identical features, card against CPU: a soft argmax is a
# weighted mean over 5985 patch centres (x < 848); fp32 sums in another order
# move it by ~1e-3 px, and a near-tie of the hard argmax (a different
# radius-35 mask) by pixels. At least TRACK_SHARE of the points within
# TRACK_PX, and at most 1 - TRACK_SHARE of the occlusion flags differing.
TRACK_PX, TRACK_SHARE = 0.01, 0.99


def testdata_dir():
    from pathlib import Path

    return Path(__file__).resolve().parent / "gd3d_torch" / "eval" / "testdata"


def check_codec() -> dict:
    """The committed JPEG fixtures decoded by gd3d_torch/data/jpeg.py and
    resized by gd3d_torch/data/resample.py, to the SHA-256 digests PIL gave
    (testdata/digests.json, written and checked by tests/test_torch_jpeg.py),
    the progressive file among them. Returns the decoded images by name."""
    import hashlib
    import statistics

    import numpy as np

    from gd3d_torch.data.jpeg import decode_jpeg
    from gd3d_torch.data.resample import resize_lanczos

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    root = testdata_dir()
    digests = json.loads((root / "digests.json").read_text())["files"]
    images, ok = {}, True
    decode_ms, resize_ms = {}, {}
    for name, entry in sorted(digests.items()):
        t0 = time.perf_counter()
        img = decode_jpeg(root / name)
        decode_ms[name] = (time.perf_counter() - t0) * 1e3
        same = list(img.shape) == entry["shape"] and sha(img) == entry["rgb"]
        for size, digest in entry["lanczos"].items():
            w, h = map(int, size.split("x"))
            t0 = time.perf_counter()
            out = resize_lanczos(img, (w, h))
            resize_ms[f"{name} -> {size}"] = (time.perf_counter() - t0) * 1e3
            same &= sha(out) == digest
        log(f"eval: codec {name} {img.shape[1]}x{img.shape[0]} decode and Lanczos "
            f"{list(entry['lanczos'])} equal PIL's digests {same} {'OK' if same else 'FAIL'}")
        ok &= same
        images[name] = img
    frames = [v for k, v in decode_ms.items() if k.startswith("frame_")]
    frame_resize = [v for k, v in resize_ms.items() if k.startswith("frame_")]
    pascal_resize = [v for k, v in resize_ms.items() if k.startswith("pascal_")]
    log(f"eval: codec host ms per 854x480 4:2:0 decode (median of {len(frames)}) "
        f"{statistics.median(frames):.1f}; per 500x375 decode "
        f"{statistics.median(v for k, v in decode_ms.items() if k.startswith('pascal_')):.1f}; "
        f"per Lanczos 854x480 -> 848x464 {statistics.median(frame_resize):.1f}; per "
        f"500x375 -> 640x480 {statistics.median(pascal_resize):.1f}")
    if not ok:
        raise AssertionError("eval: the JPEG decoder or the Lanczos resize disagrees with PIL")
    return images


def check_eval_kernels(dev) -> None:
    """K1 (fp32) at the eval's two shapes against its plain twin, in the
    kernels phase's format: the PCK batch (8 canvases of 640^2, 1 + 40^2
    tokens) and the tracking batch (4 frames of 464x848 at stride 8, 1 + 57 *
    105 tokens)."""
    import torch
    import torch.nn.functional as F

    from gd3d_torch.kernels.flash_fwd import flash_attention_fwd, flash_attention_fwd_plain

    g = torch.Generator(device=dev).manual_seed(4321)
    rep = KernelReport()
    for where, B, N in (("PCK canvas batch", 8, 1601), ("tracking frame batch", 4, 5986)):
        H, D = 12, 64
        qkv = torch.randn((B, N, 3, H, D), generator=g, device=dev)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        scale = D ** -0.5
        o, lse = flash_attention_fwd(q, k, v, scale)
        o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, scale)
        rep.check("K1", f"eval {where} B={B} N={N} H={H} D={D} float32",
                  [("o", o, o_ref, "float32"), ("lse", lse, lse_ref, "float32")],
                  lambda: flash_attention_fwd(q, k, v, scale),
                  lambda: flash_attention_fwd_plain(q, k, v, scale),
                  nbytes=4 * B * N * H * D * 4 + B * H * N * 4, ops=4.0 * B * H * N * N * D,
                  dtype="float32", iters=10,
                  run_library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        del qkv, q, k, v, o, o_ref, lse, lse_ref
    if not rep.ok:
        raise AssertionError("eval: K1 disagrees with its plain twin at an eval shape")


def eval_student(dev):
    """The full-width ViT-B/16 student in fp32 with the CLI's seeded
    weights, as gd3d_torch.cli.evaluate builds it for the default matcher."""
    from gd3d_torch.cli import evaluate

    return evaluate.build_student(evaluate.parse_args(["--device", str(dev)]), dev)


def check_eval_agreement(dev, images) -> None:
    """Card against CPU plain path on shared weights: dense_grid_features at
    stride 8 on a 232x424 frame and at stride 16 on a 640^2 canvas; then
    infer_tracks on identical features (the four fixture frames' features
    from the card, copied to the CPU) with strided queries."""
    import copy

    import numpy as np
    import torch

    from gd3d_torch.data.resample import resize_lanczos
    from gd3d_torch.eval.images import resize_to_canvas
    from gd3d_torch.eval.tracker import TrackerConfig, infer_tracks
    from gd3d_torch.eval.tracking import video_features
    from gd3d_torch.teachers.mast3r import no_tf32

    student = eval_student(dev)
    cpu_student = copy.deepcopy(student).cpu()
    frames = np.stack([resize_lanczos(images[f"frame_{i}.jpg"], (848, 464)) for i in range(4)])
    small = resize_lanczos(images["frame_0.jpg"], (424, 232))  # the CPU twin's cost at stride 8
    canvas = resize_to_canvas(images["pascal_444.jpg"], 640)
    ok = True
    with no_tf32(), torch.no_grad():
        for what, img, stride in (("232x424 frame, stride 8", small, 8),
                                  ("640^2 canvas, stride 16", canvas, 16)):
            x = torch.from_numpy(img[None]).float() / 255.0
            t0 = time.perf_counter()
            want = cpu_student.dense_grid_features(x, stride=stride)
            cpu_s = time.perf_counter() - t0
            got = student.dense_grid_features(x.to(dev), stride=stride).cpu()
            err, mag = max_err(got, want)
            tol = TOL["float32"] * max(1.0, mag)
            line_ok = got.shape == want.shape and err <= tol
            ok &= line_ok
            log(f"eval: agree dense_grid_features {what} {tuple(got.shape)}: max err "
                f"{err:.3e} of max {mag:.3e} (tol {tol:.1e}; CPU {cpu_s:.1f} s) "
                f"{'OK' if line_ok else 'FAIL'}")
        feats = video_features(student, frames)
        cfg = TrackerConfig()
        ys, xs = np.meshgrid(np.arange(40, 440, 80), np.arange(40, 820, 130), indexing="ij")
        q = np.stack([xs.ravel(), ys.ravel(), (np.arange(xs.size) % 2) * 2],
                     1).astype(np.float32)  # queries in frames 0 and 2
        q_t = torch.from_numpy(q)
        t_gpu, o_gpu = infer_tracks(feats, q_t, cfg)
        t_cpu, o_cpu = infer_tracks(feats.cpu(), q_t, cfg)
    diff = (t_gpu.cpu() - t_cpu).abs().amax(-1)
    within = float((diff <= TRACK_PX).float().mean())
    flips = int((o_gpu.cpu() != o_cpu).sum())
    track_ok = within >= TRACK_SHARE and flips <= (1 - TRACK_SHARE) * o_cpu.numel()
    log(f"eval: agree infer_tracks on the card's features of 4 frames, {len(q)} queries: "
        f"max coordinate difference {float(diff.max()):.3e} px, median "
        f"{float(diff.median()):.3e} px, {within:.4f} of the points within {TRACK_PX:g} px "
        f"(want >= {TRACK_SHARE}); occlusion flags differing {flips} of {o_cpu.numel()} "
        f"(occluded on the CPU {int(o_cpu.sum())}) {'OK' if track_ok else 'FAIL'}")
    if not (ok and track_ok):
        raise AssertionError("eval: the card disagrees with the CPU plain path")


# The DAVIS tree's videos: (frames, query points a query frame as a grid of
# cols x rows, query frames every QUERY_STRIDE-th). Videos 0 and 1 are short;
# video 2 has a real DAVIS video's length (~70 frames) and strided queries
# every 5th frame as TAP-Vid's strided mode samples them, so its (T, T)
# anchor maps outgrow MAP_BYTES and the tracker runs them in chunks.
EVAL_VIDEOS = ((12, (4, 3)), (12, (4, 3)), (70, (6, 4)))
QUERY_STRIDE = 5


def write_eval_trees(root, images_dir):
    """A PF-PASCAL tree (the five 500x375 fixtures; 2 categories x 8 pairs
    with 10 keypoints each, in the vendored CSV format) and a DAVIS tree
    (the EVAL_VIDEOS, cycling through the four shifted fixture frames,
    forwards in videos 0 and 2, backwards in video 1; a strided benchmark
    pkl whose ground truth is the frames' known shifts)."""
    import pickle
    import shutil

    import numpy as np

    rng = np.random.RandomState(0)
    pdir = root / "PF-dataset-PASCAL" / "JPEGImages"
    pdir.mkdir(parents=True)
    names = sorted(p.name for p in images_dir.glob("pascal_*.jpg"))
    for n in names:
        shutil.copy(images_dir / n, pdir / n)

    def coords():
        return (";".join(f"{v:.6f}" for v in rng.uniform(5, 495, 10)),
                ";".join(f"{v:.6f}" for v in rng.uniform(5, 370, 10)))

    rows = []
    for cls in (1, 2):  # aeroplane, bicycle: PASCAL_CATEGORIES[:2]
        for i in range(8):
            a, b = names[i % len(names)], names[(i + 1 + cls) % len(names)]
            rows.append([f"PF-dataset-PASCAL/JPEGImages/{a}", f"PF-dataset-PASCAL/JPEGImages/{b}",
                         str(cls), *coords(), *coords()])
    lines = ["source_image,target_image,class,XA,YA,XB,YB"] + [",".join(r) for r in rows]
    for view in ("same", "different"):
        (root / "PF-dataset-PASCAL" / f"test_pairs_pf_{view}_views.csv").write_text(
            "\n".join(lines) + "\n")

    shifts = json.loads((images_dir / "digests.json").read_text())["frame_shifts"]
    videos = []
    for vid, (T, (cols, rows)) in enumerate(EVAL_VIDEOS):
        order = [3 - t % 4 if vid == 1 else t % 4 for t in range(T)]
        vdir = root / "davis_480" / str(vid) / "video"
        vdir.mkdir(parents=True)
        for t, f in enumerate(order):
            shutil.copy(images_dir / f"frame_{f}.jpg", vdir / f"{t:05d}.jpg")
        pts = np.stack(np.meshgrid(np.linspace(100, 750, cols), np.linspace(80, 400, rows)),
                       -1).reshape(-1, 2)
        qp, tp, occ = {}, {}, {}
        for qf in range(0, T, QUERY_STRIDE):
            s_q = np.asarray(shifts[order[qf]], np.float64)
            qp[qf] = pts.tolist()
            tp[qf] = np.stack([pts + s_q - np.asarray(shifts[order[t]]) for t in range(T)], 1)
            occ[qf] = np.zeros((len(pts), T), bool)
        videos.append({"video_idx": vid, "h": 480, "w": 854, "query_points": qp,
                       "target_points": tp, "occluded": occ})
    with open(root / "tapvid_davis_data_strided.pkl", "wb") as f:
        pickle.dump({"videos": videos}, f)


def check_eval_cli(dev) -> dict:
    """gd3d_torch.cli.evaluate.main in this process, on the card, at full
    width (the ViT-B/16 fp32 student, seeded weights, refine conv): --transfer
    and --tracking on the fabricated trees. Counts set to 0 just before the
    run and read just after: 24 fp32 K1 launches at N = 1601 a batch of 8
    pairs and 12 at N = 5986 a batch of 4 frames, and no other launch; the
    anchor stage's chunks counted as they run, equal to what MAP_BYTES
    gives, more than one a query frame in the 70-frame video. Then one
    70-frame video's tracking_single under the profiler. Returns the run's
    launches."""
    import csv as csvlib
    import math
    import pickle
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from gd3d_torch.cli import evaluate
    from gd3d_torch.eval import tracker
    from gd3d_torch.eval.images import eval_workers, make_pool
    from gd3d_torch.eval.tracking import tracking_single
    from gd3d_torch.kernels import launch_counts, launch_counts_by, reset_launch_counts

    anchor_chunks = []  # queries in each chunk of anchor maps, (n, T, T, gh, gw)
    soft_argmax = tracker._soft_argmax_batch

    def counted_soft_argmax(corr, cfg):
        if corr.dim() == 5:
            anchor_chunks.append(corr.shape[0])
        return soft_argmax(corr, cfg)

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_eval_trees(root / "data", testdata_dir())
        argv = ["--transfer", "--tracking", "--num-cats", "2",
                "--num-videos", str(len(EVAL_VIDEOS)),
                "--data-root", str(root / "data"), "--out", str(root / "out")]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tracker._soft_argmax_batch = counted_soft_argmax
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            res = evaluate.main(argv)
            torch.cuda.synchronize()
        finally:
            tracker._soft_argmax_batch = soft_argmax
        wall = time.perf_counter() - t0
        counts, counts_by = launch_counts(), launch_counts_by()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        headers_ok, finite = True, True
        for name, want in (("semantic_transfer.csv", PCK_HEADER), ("tracking.csv", TRACKING_HEADER)):
            rows = list(csvlib.reader(open(res["out_dir"] / name)))
            headers_ok &= rows[0] == want
            finite &= all(np.isfinite(float(v)) for r in rows[1:] for v in r[1:])
            for r in rows:
                log(f"eval: cli {name}: {','.join(r)}")
        with open(root / "data" / "tapvid_davis_data_strided.pkl", "rb") as f:
            bench = pickle.load(f)
        st, tr = res["stats"]["semantic_transfer"], res["stats"]["tracking"]
        pck_batches = 2  # one batch of 8 pairs a category
        track_batches = sum(-(-T // 4) for T, _ in EVAL_VIDEOS)
        k1 = counts_by["K1"]
        want = {("float32", 1601): 24 * pck_batches, ("float32", 5986): 12 * track_batches}
        launches_ok = k1 == want and all(n == 0 for k, n in counts.items() if k != "K1")
        want_chunks, long_chunks = 0, []
        for (T, _), video in zip(EVAL_VIDEOS, bench["videos"]):
            step = tracker._chunk(T * T, 57, 105)
            for q in video["query_points"].values():
                want_chunks += math.ceil(len(q) / step)
                if T == max(t for t, _ in EVAL_VIDEOS):
                    long_chunks.append(math.ceil(len(q) / step))
        chunks_ok = len(anchor_chunks) == want_chunks and min(long_chunks) > 1
        log(f"eval: cli wall {wall:.2f} s with the set-up; semantic transfer {st['pairs']} pairs "
            f"in {st['wall_s']:.2f} s ({st['pairs'] / st['wall_s']:.2f} pairs/s, decode "
            f"{st['decode_s']:.2f} s = {st['decode_s'] / st['wall_s']:.3f} of it); tracking "
            f"{tr['frames']} frames in {tr['wall_s']:.2f} s ({tr['frames'] / tr['wall_s']:.2f} "
            f"frames/s, decode {tr['decode_s']:.2f} s = {tr['decode_s'] / tr['wall_s']:.3f} of "
            f"it); {eval_workers(False)} decode processes, one pool for the run; "
            f"peak_mem_gib {peak:.3f}")
        for v in tr["videos"]:
            log(f"eval: cli video {v['video_idx']}: {v['frames']} frames, {v['queries']} "
                f"queries, wall {v['wall_s']:.3f} s ({v['frames'] / v['wall_s']:.2f} frames/s): "
                f"decode {v['decode_s']:.3f} s, features {v['features_s']:.3f} s (device "
                f"synchronized), tracker {v['tracker_s']:.3f} s, metrics and rest "
                f"{v['wall_s'] - v['decode_s'] - v['features_s'] - v['tracker_s']:.3f} s")
        log(f"eval: cli anchor chunks {len(anchor_chunks)} (want {want_chunks}; the "
            f"{max(t for t, _ in EVAL_VIDEOS)}-frame video {sum(long_chunks)} in "
            f"{len(long_chunks)} query frames; queries a chunk {sorted(set(anchor_chunks))}) "
            f"{'OK' if chunks_ok else 'FAIL'}")
        log(f"eval: cli headers equal gd3d's {headers_ok}, values finite {finite}; launches "
            f"{counts}; K1 by dtype and length {k1} (want {want}) "
            f"{'OK' if headers_ok and finite and launches_ok else 'FAIL'}")
        if not (headers_ok and finite and launches_ok and chunks_ok):
            raise AssertionError("eval: the CLI run's tables, launch counts or anchor "
                                 "chunks are wrong")
        # the long video once more under the profiler (outside the counted run),
        # its decode pool started before
        student = eval_student(dev)
        long_vid = len(EVAL_VIDEOS) - 1
        with make_pool(eval_workers(False)) as pool:
            list(pool.map(abs, range(eval_workers(False))))
            profile_call("eval tracking_single", lambda: tracking_single(
                student, long_vid, bench, str(root / "data" / "davis_480"), pool=pool),
                f"{EVAL_VIDEOS[long_vid][0]}-frame video")
    return counts


def check_eval(dev) -> dict:
    """The eval phase: codec, K1 at the eval shapes, card against CPU (these
    two without TF32, as the kernels and agree phases), the entry point.
    Returns the entry point's launches."""
    import torch

    from gd3d_torch.teachers.mast3r import no_tf32

    images = check_codec()
    with no_tf32():
        check_eval_kernels(dev)
        torch.cuda.empty_cache()
        check_eval_agreement(dev, images)
    torch.cuda.empty_cache()
    return check_eval_cli(dev)


# The data phase. Launches a step of the named configs' fp32-student steps on
# real-format data: the student's flash kernels at its lengths, the teacher's
# K1 at its own, and K3-K5 once or more a step.
SCANNETPP_EXACT = {"K3": 2, "K4": 1, "K4b": 1, "K5": 72}


def stage_seconds() -> dict:
    """One worker's host seconds a pair by stage, in this process: a
    ScanNet++ pair (the 1752x1168 fixture twice: decode, the square and
    MASt3R resizes, the colour augmentations, the uint8 packing and
    collation) and an Objaverse ME pair (colour, depth and mask PNGs of two
    views: decode, keypoint lift and pad, augmentations)."""
    import numpy as np

    from gd3d_torch.data import augment, exif, fixtures, images, objaverse, pipeline, png
    from gd3d_torch.data.resample import resize_bicubic

    rng = np.random.RandomState(0)
    t = {}

    def timed(stage, fn):
        t0 = time.perf_counter()
        out = fn()
        t[stage] = t.get(stage, 0.0) + time.perf_counter() - t0
        return out

    sample = {}
    for v in ("1", "2"):
        data = timed("read", lambda: images.read_bytes(fixtures.TESTDATA / "dslr.jpg"))
        raw = timed("decode", lambda: images.decode_rgb(data))
        square = timed("resize", lambda: (resize_bicubic(raw, (512, 512)) / 255.0)
                       .astype(np.float32))
        m = timed("resize", lambda: images.load_image_mast3r(
            exif.transpose(raw, images.file_orientation(data)), 512))
        sample[f"rgb_{v}"] = timed("augment", lambda: (augment.color_augs_scannetpp(
            (square * 255).astype(np.uint8), rng) / 255.0).astype(np.float32))
        sample[f"rgb_mast3r_{v}"] = m["img"]
    timed("pack", lambda: pipeline.collate([pipeline.pack_u8(sample)]))
    scannetpp = dict(t)
    t.clear()
    for v in range(2):
        kinds = {k: fixtures.TESTDATA / f"render_{v}_{k}.png" for k in ("color", "depth", "mask")}
        dec = {k: timed("decode", lambda p=p: png.decode_png(p)) for k, p in kinds.items()}
        rgb = png.cv2_view(dec["color"])[..., ::-1].copy()
        depth = png.cv2_view(dec["depth"], png.IMREAD_ANYDEPTH).astype(np.float64) / 1000.0
        mask = png.cv2_view(dec["mask"], png.IMREAD_GRAYSCALE)
        kp = timed("keypoints", lambda: np.stack(np.where(mask > 0), -1)[:, ::-1][
            rng.choice(int((mask > 0).sum()), 3000)])
        timed("keypoints", lambda: pipeline.pad_keypoints(
            kp.astype(np.float32), objaverse.img_coord_2_obj_coord(
                kp, depth, objaverse.OBJAVERSE_INTRINSIC, fixtures.objaverse_poses()[v]), 3000))
        timed("augment", lambda: augment.color_augs_objaverse(augment.shift_scale_rotate(
            rgb, kp.astype(np.float32), mask > 0, rng, p=1.0)[0], rng, p=1.0))
    return {"scannetpp": scannetpp, "objaverse_me": dict(t)}


def check_data(dev) -> dict:
    """The data phase: the port's readers on real-format data. (a) the PNG,
    JPEG, loader and augmentation fixtures against the committed digests of
    cv2's, PIL's and gd3d's outputs, and one worker's host seconds a pair
    by stage; (b) the default config, finetune_timm_mast3r_scannetpp with its
    fp32 student, through the CLI on a fabricated ScanNet++ tree of the
    1752x1168 fixture with --workers min(8, CPUs), 4 steps: its launches a
    step exactly, the steady step time, epoch/host_wait_s over epoch/wall_s,
    and the device's idle share over one more epoch of the loop under the
    profiler; (c) finetune_timm_me_objaverse (2 steps) and
    finetune_timm_vggt_objaverse (2 steps: load_images_vggt) on a
    fabricated Objaverse tree with the same workers; (d) the first two
    host batches at --workers 0 of the three configs against gd3d's
    committed digests, and at --workers W against --workers 1. Returns the
    launches of (b) and (c)."""
    import os
    import statistics
    import tempfile
    from pathlib import Path

    import torch

    from gd3d_torch.data import fixtures

    gpu = gpu_line()
    workers = min(8, os.cpu_count() or 1)
    ref = json.loads((fixtures.TESTDATA / "digests.json").read_text())
    t0 = time.perf_counter()
    got = fixtures.port_digests(("png", "jpeg", "loaders", "augment"))
    ok = True
    for section, records in got.items():
        bad = fixtures.mismatches(records, ref[section])
        log(f"data: {section} fixtures ({len(records)}) equal the committed digests of cv2's, "
            f"PIL's and gd3d's outputs: {not bad} {'OK' if not bad else 'FAIL ' + str(bad[:4])}")
        ok &= not bad
    log(f"data: fixtures checked in {time.perf_counter() - t0:.2f} s")
    stages = stage_seconds()
    for kind, by_stage in stages.items():
        log(f"data: one worker's host s a pair, {kind}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in by_stage.items())
            + f"; total {sum(by_stage.values()):.3f} ({os.cpu_count()} CPUs; {gpu})")
    if not ok:
        raise AssertionError("data: a reader disagrees with its committed digests")

    fp32 = "float32"
    every = KERNELS
    total = {k: 0 for k in REPLACES}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        fixtures.write_scannetpp_tree(root)
        fixtures.write_objaverse_tree(root)
        real = ["--data-root", str(root), "--epochs", "1", "--workers", str(workers)]
        runs = [
            ("data ScanNet++ MASt3R", ["--config", "finetune_timm_mast3r_scannetpp",
                                       "--steps-per-epoch", "4", *real],
             (("K1", fp32, (4161, 673), 20), ("K2", fp32, (4161, 673), 12),
              ("K1", fp32, (672,), 48)), every, SCANNETPP_EXACT, True),
            ("data Objaverse ME", ["--config", "finetune_timm_me_objaverse",
                                   "--steps-per-epoch", "2", *real],
             (("K1", fp32, (6401,), 24), ("K2", fp32, (6401,), 8)), ("K1", "K2"), {}, False),
            ("data Objaverse VGGT", ["--config", "finetune_timm_vggt_objaverse",
                                     "--steps-per-epoch", "2", *real],
             (("K1", fp32, (6401, 1370), 20), ("K2", fp32, (6401, 1370), 12)), every, {},
             False),
        ]
        for name, argv, expect, kernels, exact, window in runs:
            may_stay = ("depth_diff_head.",) if "ME" in name else (
                "depth_diff_head.depth_attention.",)
            res = run_cli(name, argv, Path(tmp) / name.split()[-1], expect, kernels, may_stay,
                          profile=False, exact=exact, profile_epoch=window)
            for k, c in res["counts"].items():
                total[k] += c
            steady = [r["time_s"] for r in res["steps"][1:]] or [res["steps"][0]["time_s"]]
            ep = res["epochs"][0]
            log(f"data: {name} --workers {workers}: steady step_s (median after the first) "
                f"{statistics.median(steady):.4f}; host wait {ep['epoch/host_wait_s']:.3f} s of "
                f"the epoch's {ep['epoch/wall_s']:.3f} s (share "
                f"{ep['epoch/host_wait_s'] / ep['epoch/wall_s']:.3f})"
                + (f"; profiled idle share of one more epoch {res['idle']:.3f}"
                   if res["idle"] is not None else "") + f" ({gpu})")
            torch.cuda.empty_cache()
            log(f"phase: {name} done")

    t0 = time.perf_counter()
    seq = fixtures.port_digests(("batches",), workers=0)["batches"]
    bad = fixtures.mismatches(seq, ref["batches"])
    log(f"data: first two host batches at --workers 0 of {sorted(seq)} equal gd3d's committed "
        f"digests: {not bad} {'OK' if not bad else 'FAIL ' + str(bad[:4])}")
    one = fixtures.port_digests(("batches",), workers=1)["batches"]
    many = fixtures.port_digests(("batches",), workers=workers)["batches"]
    same = not fixtures.mismatches(many, one)
    log(f"data: first two host batches at --workers {workers} equal those at --workers 1: "
        f"{same} {'OK' if same else 'FAIL'} ({time.perf_counter() - t0:.2f} s)")
    if bad or not same:
        raise AssertionError("data: the host batches differ from gd3d's or across workers")
    return total


# The pose phase. OnePose-LowTexture at full width on a fabricated tree
# (gd3d_torch/data/fixtures.py::write_onepose_tree): a known-answer object
# and a template bank of 40 frames x 3200 keypoints (128 000 rows, sampled to
# gd3d's cap of 120 000); every frame 512^2, resized to 1024^2, so the fp32
# K1 runs at N = 1 + 64^2 = 4097, 12 launches a frame.
POSE_TREE = dict(size=(512, 512), known_kps=2000, bank_frames=40, bank_kps=3200, bank_tests=1)
POSE_N = 4097
# FiT3D's compare runs --pose twice (two students): on a smaller tree of the
# same kind, for the script's time (the --pose run keeps POSE_TREE)
FIT3D_TREE = dict(size=(512, 512), known_kps=2000, bank_frames=4, bank_kps=3200, bank_tests=1)
# recorded PnP scenes left out here for the script's time: the slowest on
# the host (cv2's RANSAC runs 2500-10000 iterations there), beyond scenes 14
# and 32, which keep two 10000-iteration calls; tests/test_torch_pnp.py holds
# every scene on the CPU
PNP_SKIP = (22, 23, 25, 26, 30, 31)
# Tracks of the DUSt3R tracker on K1 and K5 against the same tracker on their
# plain twins (random teacher weights): an argmin over a 336x512 map of
# distances whose near-equal minima fp32 sums in another order may swap.
TRACK_EQUAL_SHARE = 0.75


def pose_frames(tree: dict) -> int:
    """The frames whose descriptors a --pose run computes on the tree: the
    templates and the test frames of both objects."""
    return 1 + 2 + tree["bank_frames"] + tree["bank_tests"]


def check_pnp_records() -> None:
    """(a) gd3d_torch/eval/pnp.py against cv2 5.0.0's answers, recorded by
    tests/test_torch_pnp.py (the card's machine has no cv2): the same retval
    and inlier set, rvec and tvec within 1e-6 of their norm, and solve_pose's
    4x4 (on the port's own RANSAC answer) within 1e-6 of gd3d's."""
    import numpy as np

    from gd3d_torch.eval import pnp

    rec = np.load(testdata_dir() / "pnp_cv2.npz")
    K = rec["K"]
    scenes = sorted(int(k[1:].split("_")[0]) for k in rec.files
                    if k.endswith("_pts") and int(k[1:].split("_")[0]) not in PNP_SKIP)
    ok, total_s, lines = True, 0.0, []

    def close(got, want):
        got, want = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
        return float(np.abs(got - want).max() / max(np.linalg.norm(want), 1e-12))

    for i in scenes:
        pts, img = rec[f"s{i}_pts"], rec[f"s{i}_img"]
        want_pose = rec[f"s{i}_pose"]
        if len(pts) == 4:  # cv2's P3P: refused; solve_pose's identity
            try:
                pnp.solve_pnp_ransac(pts * 1000.0, img, K)
                refused = False
            except NotImplementedError:
                refused = True
            good = refused and np.array_equal(pnp.solve_pose(img, pts, K), want_pose)
            log(f"pose: pnp scene {i} n=4: P3P refused {refused}, solve_pose the identity "
                f"{'OK' if good else 'FAIL'}")
            ok &= good
            continue
        stats = {}
        t0 = time.perf_counter()
        answer = pnp.solve_pnp_ransac(pts * 1000.0, img.reshape(-1, 1, 2), K, 8.0, 10000,
                                      stats=stats)
        ms = (time.perf_counter() - t0) * 1e3
        total_s += ms / 1e3
        got_ok, rvec, tvec, inliers = answer
        inl = np.zeros((0, 1), np.int32) if inliers is None else inliers
        same = got_ok == bool(rec[f"s{i}_ok"]) and np.array_equal(inl, rec[f"s{i}_inliers"])
        r_err = close(rvec, rec[f"s{i}_rvec"]) if got_ok else 0.0
        t_err = close(tvec, rec[f"s{i}_tvec"]) if got_ok else 0.0
        solve = pnp.solve_pnp_ransac
        pnp.solve_pnp_ransac = lambda *a, **k: answer  # solve_pose on this answer
        try:
            pose = pnp.solve_pose(img, pts, K)
        finally:
            pnp.solve_pnp_ransac = solve
        p_err = max(close(pose[:3, :3], want_pose[:3, :3]), close(pose[:3, 3], want_pose[:3, 3]))
        good = same and max(r_err, t_err, p_err) <= 1e-6
        ok &= good
        lines.append((ms, stats["iterations"]))
        log(f"pose: pnp scene {i} n={len(pts)}: retval {got_ok} inliers {len(inl)} equal "
            f"{same}; rvec {r_err:.1e} tvec {t_err:.1e} pose {p_err:.1e} of the norm; "
            f"{stats['iterations']} iterations ({stats['hypotheses']} hypotheses computed), "
            f"host {ms:.1f} ms {'OK' if good else 'FAIL'}")
    full = [ms for ms, it in lines if it == 10000]
    log(f"pose: pnp {len(scenes)} scenes, host {total_s:.2f} s in all; a 10000-iteration "
        f"RANSAC {np.median(full):.0f} ms (median of {len(full)}); iterations "
        f"{sorted(it for _, it in lines)}")
    if not ok:
        raise AssertionError("pose: the port's PnP RANSAC disagrees with cv2's records")


def check_pose_kernels(dev) -> None:
    """(b) K1 (fp32) at the pose descriptors' shape against its plain twin,
    in the kernels phase's format: one 512^2 frame resized to 1024^2."""
    import torch
    import torch.nn.functional as F

    from gd3d_torch.kernels.flash_fwd import flash_attention_fwd, flash_attention_fwd_plain

    g = torch.Generator(device=dev).manual_seed(4097)
    rep = KernelReport()
    B, N, H, D = 1, POSE_N, 12, 64
    qkv = torch.randn((B, N, 3, H, D), generator=g, device=dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    scale = D ** -0.5
    o, lse = flash_attention_fwd(q, k, v, scale)
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, scale)
    rep.check("K1", f"pose frame B={B} N={N} H={H} D={D} float32",
              [("o", o, o_ref, "float32"), ("lse", lse, lse_ref, "float32")],
              lambda: flash_attention_fwd(q, k, v, scale),
              lambda: flash_attention_fwd_plain(q, k, v, scale),
              nbytes=4 * B * N * H * D * 4 + B * H * N * 4, ops=4.0 * B * H * N * N * D,
              dtype="float32", iters=20,
              run_library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
    if not rep.ok:
        raise AssertionError("pose: K1 disagrees with its plain twin at the pose shape")


def check_pose_agreement(dev) -> None:
    """(b) The card against the CPU plain path on shared weights (the CLI's
    seeded ViT-B/16 fp32 student, refine conv): frame_descriptors of a 512^2
    frame at its 16384 grid keypoints (TOL), the float64 resize on the card
    bit for bit the host's; then mutual_nn_match on identical descriptors
    (the CPU's queries against 8000 bank rows) on both, with equal indices."""
    import copy

    import numpy as np
    import torch

    from gd3d_torch.data.fixtures import texture
    from gd3d_torch.data.resample import resize_linear_cv
    from gd3d_torch.eval.onepose import frame_descriptors, grid_keypoints, mutual_nn_match

    student = eval_student(dev)
    cpu_student = copy.deepcopy(student).cpu()
    rng = np.random.RandomState(5)
    rgb, bank_rgb = texture(rng, 512, 512), texture(rng, 512, 512)
    kp = grid_keypoints(512, 512)
    img = rgb.astype(np.float64) / 255.0
    resized = resize_linear_cv(torch.from_numpy(img).to(dev), (1024, 1024)).cpu().numpy()
    same_resize = np.array_equal(resized, resize_linear_cv(img, (1024, 1024)))
    t0 = time.perf_counter()
    want = frame_descriptors(cpu_student, rgb, kp)
    cpu_s = time.perf_counter() - t0
    got = frame_descriptors(student, rgb, kp).cpu()
    err, mag = max_err(got, want)
    tol = TOL["float32"] * max(1.0, mag)
    desc_ok = got.shape == want.shape == (16384, 768) and err <= tol
    log(f"pose: agree 1024^2 resize on the card equal to the host's {same_resize}; "
        f"frame_descriptors 512^2 frame {tuple(got.shape)}: max err {err:.3e} of max {mag:.3e} "
        f"(tol {tol:.1e}; CPU {cpu_s:.1f} s) {'OK' if desc_ok and same_resize else 'FAIL'}")
    bank_kp = rng.uniform(0, 511, (8000, 2))
    bank = frame_descriptors(student, bank_rgb, bank_kp).cpu()  # the card's, copied
    t0 = time.perf_counter()
    nn_cpu = mutual_nn_match(want, bank)
    cpu_s = time.perf_counter() - t0
    nn_gpu = mutual_nn_match(want.to(dev), bank.to(dev))
    nn_ok = np.array_equal(nn_gpu, nn_cpu)
    log(f"pose: agree mutual_nn_match 16384 queries x 8000 bank rows on identical "
        f"descriptors: equal indices {nn_ok} ({int((nn_gpu != nn_cpu).sum())} differ; "
        f"{int((nn_cpu >= 0).sum())} mutual on the CPU; CPU {cpu_s:.1f} s) "
        f"{'OK' if nn_ok else 'FAIL'}")
    if not (desc_ok and same_resize and nn_ok):
        raise AssertionError("pose: the card disagrees with the CPU plain path")


def _counted_run(fn):
    """fn() with the launch counts set to 0 just before and read just after;
    returns (fn's result, counts, counts by dtype and length, wall s, peak GiB)."""
    import torch

    from gd3d_torch.kernels import launch_counts, launch_counts_by, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (res, launch_counts(), launch_counts_by(), wall,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def check_pose_cli(dev, root) -> dict:
    """(c) gd3d_torch.cli.evaluate.main(["--pose", ...]) in this process on
    the card at full width (ViT-B/16 fp32, seeded weights, refine conv) on
    the fabricated tree: gd3d's header, the known answer at 1.0 on every
    threshold, finite values, exactly 12 fp32 K1 launches at N = 4097 a
    frame and no other launch. Returns the run's launches."""
    import csv as csvlib

    import numpy as np

    from gd3d_torch.cli import evaluate
    from gd3d_torch.data.fixtures import ONEPOSE_KNOWN

    argv = ["--pose", "--data-root", str(root / "data"), "--out", str(root / "out")]
    res, counts, counts_by, wall, peak = _counted_run(lambda: evaluate.main(argv))
    rows = list(csvlib.reader(open(res["out_dir"] / "pose_estimation.csv")))
    for r in rows:
        log(f"pose: cli pose_estimation.csv: {','.join(r)}")
    header_ok = rows[0] == ["objs", "threshold_1", "threshold_3", "threshold_5"]
    known_ok = rows[1] == [ONEPOSE_KNOWN, "1.0", "1.0", "1.0"]
    finite = all(np.isfinite(float(v)) for r in rows[1:] for v in r[1:])
    frames = pose_frames(POSE_TREE)
    want = {("float32", POSE_N): 12 * frames}
    launches_ok = (counts_by["K1"] == want
                   and all(n == 0 for k, n in counts.items() if k != "K1"))
    st = res["stats"]["pose"]
    tests = st["frames_detail"]
    log(f"pose: cli wall {wall:.2f} s with the set-up; {frames} frames ({st['templates']} "
        f"templates, {st['frames']} test frames, {st['template_rows']} template rows after the "
        f"cap) in {st['wall_s']:.2f} s = {frames / st['wall_s']:.2f} frames/s; decode "
        f"{st['decode_s']:.2f} s, template bank {st['bank_s']:.2f} s "
        f"({st['bank_s'] / st['templates']:.3f} s a template frame); peak_mem_gib {peak:.3f}")
    for j, f in enumerate(tests):
        log(f"pose: cli test frame {j}: {f['matches']} mutual matches, descriptors "
            f"{f['descriptors_s']:.3f} s (device synchronized), NN {f['nn_s']:.3f} s, PnP "
            f"{f['pnp_s']:.3f} s ({f['ransac_iterations']} RANSAC iterations, best "
            f"{f['inliers']} inliers)")
    log(f"pose: cli header equal gd3d's {header_ok}, known answer 1.0 {known_ok}, finite "
        f"{finite}; launches {counts}; K1 by dtype and length {counts_by['K1']} (want {want}) "
        f"{'OK' if header_ok and known_ok and finite and launches_ok else 'FAIL'}")
    if not (header_ok and known_ok and finite and launches_ok):
        raise AssertionError("pose: the --pose run's table or launch counts are wrong")
    return counts


def check_fit3d(dev, root) -> dict:
    """(d) gd3d_torch.eval.fit3d.compare with the CLI's seeded vanilla
    student saved as a local .pth (the 'vanilla' column, with no checkpoint,
    is the same seeded init), run_pose=True on the tree: the keys
    pose/fit3d and pose/vanilla, equal tables, refine=False in every
    descriptor pass (the refine conv never called), 12 fp32 K1 at N = 4097
    a frame of each model. Returns the run's launches."""
    import torch

    from gd3d_torch.eval import fit3d
    from gd3d_torch.models.student import Student

    ckpt = root / "vanilla_seeded.pth"
    torch.save(fit3d.load_fit3d_student(None, device=dev).vit.state_dict(), ckpt)
    refines = []
    apply_refine = Student.apply_refine

    def spy(self, grid):
        refines.append(grid.shape)
        return apply_refine(self, grid)

    Student.apply_refine = spy
    try:
        res, counts, counts_by, wall, peak = _counted_run(lambda: fit3d.compare(
            str(ckpt), None, str(root / "fit3d_data"), run_transfer=False, run_pose=True,
            device=dev))
    finally:
        Student.apply_refine = apply_refine
    keys_ok = list(res) == ["pose/fit3d", "pose/vanilla"]
    same = keys_ok and (res["pose/fit3d"].columns == res["pose/vanilla"].columns)
    want = {("float32", POSE_N): 2 * 12 * pose_frames(FIT3D_TREE)}
    launches_ok = (counts_by["K1"] == want
                   and all(n == 0 for k, n in counts.items() if k != "K1"))
    for name, table in res.items():
        log(f"pose: fit3d {name}: {table.columns}")
    good = keys_ok and same and not refines and launches_ok
    log(f"pose: fit3d compare keys {list(res)}, tables equal {same}, refine conv calls "
        f"{len(refines)} (want 0); wall {wall:.2f} s, peak_mem_gib {peak:.3f}; K1 "
        f"{counts_by['K1']} (want {want}) {'OK' if good else 'FAIL'}")
    if not good:
        raise AssertionError("pose: the FiT3D harness's tables, refine or launches are wrong")
    return counts


def check_dust3r_tracker(dev) -> dict:
    """(e) Dust3rTracker on the full-width MASt3R teacher (seeded weights,
    face_forward on the frames) over 4 frames of 336x512 with 8 queries
    from frame 0: 4 pair forwards, each 48 fp32 K1 at N = 672 and 72 K5
    launches; then the same tracker with K1 and K5's plain twins in their
    place, on the card: the share of equal positions, at least
    TRACK_EQUAL_SHARE. Returns the kernels run's launches."""
    import numpy as np
    import torch

    from gd3d_torch.data.fixtures import texture
    from gd3d_torch.eval.dust3r_tracker import Dust3rTracker
    from gd3d_torch.kernels import rope2d as krope
    from gd3d_torch.kernels.flash_fwd import flash_attention_fwd_plain
    from gd3d_torch.ops import attention
    from gd3d_torch.teachers.mast3r import Mast3rTeacher

    rng = np.random.RandomState(7)
    frames = np.stack([texture(rng, 336, 512) for _ in range(4)]).astype(np.float32) / 255.0
    with torch.device(dev):
        teacher = Mast3rTeacher()
    teacher.init_params(torch.Generator(device=dev).manual_seed(7))
    teacher.eval()
    x = torch.from_numpy(frames * 2.0 - 1.0).to(dev)
    teacher.face_forward(x[:1], x[1:2])
    q = np.column_stack([rng.randint(0, 512, 8), rng.randint(0, 336, 8),
                         np.zeros(8)]).astype(np.float32)
    tracker = Dust3rTracker(teacher)
    tracks, counts, counts_by, wall, peak = _counted_run(lambda: tracker.track(frames, q))
    pairs = 4
    want_k1 = {("float32", 672): 48 * pairs}
    launches_ok = (counts_by["K1"] == want_k1 and counts["K5"] == 72 * pairs
                   and all(n == 0 for k, n in counts.items() if k not in ("K1", "K5")))
    kernel_fwd, qk_fwd, one_fwd = attention.flash_attention_fwd, krope.rope2d_qk_fwd, krope.rope2d_fwd
    attention.flash_attention_fwd = flash_attention_fwd_plain
    krope.rope2d_qk_fwd = lambda q_, qp, k_, kp, base=100.0, f0=1.0: (
        krope.rope2d_plain(q_, qp, base, f0), krope.rope2d_plain(k_, kp, base, f0))
    krope.rope2d_fwd = krope.rope2d_plain
    try:
        twin = Dust3rTracker(teacher).track(frames, q)
    finally:
        attention.flash_attention_fwd = kernel_fwd
        krope.rope2d_qk_fwd, krope.rope2d_fwd = qk_fwd, one_fwd
    equal = float((tracks == twin).all(-1).mean())
    inside = bool((tracks[..., 0] < 512).all() and (tracks[..., 1] < 336).all()
                  and (tracks >= 0).all())
    good = launches_ok and inside and equal >= TRACK_EQUAL_SHARE
    log(f"pose: dust3r tracker 4 frames of 336x512, 8 queries: wall {wall:.2f} s "
        f"({pairs} pair forwards, {wall / pairs:.3f} s a pair with the argmins), peak_mem_gib "
        f"{peak:.3f}; launches {counts}, K1 {counts_by['K1']} (want {want_k1}, and 72 K5 a "
        f"pair); positions inside the frame {inside}; tracks on K1 and K5 equal to the plain "
        f"twins' at {equal:.3f} of the positions (want >= {TRACK_EQUAL_SHARE}) "
        f"{'OK' if good else 'FAIL'}")
    if not good:
        raise AssertionError("pose: the DUSt3R tracker's launches or tracks are wrong")
    return counts


def check_pose(dev) -> dict:
    """The pose phase: (a) PnP against cv2's records, (b) K1 at the pose
    shape and the card against the CPU, (c) the --pose entry point, (d) the
    FiT3D harness, (e) the DUSt3R tracker. (b) and (e)'s twin run without
    TF32. Returns the launches of (c), (d) and (e)'s kernel runs."""
    import tempfile
    from pathlib import Path

    import torch

    from gd3d_torch.data.fixtures import write_onepose_tree
    from gd3d_torch.teachers.mast3r import no_tf32

    t0 = time.perf_counter()
    check_pnp_records()
    log(f"pose: (a) done in {time.perf_counter() - t0:.1f} s")
    with no_tf32():
        check_pose_kernels(dev)
        check_pose_agreement(dev)
    torch.cuda.empty_cache()
    log(f"pose: (b) done at {time.perf_counter() - t0:.1f} s")
    counts = {k: 0 for k in REPLACES}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t1 = time.perf_counter()
        write_onepose_tree(root / "data", **POSE_TREE)
        write_onepose_tree(root / "fit3d_data", **FIT3D_TREE)
        log(f"pose: wrote the OnePose trees in {time.perf_counter() - t1:.1f} s")
        for run in (check_pose_cli, check_fit3d):
            for k, n in run(dev, root).items():
                counts[k] += n
            torch.cuda.empty_cache()
            log(f"pose: ({'c' if run is check_pose_cli else 'd'}) done at "
                f"{time.perf_counter() - t0:.1f} s")
    for k, n in check_dust3r_tracker(dev).items():
        counts[k] += n
    log(f"pose: (e) done at {time.perf_counter() - t0:.1f} s")
    return counts


# The surface phase. The bf16 MASt3R teacher against the fp32 one on the
# card, per feature: max |diff| <= BF16_TEACHER_TOL * max(1, max |fp32|), the
# bound of the CPU lock against gd3d (tests/test_torch_mast3r_bf16.py): the
# trunk's weights and activations rounded to bf16 (2^-8 relative) through
# 24 + 12 layers.
BF16_TEACHER_TOL = 5e-2
# remat against the plain step (the default config, fp32 student): the same
# forward, so equal losses (relative error REMAT_TOL at most, bit-equality
# printed), and gradients within REMAT_TOL of each tensor's max |grad|: the
# recomputed blocks give the same operands, but the keypoint
# interpolation's backward scatter-adds with atomics, which may order its
# sums otherwise (as in the resume check, RESUME_TOL).
REMAT_TOL = 1e-5
SURFACE_FEATURES = ("desc_1", "desc_2", "pts3d_1", "pts3d_2_from_1", "pts3d_2", "conf_1",
                    "conf_2", "cost_1", "cost_2")


def check_bf16_teacher(teacher, batch) -> None:
    """The full-width MASt3R teacher with its trunk in bf16 against the same
    teacher in fp32, on the step's batch."""
    import torch

    images = batch["rgb_mast3r_1"], batch["rgb_mast3r_2"]
    bf16 = teacher.extract_features(*images, 1.0, dtype="bfloat16")
    fp32 = teacher.extract_features(*images, 1.0)
    ok, parts = True, []
    for key in SURFACE_FEATURES:
        err, mag = max_err(bf16[key], fp32[key])
        ok &= bf16[key].dtype == torch.float32 and err <= BF16_TEACHER_TOL * max(1.0, mag)
        parts.append(f"{key} err={err:.3e} of {mag:.3e}")
    log(f"surface: bf16 MASt3R teacher against fp32 (tol {BF16_TEACHER_TOL:g} of max(1, max)): "
        f"{' '.join(parts)} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("surface: the bf16 MASt3R teacher drifts from the fp32 one")


def check_remat(dev) -> dict:
    """The default-config MASt3R loss and backward (fp32 student, fp32
    teacher, full width) with StudentConfig.remat against the same student
    without it, on shared weights: losses, gradients, peak memory, seconds,
    and K1's launches at the student's lengths (remat recomputes a block's
    forward, K1 included, for each block that takes a backward: one more K1
    for each K2). Returns the launches of both runs."""
    import dataclasses

    import torch

    from gd3d_torch.core.config import DistillConfig
    from gd3d_torch.distill.mast3r_step import mast3r_distill_loss
    from gd3d_torch.kernels import launch_counts, launch_counts_by, reset_launch_counts
    from gd3d_torch.models.student import Student, split_params

    _, plain, teacher, _, _, batch = mast3r_setup(dev, student_dtype="float32")
    twin = Student(dataclasses.replace(plain.cfg, remat=True)).to(dev)
    twin.load_state_dict(plain.state_dict())
    split_params(twin)
    counts, out = {k: 0 for k in REPLACES}, {}
    for name, st in (("plain", plain), ("remat", twin)):
        cfg = DistillConfig(teacher="mast3r", dataset="scannetpp", student=st.cfg)
        st.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        loss, metrics = mast3r_distill_loss(st, teacher, cfg, batch, 1.0, has_depth=False)
        loss.backward()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        by = launch_counts_by()
        k1 = sum(c for (d, n), c in by["K1"].items() if d == "float32" and n in (4161, 673))
        k2 = sum(c for (d, n), c in by["K2"].items() if d == "float32" and n in (4161, 673))
        for k, c in launch_counts().items():
            counts[k] += c
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     {k: p.grad.detach().clone() for k, p in st.named_parameters()
                      if p.grad is not None},
                     torch.cuda.max_memory_allocated(dev) / 2 ** 30, secs, k1, k2)
        log(f"surface: default-config MASt3R loss + backward, {name}: "
            + " ".join(f"{k}={v:.6f}" for k, v in out[name][0].items())
            + f" peak_mem_gib={out[name][2]:.3f} s={secs:.4f} fp32 K1 at the student's "
            f"lengths {k1}, K2 {k2}")
    (m0, g0, *_, k1_0, k2_0), (m1, g1, *_, k1_1, _) = out["plain"], out["remat"]
    loss_err = max(abs(m1[k] - m0[k]) / max(abs(m0[k]), 1e-12) for k in m0)
    grad_err = max(max_err(g1[k], g0[k])[0] / max(float(g0[k].abs().max()), 1e-30)
                   for k in g0)
    ok = (g0.keys() == g1.keys() and len(g0) > 0 and loss_err <= REMAT_TOL
          and grad_err <= REMAT_TOL and k1_1 == k1_0 + k2_0)
    log(f"surface: remat against plain: losses bit-equal {m0 == m1}, worst loss rel err "
        f"{loss_err:.3e}, worst gradient err / max {grad_err:.3e} (tol {REMAT_TOL:g}) over "
        f"{len(g0)} tensors; peak_mem_gib {out['plain'][2]:.3f} -> {out['remat'][2]:.3f}; "
        f"fp32 K1 at the student's lengths {k1_0} -> {k1_1} (want + {k2_0}) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("surface: remat changes the default-config step")
    return counts


def check_multihost_cli(dev, plain_steps) -> dict:
    """gd3d_torch.cli.train --tensorboard --multihost --fsdp-teacher on
    finetune_timm_vggt_scannetpp --dev at world size 1 (the environment set
    here as torchrun would), against the train phase's plain run of the same
    batches (RESUME_TOL relative per loss; the same bits are expected), and
    its event file decoded with the port's reader (every CRC checked) against
    metrics.jsonl (each value as float32). Returns the run's launches."""
    import os
    import socket
    import tempfile
    from pathlib import Path

    import numpy as np

    from gd3d_torch.core.tensorboard import read_events

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "vggt"
            res = run_cli("VGGT --multihost --fsdp-teacher --tensorboard",
                          ["--config", "finetune_timm_vggt_scannetpp", "--dev", "--tensorboard",
                           "--multihost", "--fsdp-teacher"], out,
                          (("K1", "float32", (6401, 1370), 20), ("K2", "float32", (6401, 1370), 12)),
                          KERNELS, ("depth_diff_head.depth_attention.",), profile=False)
            (event_file,) = (out / "tb").glob("events.out.tfevents.*")
            version, scalars = read_events(event_file)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    want = sorted((r["epoch"] * 2 + r["step"], k, float(np.float32(v)))
                  for r in res["steps"] for k, v in r.items())
    events_ok = version == "brain.Event:2" and sorted(scalars) == want and len(want) > 0
    keys = ("loss", "ap_loss", "depth_loss", "intra_depth_loss", "kl_loss", "num_kps")
    errs = [abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
            for a, b in zip(res["steps"], plain_steps) for k in keys]
    same = len(res["steps"]) == len(plain_steps) == 2 and max(errs) <= RESUME_TOL
    log(f"surface: VGGT --multihost --fsdp-teacher (world 1) against the plain run: worst loss "
        f"rel err {max(errs):.3e} (tol {RESUME_TOL:g}); event file {event_file.name}: "
        f"{len(scalars)} scalars equal to metrics.jsonl {events_ok} "
        f"{'OK' if same and events_ok else 'FAIL'}")
    if not (same and events_ok):
        raise AssertionError("surface: the multihost run or its event file is wrong")
    return res["counts"]


def check_surface(dev, vggt_plain_steps) -> dict:
    """The surface phase: (a) two MASt3R steps in bench.py's bf16
    envelope (bf16 student with bf16_stream, bf16 teacher) with the bf16 K1
    and K5 launches at the CroCo shapes asserted and the bf16 teacher held to
    the fp32 one; (b) remat against the plain default-config step; (c) the
    train CLI with --tensorboard --multihost --fsdp-teacher at world size 1;
    (d) the finetune_timm_vggt_scannetpp step (fp32 student) on ScanNet++'s
    350x518 frames, whose teacher runs the fp32 K1 (gd3d's dtype route),
    asserted by launches. The new shapes' kernel rows are in the kernels
    phase. Returns the launches of every run."""
    import torch

    counts = {k: 0 for k in REPLACES}
    t0 = time.perf_counter()

    def add(more):
        for k, n in more.items():
            counts[k] += n
        torch.cuda.empty_cache()
        log(f"surface: done at {time.perf_counter() - t0:.1f} s")

    croco = (672,)
    add(run_steps("MASt3R bf16 envelope",
                  lambda d: mast3r_setup(d, teacher_dtype="bfloat16", bf16_stream=True), dev,
                  n_steps=2, check_teacher=check_bf16_teacher,
                  expect=(("K1", "bfloat16", croco, 48), ("K5", "bfloat16", croco, 72),
                          ("K1", "float32", croco, 0))))
    add(check_remat(dev))
    add(check_multihost_cli(dev, vggt_plain_steps))
    add(run_steps("VGGT ScanNet++ 350x518 fp32 student",
                  lambda d: vggt_setup(d, student_dtype="float32", hw=(350, 518)), dev,
                  n_steps=2, expect=(("K1", "float32", (930,), 48),
                                     ("K1", "float32", (1860,), 24),
                                     ("K1", "bfloat16", (930, 1860), 0))))
    return counts


# The align phase. gd3d's multi-view reconstruction at the align CLI's
# working size: 4:3 frames resized to 512 on the long side (384x512, N = 768
# CroCo tokens), 4 views, the complete graph of 12 ordered pairs. The known
# answer is gd3d's synthetic scene (tests/test_global_align.py's
# _make_scene: white-noise depths in [2, 3], camera k rotated 0.15 k rad about
# a random axis and moved (0.4, 0.1, 0.05) k) at that size, with a focal of
# ALIGN_FOCAL px and every ordered pair; gd3d's recovery bounds hold it:
# relative rotation and translation direction within ALIGN_DEG, the focal
# within ALIGN_FOCAL_RTOL. The card against the port's CPU run of the same
# scene with ALIGN_NOISE fp32 noise on every point, ALIGN_AGREE_ITERS steps
# of the same cosine schedule: the noiseless scene's tree init is exact and
# its first gradient fp32 rounding noise that Adam scales to full steps, so
# two correct runs part there (tests/test_torch_align.py); on the noisy one
# the losses agree within ALIGN_LOSS_TOL and the poses, focals, depths and
# points within ALIGN_OUT_TOL of their largest value, the bounds of that
# file's 150-step parity with gd3d.
ALIGN_HW = (384, 512)
ALIGN_VIEWS = 4
ALIGN_FOCAL = 400.0
ALIGN_DEG = 2.0
ALIGN_FOCAL_RTOL = 0.1
ALIGN_NOISE = 0.03
ALIGN_AGREE_ITERS = 20
ALIGN_LOSS_TOL = 1e-3
ALIGN_OUT_TOL = 1e-2
# the frames: 1440x1080 windows of the committed 1752x1168 DSLR JPEG,
# (x, y) offsets; 4 views and 2 localization queries between them
ALIGN_WINDOW = (1440, 1080)
ALIGN_VIEW_OFFSETS = ((0, 0), (104, 29), (208, 58), (312, 88))
ALIGN_QUERY_OFFSETS = ((52, 14), (260, 73))
# the teacher call of the dense CLI run: one extract_features over 12 pairs
ALIGN_TEACHER_LAUNCHES = {"K1": {("float32", 768): 48}, "K5": 72}


def align_scene(device, noise: float = 0.0, seed: int = 0):
    """gd3d's _make_scene at ALIGN_HW with every ordered pair (see above):
    (Scene on `device`, gt cam2world poses, gt depths)."""
    import numpy as np

    from gd3d_torch.align import Scene

    H, W = ALIGN_HW
    n = ALIGN_VIEWS
    rng = np.random.RandomState(seed)
    depths = 2.0 + rng.rand(n, H, W)
    poses = np.tile(np.eye(4), (n, 1, 1))
    for k in range(n):
        axis = rng.randn(3)
        axis = axis / np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        a = 0.15 * k
        poses[k, :3, :3] = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
        poses[k, :3, 3] = [0.4 * k, 0.1 * k, 0.05 * k]
    ys, xs = np.mgrid[0:H, 0:W]
    pts = np.stack([(xs - W / 2) / ALIGN_FOCAL * depths, (ys - H / 2) / ALIGN_FOCAL * depths,
                    depths], -1).reshape(n, -1, 3)
    edges, pred_i, pred_j = [], [], []
    for i in range(n):
        for j in range(n):
            if i != j:
                rel = np.linalg.inv(poses[i]) @ poses[j]  # frame j -> frame i
                edges.append((i, j))
                pred_i.append(pts[i].astype(np.float32))
                pred_j.append((pts[j] @ rel[:3, :3].T + rel[:3, 3]).astype(np.float32))
    if noise:
        pred_i = [p + (noise * rng.randn(*p.shape)).astype(np.float32) for p in pred_i]
        pred_j = [p + (noise * rng.randn(*p.shape)).astype(np.float32) for p in pred_j]
    conf = [np.full(H * W, 3.0, np.float32)] * len(edges)
    shape = lambda ps: [p.reshape(H, W, 3) for p in ps]  # noqa: E731
    scene = Scene.from_pairs(edges, shape(pred_i), shape(pred_j),
                             [c.reshape(H, W) for c in conf], [c.reshape(H, W) for c in conf],
                             device=device)
    return scene, poses, depths


def rel_pose_errors(got, gt):
    """gd3d's _rel_pose_errors: the worst rotation and translation-direction
    error (degrees) over consecutive relative poses, gauge-free."""
    import numpy as np

    rot, direc = [], []
    for k in range(len(gt) - 1):
        rel_got = np.linalg.inv(got[k]) @ got[k + 1]
        rel_gt = np.linalg.inv(gt[k]) @ gt[k + 1]
        Rg = rel_got[:3, :3] / np.cbrt(max(np.linalg.det(rel_got[:3, :3]), 1e-12))
        dR = Rg @ rel_gt[:3, :3].T
        rot.append(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))
        tg, tt = rel_got[:3, 3], rel_gt[:3, 3]
        cos = tg @ tt / max(np.linalg.norm(tg) * np.linalg.norm(tt), 1e-12)
        direc.append(np.degrees(np.arccos(np.clip(cos, -1, 1))))
    return max(rot), max(direc)


def check_align_known(dev, gpu: str) -> None:
    """(a) global_align on the card (300 steps, cosine) recovers the
    synthetic scene; the alignment loop profiled once more; (b) the card
    against the CPU on the noisy scene."""
    import numpy as np
    import torch

    from gd3d_torch.align import global_align

    t0 = time.perf_counter()
    scene, gt_poses, gt_depths = align_scene(dev)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = global_align(scene, niter=300)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    poses = out["poses"].double().cpu().numpy()
    rot, direc = rel_pose_errors(poses, gt_poses)
    focal_err = float((out["focals"].cpu() / ALIGN_FOCAL - 1).abs().max())
    ratio = out["depthmaps"].double().cpu().numpy() / gt_depths
    spread = float(ratio.std() / ratio.mean())
    losses = out["losses"].cpu()
    finite = all(bool(torch.isfinite(v).all()) for v in out.values())
    ok = finite and rot < ALIGN_DEG and direc < ALIGN_DEG and focal_err < ALIGN_FOCAL_RTOL
    log(f"align: known answer {ALIGN_VIEWS} views of {ALIGN_HW[0]}x{ALIGN_HW[1]}, "
        f"{len(scene.edges)} ordered edges, {scene.pred_i.shape[1]} points a view (scene "
        f"built in {build_s:.2f} s): global_align 300 steps {wall:.3f} s "
        f"({wall * 1e3 / 300:.3f} ms a step with the tree init), peak_mem_gib "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f}; loss {float(losses[0]):.3e} -> "
        f"{float(losses[-1]):.3e}; relative rotation {rot:.4f} deg, translation direction "
        f"{direc:.4f} deg (want < {ALIGN_DEG}), focal error {focal_err:.4f} (want < "
        f"{ALIGN_FOCAL_RTOL}), depth ratio spread {spread:.4f}; finite {finite} "
        f"{'OK' if ok else 'FAIL'} [{gpu}]")
    if not ok:
        raise AssertionError("align: global_align did not recover the synthetic scene")
    idle = profile_call("align", lambda: global_align(scene, niter=50), "global_align 50 steps")
    log(f"align: the alignment loop's idle share {idle:.3f} [{gpu}]")
    del scene, out
    torch.cuda.empty_cache()

    cpu_scene, _, _ = align_scene("cpu", noise=ALIGN_NOISE, seed=1)
    t0 = time.perf_counter()
    want = global_align(cpu_scene, niter=ALIGN_AGREE_ITERS)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = global_align(cpu_scene.to(dev), niter=ALIGN_AGREE_ITERS)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    errs = {}
    for k in ("losses", "poses", "focals", "principal_points", "depthmaps", "pts3d"):
        g, w = got[k].cpu().double().numpy(), want[k].double().numpy()
        errs[k] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12))
    ok = all(math.isfinite(e) for e in errs.values()) and errs["losses"] <= ALIGN_LOSS_TOL and all(
        e <= ALIGN_OUT_TOL for k, e in errs.items() if k != "losses")
    log(f"align: card against CPU, the scene with {ALIGN_NOISE} noise, {ALIGN_AGREE_ITERS} "
        f"steps: " + " ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f" (tol losses {ALIGN_LOSS_TOL:g}, the rest {ALIGN_OUT_TOL:g} of the max); CPU "
        f"{cpu_s:.2f} s, card {card_s:.3f} s {'OK' if ok else 'FAIL'} [{gpu}]")
    if not ok:
        raise AssertionError("align: the card's alignment disagrees with the CPU's")


def write_align_frames(root):
    """The views and the queries: ALIGN_WINDOW crops of the committed DSLR
    JPEG as PNGs. Returns (view paths, query paths)."""
    import numpy as np

    from gd3d_torch.data.fixtures import TESTDATA
    from gd3d_torch.data.images import open_rgb
    from gd3d_torch.data.png import encode_png_rgb

    rgb = open_rgb(TESTDATA / "dslr.jpg")
    w, h = ALIGN_WINDOW

    def write(name, x, y):
        path = root / f"{name}.png"
        path.write_bytes(encode_png_rgb(np.ascontiguousarray(rgb[y:y + h, x:x + w])))
        return str(path)

    (root / "views").mkdir(parents=True)
    views = [write(f"views/view_{k}", x, y) for k, (x, y) in enumerate(ALIGN_VIEW_OFFSETS)]
    queries = [write(f"query_{k}", x, y) for k, (x, y) in enumerate(ALIGN_QUERY_OFFSETS)]
    return views, queries


def check_align_kernels(dev, teacher, images, gpu: str) -> None:
    """(c) the teacher call of the align path (all 12 ordered pairs in one
    extract_features): K1 and K5 on the operands that call hands them, one
    launch of each shape, against their plain twins in the kernels phase's
    format; then the same call with both twins in the kernels' place on the
    card, its pts3d_1, conf_1 and desc_1 within TOL of the kernels'."""
    import torch
    import torch.nn.functional as F

    from gd3d_torch.kernels import rope2d as krope
    from gd3d_torch.kernels.flash_fwd import flash_attention_fwd_plain
    from gd3d_torch.ops import attention

    n = images.shape[0]
    pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
    ii = torch.tensor([p[0] for p in pairs], device=dev)
    jj = torch.tensor([p[1] for p in pairs], device=dev)
    seen = {}
    k1, k5 = attention.flash_attention_fwd, krope.rope2d_qk_fwd

    def rec_k1(q, k, v, scale):
        seen.setdefault(("K1", tuple(q.shape), tuple(k.shape)), (q, k, v, scale))
        return k1(q, k, v, scale)

    def rec_k5(q, qpos, k, kpos, base=100.0, f0=1.0):
        seen.setdefault(("K5", tuple(q.shape), tuple(k.shape), qpos is kpos),
                        (q, qpos, k, kpos, base, f0))
        return k5(q, qpos, k, kpos, base, f0)

    attention.flash_attention_fwd, krope.rope2d_qk_fwd = rec_k1, rec_k5
    try:
        feats = teacher.extract_features(images[ii], images[jj], 1.0)
    finally:
        attention.flash_attention_fwd, krope.rope2d_qk_fwd = k1, k5
    rep = KernelReport()
    for key, args in seen.items():
        if key[0] == "K1":
            q, k, v, scale = args
            B, N, H, D = q.shape
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            o, lse = k1(q, k, v, scale)
            o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, scale)
            rep.check("K1", f"align teacher call B={B} N={N} H={H} D={D} float32",
                      [("o", o, o_ref, "float32"), ("lse", lse, lse_ref, "float32")],
                      lambda: k1(q, k, v, scale), lambda: flash_attention_fwd_plain(q, k, v, scale),
                      nbytes=4 * B * N * H * D * 4 + B * H * N * 4, ops=4.0 * B * H * N * N * D,
                      dtype="float32", iters=10,
                      run_library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        else:
            q, qpos, k, kpos, base, f0 = args
            B, H, N, D = q.shape
            yq, yk = k5(q, qpos, k, kpos, base, f0)
            rep.check("K5", f"align teacher call q, k (B,N,H,D)=({B},{N},{H},{D}) float32 "
                      f"({'self' if key[3] else 'cross'})",
                      [("q", yq, krope.rope2d_plain(q, qpos, base, f0), "float32"),
                       ("k", yk, krope.rope2d_plain(k, kpos, base, f0), "float32")],
                      lambda: k5(q, qpos, k, kpos, base, f0),
                      lambda: (krope.rope2d_plain(q, qpos, base, f0),
                               krope.rope2d_plain(k, kpos, base, f0)),
                      nbytes=2 * (2 * B * N * H * D * 4 + B * N * 2 * 8),
                      ops=2 * 3.0 * B * N * H * D, dtype="float32", iters=30)
    kinds = {k[0] for k in seen}
    del seen
    if not rep.ok or kinds != {"K1", "K5"}:
        raise AssertionError(f"align: a kernel disagrees with its plain twin at the align "
                             f"path's shapes (kernels seen: {sorted(kinds)})")
    attention.flash_attention_fwd = flash_attention_fwd_plain
    krope.rope2d_qk_fwd = lambda q_, qp, k_, kp, base=100.0, f0=1.0: (
        krope.rope2d_plain(q_, qp, base, f0), krope.rope2d_plain(k_, kp, base, f0))
    try:
        twin = teacher.extract_features(images[ii], images[jj], 1.0)
    finally:
        attention.flash_attention_fwd, krope.rope2d_qk_fwd = k1, k5
    ok, parts = True, []
    for key in ("pts3d_1", "conf_1", "desc_1"):
        err, mag = max_err(feats[key], twin[key])
        ok &= math.isfinite(err) and err <= TOL["float32"] * max(1.0, mag)
        parts.append(f"{key} {tuple(feats[key].shape)} err={err:.3e} of {mag:.3e}")
    log(f"align: the teacher call of {len(pairs)} pairs with K1 and K5 against their plain "
        f"twins (tol {TOL['float32']:g} of max(1, max)): {' '.join(parts)} "
        f"{'OK' if ok else 'FAIL'} [{gpu}]")
    if not ok:
        raise AssertionError("align: the teacher on K1 and K5 disagrees with its plain twins")


def _check_scene_npz(path, dense, n: int, niter: int) -> str:
    """scene.npz's keys, shapes and finite values; dense None: the CLI's
    auto rule (sparse 1024 anchors above 200 000 points)."""
    import numpy as np

    H, W = ALIGN_HW
    if dense is None:
        dense = n * H * W <= 200_000
    P = H * W if dense else 1024
    want = {"poses": (n, 4, 4), "focals": (n,), "principal_points": (n, 2),
            "depthmaps": (n, H, W) if dense else (n, P),
            "pts3d": (n, H, W, 3) if dense else (n, P, 3), "confidence": (n, P),
            "images": (n, H, W, 3), "losses": (niter,)}
    z = np.load(path)
    shapes = {k: z[k].shape for k in z.files}
    finite = all(np.isfinite(z[k]).all() for k in z.files)
    if shapes != want or not finite:
        raise AssertionError(f"align: {path}: shapes {shapes} (want {want}), finite {finite}")
    return f"loss {float(z['losses'][0]):.4f} -> {float(z['losses'][-1]):.4f}"


def check_align_cli(dev, root, teacher, views, queries, gpu: str) -> dict:
    """(d) gd3d_torch.cli.align.main in this process on the card: dense with
    every export, then the default (auto-sparse); gd3d_torch.cli.localize
    .main for the 2 queries with --coarse-to-fine against the dense scene;
    one upload of 2 frames to gd3d_torch.cli.demo's server. Every file
    written, gd3d's keys and shapes, finite values, the COLMAP database read
    back through sqlite3; the dense run's launches those of one teacher
    call. Returns the launches of the four runs."""
    import http.client
    import sqlite3
    import uuid

    import numpy as np
    import torch

    from gd3d_torch.cli import align as align_cli
    from gd3d_torch.cli import demo, localize

    counts = {k: 0 for k in REPLACES}

    def add(more):
        for k, v in more.items():
            counts[k] += v

    dense_out = root / "dense"
    res, c, c_by, wall, peak = _counted_run(lambda: align_cli.main(
        ["--images", str(root / "views"), "--output", str(dense_out), "--sparse", "0",
         "--tsdf", "0.3", "--colmap", "--colmap-db", "--ply", "--html"], teacher=teacher))
    add(c)
    st = res["stats"]
    launches_ok = (c_by["K1"] == ALIGN_TEACHER_LAUNCHES["K1"]
                   and c["K5"] == ALIGN_TEACHER_LAUNCHES["K5"]
                   and all(v == 0 for k, v in c.items() if k not in ("K1", "K5")))
    loss = _check_scene_npz(dense_out / "scene.npz", True, ALIGN_VIEWS, 300)
    for name in ("colmap/cameras.txt", "colmap/images.txt", "colmap/points3D.txt",
                 "pointcloud.ply", "scene.html", "database.db"):
        if not (dense_out / name).is_file() or (dense_out / name).stat().st_size == 0:
            raise AssertionError(f"align: the dense run wrote no {name}")
    db = sqlite3.connect(dense_out / "database.db")
    try:
        rows = {t: db.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0]
                for t in ("cameras", "images", "keypoints", "matches", "two_view_geometries")}
        names = [r[0] for r in db.execute("SELECT name FROM images ORDER BY image_id")]
    finally:
        db.close()
    ply_head = (dense_out / "pointcloud.ply").read_text().splitlines()[:3]
    db_ok = (rows["cameras"] == rows["images"] == rows["keypoints"] == ALIGN_VIEWS
             and names == [f"view_{k}.png" for k in range(ALIGN_VIEWS)]
             and rows["matches"] == rows["two_view_geometries"] and ply_head[0] == "ply")
    log(f"align: CLI dense --tsdf 0.3 --colmap --colmap-db --ply --html: {st['pairs']} pairs, "
        f"{st['points']} points; teacher call {st['teacher_s']:.3f} s, alignment "
        f"{st['align_s']:.3f} s ({st['align_ms_per_iter']:.3f} ms a step), TSDF "
        f"{st['tsdf_s']:.3f} s, exports {st['export_s']:.3f} s, wall {wall:.2f} s, peak_mem_gib "
        f"{peak:.3f}; {loss}; database rows {rows}, {st['colmap_db']}; {ply_head[2]}; "
        f"launches {c}, K1 {c_by['K1']} (want {ALIGN_TEACHER_LAUNCHES}) "
        f"{'OK' if launches_ok and db_ok else 'FAIL'} [{gpu}]")
    if not (launches_ok and db_ok):
        raise AssertionError("align: the dense CLI run's launches or database are wrong")

    res, c, c_by, wall, peak = _counted_run(lambda: align_cli.main(
        ["--images", *views, "--output", str(root / "auto")], teacher=teacher))
    add(c)
    st = res["stats"]
    loss = _check_scene_npz(root / "auto" / "scene.npz", None, ALIGN_VIEWS, 300)
    log(f"align: CLI default (auto-sparse, 1024 anchors a view): teacher call "
        f"{st['teacher_s']:.3f} s, alignment {st['align_s']:.3f} s "
        f"({st['align_ms_per_iter']:.3f} ms a step), wall {wall:.2f} s, peak_mem_gib "
        f"{peak:.3f}; {loss}; launches {c} OK [{gpu}]")

    res, c, c_by, wall, peak = _counted_run(lambda: localize.main(
        ["--scene", str(dense_out / "scene.npz"), "--images", *queries, "--output",
         str(root / "loc"), "--coarse-to-fine"], teacher=teacher))
    add(c)
    z = np.load(root / "loc" / "query_poses.npz")
    loc_ok = (sorted(z.files) == ["n_matches", "names", "poses"] and z["poses"].shape == (2, 4, 4)
              and np.isfinite(z["poses"]).all() and c["K1"] > 0 and c["K5"] > 0)
    secs = res["stats"]["seconds"]
    log(f"align: CLI localize 2 queries --coarse-to-fine: {[f'{s:.3f}' for s in secs]} s a "
        f"query, matches {z['n_matches'].tolist()}, wall {wall:.2f} s, peak_mem_gib {peak:.3f}; "
        f"launches {c} {'OK' if loc_ok else 'FAIL'} [{gpu}]")
    if not loc_ok:
        raise AssertionError("align: the localize CLI's output or launches are wrong")

    args = demo.parse_args(["--output", str(root / "demo"), "--port", "0"])
    srv, port = demo.serve_background(args, teacher=teacher)
    boundary = f"----gd3d{uuid.uuid4().hex}"
    body = bytearray()
    for k, path in enumerate(views[:2]):
        body += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"images\"; "
                 f"filename=\"v{k}.png\"\r\nContent-Type: image/png\r\n\r\n").encode()
        body += open(path, "rb").read() + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    try:
        def upload():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            conn.request("POST", "/reconstruct", body=bytes(body),
                         headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
            r = conn.getresponse()
            r.read()
            loc = r.getheader("Location")
            conn.request("GET", loc or "/")
            page = conn.getresponse().read()
            return r.status, loc, page

        (status, loc, page), c, c_by, wall, peak = _counted_run(upload)
    finally:
        srv.shutdown()
        srv.server_close()
    add(c)
    demo_ok = status == 303 and loc is not None and b"<html" in page[:200].lower()
    if demo_ok:
        session = loc.split("/")[2]
        loss = _check_scene_npz(root / "demo" / session / "scene.npz", None, 2, 300)
    log(f"align: demo upload of 2 frames: status {status}, viewer {loc}, wall {wall:.2f} s, "
        f"peak_mem_gib {peak:.3f}; {loss if demo_ok else ''}; launches {c} "
        f"{'OK' if demo_ok else 'FAIL'} [{gpu}]")
    if not demo_ok:
        raise AssertionError("align: the demo server did not reconstruct the upload")
    torch.cuda.empty_cache()
    return counts


def check_align(dev) -> dict:
    """The align phase: (a) the synthetic scene's known answer on the card
    and the alignment loop's idle share, (b) the card against the CPU, (c) K1
    and K5 at the align path's shapes and the teacher against its plain
    twins, (d) the align, localize and demo entry points on 4 frames of the
    DSLR fixture. Returns the launches of (d)."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from gd3d_torch.data.images import load_image_mast3r
    from gd3d_torch.teachers.mast3r import Mast3rTeacher, no_tf32

    gpu = gpu_line()
    t0 = time.perf_counter()
    check_align_known(dev, gpu)
    log(f"align: (a), (b) done in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t1 = time.perf_counter()
        views, queries = write_align_frames(root)
        log(f"align: wrote the frames in {time.perf_counter() - t1:.1f} s")
        with torch.device(dev):
            teacher = Mast3rTeacher()
        teacher.init_params(torch.Generator(device=dev).manual_seed(12))
        teacher.eval()
        images = torch.from_numpy(np.stack([load_image_mast3r(v)["img"] for v in views])).to(dev)
        assert tuple(images.shape[1:3]) == ALIGN_HW, images.shape
        teacher.face_forward(images[:1], images[1:2])
        with no_tf32():
            check_align_kernels(dev, teacher, images, gpu)
        torch.cuda.empty_cache()
        log(f"align: (c) done at {time.perf_counter() - t0:.1f} s")
        counts = check_align_cli(dev, root, teacher, views, queries, gpu)
        log(f"align: (d) done at {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# sparse_ga: MASt3R's two-stage sparse global alignment (gd3d_torch/sparse_ga.py)
# ---------------------------------------------------------------------------
# (a) gd3d's synthetic sphere scene (tests/test_sparse_ga.py::_make_synthetic:
# 3 views of 48x48, 48 correspondences a pair), 300 + 300 steps on the card,
# held to that test's bounds: relative rotations within 0.3 degrees after the
# coarse stage and 6 after the fine one (whose poses wander along the
# dolly-zoom valley), baselines' cosine above 0.99, both stages' mean
# reprojection error under 0.5 px. (b) The card against the CPU on that scene
# with 0.3 px of noise on the correspondences and one pair under the matching
# gate, 20 steps of each stage: losses and outputs (poses and points in the
# MST root's frame, the gauge both leave free) within SGA_TOL of their
# largest value, the bound of tests/test_torch_sparse_ga.py's 20-step parity
# with gd3d (measured 1.1e-5 there) widened by the card's other summation
# order. (c) The align CLI with --sparse-ga at full width on the align
# phase's 4 windows, at subsample 8 (its default) and SGA_CLI_STEPS steps
# of each stage (its default 500, cut for the script's time).
SGA_TOL = 1e-3
SGA_STEPS = 20
SGA_CLI_STEPS = 200


def sga_synthetic(n=3, H=48, W=48, f=30.0, conf=10.0, n_corres=48, seed=0):
    """tests/test_sparse_ga.py::_make_synthetic, the same numpy: GT cameras
    viewing a world sphere; (build_scene kwargs, gt cam2w)."""
    import numpy as np

    def rot_y(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)

    rng = np.random.RandomState(seed)
    cx, cy = W / 2, H / 2
    sph_c, sph_r = np.float32([0.0, 0.0, 8.0]), 7.3
    cam2w = []
    for k in range(n):
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = rot_y(0.05 * (k - 1))
        M[:3, 3] = np.float32([0.3 * (k - 1), 0.05 * k, -0.1 * k])
        cam2w.append(M)
    cam2w = np.stack(cam2w)
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    d_cam = np.stack([(us - cx) / f, (vs - cy) / f, np.ones_like(us)], -1).astype(np.float32)

    def pointmap(k):
        R, t = cam2w[k, :3, :3], cam2w[k, :3, 3]
        dir_w = d_cam @ R.T
        a = (dir_w ** 2).sum(-1)
        oc = t - sph_c
        b = 2.0 * (dir_w @ oc)
        c0 = (oc ** 2).sum() - sph_r ** 2
        s = (-b - np.sqrt(b * b - 4 * a * c0)) / (2 * a)
        return d_cam * s[..., None], t + dir_w * s[..., None]

    ptmaps, confs, worlds = [], [], []
    for k in range(n):
        pc, pw = pointmap(k)
        worlds.append(pw)
        noise = rng.randn(2, H, W, 3).astype(np.float32) * 1e-3
        ptmaps.append([pc + noise[0], pc + noise[1]])
        confs.append([np.full((H, W), 2.0, np.float32)] * 2)

    def project(k, pw):
        R, t = cam2w[k, :3, :3], cam2w[k, :3, 3]
        pc = (pw - t) @ R
        return pc[..., :2] / pc[..., 2:] * f + [cx, cy], pc[..., 2]

    corres, pts_in_other, confs_other = {}, {}, {}
    for i in range(n):
        for j in range(i + 1, n):
            m = 4
            xi = rng.randint(m, W - m, n_corres * 4)
            yi = rng.randint(m, H - m, n_corres * 4)
            uv_j, z_j = project(j, worlds[i][yi, xi])
            ok = ((uv_j[:, 0] >= m) & (uv_j[:, 0] < W - m) & (uv_j[:, 1] >= m)
                  & (uv_j[:, 1] < H - m) & (z_j > 0))
            sel = np.where(ok)[0][:n_corres]
            corres[(i, j)] = (np.stack([xi[sel], yi[sel]], -1).astype(np.float32),
                              uv_j[sel].astype(np.float32), np.full(len(sel), conf, np.float32))
            Ri, ti = cam2w[i, :3, :3], cam2w[i, :3, 3]
            pts_in_other[(i, j)] = ((worlds[j] - ti) @ Ri).astype(np.float32)
            confs_other[(i, j)] = np.full((H, W), 2.0, np.float32)
    return dict(hw=(H, W), ptmaps=ptmaps, confs=confs, pts_in_other=pts_in_other,
                confs_other=confs_other, corres=corres), cam2w


def sga_recovery(scene, res, gt_cam2w) -> dict:
    """tests/test_sparse_ga.py's measures: the worst relative rotation
    error of each stage (degrees, gauge-aligned on camera 0), the worst
    baseline cosine of the coarse stage, and both stages' mean reprojection
    error (px)."""
    import numpy as np

    def gauge(est):
        return np.einsum("ab,nbc->nac", gt_cam2w[0] @ np.linalg.inv(est[0]), est)

    def rot_err(Ra, Rb):
        return np.degrees(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1) / 2, -1, 1)))

    def reproj_err(r):
        K, w2c, errs = r["intrinsics"], np.linalg.inv(r["cam2w"]), []
        for e in range(len(scene.e_i)):
            i, j, v = int(scene.e_i[e]), int(scene.e_j[e]), scene.valid[e]
            for k, pts, pix in ((i, r["pts3d_j"][e][v], scene.pix_i[e][v]),
                                (j, r["pts3d_i"][e][v], scene.pix_j[e][v])):
                pc = pts @ w2c[k, :3, :3].T + w2c[k, :3, 3]
                uv = pc[:, :2] / np.clip(pc[:, 2:], 1e-8, None) * [K[k, 0, 0], K[k, 1, 1]] \
                    + K[k, :2, 2]
                errs.append(np.linalg.norm(uv - pix, axis=-1))
        return float(np.concatenate(errs).mean())

    out = {}
    for stage in ("coarse", "fine"):
        est = gauge(res[stage]["cam2w"])
        out[f"{stage}_rot_deg"] = max(
            rot_err(gt_cam2w[a, :3, :3].T @ gt_cam2w[b, :3, :3], est[a, :3, :3].T @ est[b, :3, :3])
            for a in range(scene.n_imgs) for b in range(a + 1, scene.n_imgs))
        out[f"{stage}_reproj_px"] = reproj_err(res[stage])
    est = gauge(res["coarse"]["cam2w"])
    gt_base = gt_cam2w[1:, :3, 3] - gt_cam2w[0, :3, 3]
    est_base = est[1:, :3, 3] - est[0, :3, 3]
    out["coarse_base_cos"] = min(float(g @ e / (np.linalg.norm(g) * np.linalg.norm(e) + 1e-12))
                                 for g, e in zip(gt_base, est_base))
    return out


def sga_in_root_frame(res, root):
    import numpy as np

    g = np.linalg.inv(np.asarray(res["cam2w"][root], np.float64))
    out = dict(res)
    out["cam2w"] = np.einsum("ab,nbc->nac", g, res["cam2w"])
    for k in ("pts3d_i", "pts3d_j"):
        out[k] = res[k] @ g[:3, :3].T + g[:3, 3]
    return out


def check_sparse_ga_known(dev, gpu: str) -> None:
    """(a) and (b)."""
    import numpy as np
    import torch

    from gd3d_torch.sparse_ga import build_scene, dense_pts3d, sparse_scene_optimizer

    kw, gt = sga_synthetic()
    scene = build_scene(subsample=8, **kw)
    torch.cuda.reset_peak_memory_stats()
    res = sparse_scene_optimizer(scene, niter1=300, niter2=300, device=dev)
    m = sga_recovery(scene, res, gt)
    pts, depths = dense_pts3d(scene, res["fine"])
    ok = (m["coarse_rot_deg"] < 0.3 and m["fine_rot_deg"] < 6.0 and m["coarse_base_cos"] > 0.99
          and m["coarse_reproj_px"] < 0.5 and m["fine_reproj_px"] < 0.5
          and all((d > 0).all() for d in depths) and np.isfinite(pts).all())
    secs = res["seconds"]
    log(f"sparse_ga: known answer ({scene.n_imgs} views of 48x48, {int(scene.valid.sum())} "
        f"correspondences) 300 + 300 steps: coarse {secs['coarse']:.3f} s "
        f"({secs['coarse'] * 1e3 / 300:.3f} ms a step), fine {secs['fine']:.3f} s "
        f"({secs['fine'] * 1e3 / 300:.3f} ms a step); relative rotation coarse "
        f"{m['coarse_rot_deg']:.4f} deg (want < 0.3), fine {m['fine_rot_deg']:.4f} (want < 6); "
        f"baseline cosine {m['coarse_base_cos']:.5f} (want > 0.99); reprojection coarse "
        f"{m['coarse_reproj_px']:.4f} px, fine {m['fine_reproj_px']:.4f} px (want < 0.5); loss "
        f"{res['losses']['coarse'][0]:.4f} -> {res['losses']['fine'][-1]:.4f}; peak_mem_gib "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} {'OK' if ok else 'FAIL'} [{gpu}]")
    if not ok:
        raise AssertionError("sparse_ga: the card's two stages did not recover the scene")

    rng = np.random.RandomState(3)
    for key, (xy_i, xy_j, cf) in kw["corres"].items():
        kw["corres"][key] = (xy_i, (xy_j + 0.3 * rng.randn(*xy_j.shape)).astype(np.float32),
                             np.full_like(cf, 0.5) if key == (0, 2) else cf)
    scene = build_scene(subsample=8, **kw)
    t0 = time.perf_counter()
    want = sparse_scene_optimizer(scene, niter1=SGA_STEPS, niter2=SGA_STEPS, device="cpu")
    cpu_s = time.perf_counter() - t0
    got = sparse_scene_optimizer(scene, niter1=SGA_STEPS, niter2=SGA_STEPS, device=dev)
    errs = {}
    for stage in ("coarse", "fine"):
        lw = want["losses"][stage]
        errs[f"{stage} losses"] = float(np.abs(got["losses"][stage] - lw).max() / np.abs(lw).max())
        g, w = (sga_in_root_frame(r[stage], scene.mst_root) for r in (got, want))
        for k in w:
            errs[f"{stage} {k}"] = float(np.abs(g[k] - w[k]).max() / max(np.abs(w[k]).max(), 1e-12))
    ok = all(math.isfinite(e) and e <= SGA_TOL for e in errs.values())
    log(f"sparse_ga: card against CPU, the noisy scene with the fallback live, {SGA_STEPS} steps "
        f"of each stage: " + " ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f" (tol {SGA_TOL:g} of the max); CPU {cpu_s:.2f} s {'OK' if ok else 'FAIL'} [{gpu}]")
    if not ok:
        raise AssertionError("sparse_ga: the card's optimizer disagrees with the CPU's")


def check_sparse_ga(dev) -> dict:
    """The sparse_ga phase: (a), (b), then (c) gd3d_torch.cli.align.main
    --sparse-ga in this process on the card on 4 windows of the DSLR
    fixture, the CLI's defaults: its launches exactly one teacher call's
    (ALIGN_TEACHER_LAUNCHES: the 6 pairs fit one pair_chunk of 8), scene.npz's
    keys and shapes, finite values; the teacher's, each stage's and the
    exports' seconds, and the idle share of 20 + 20 profiled steps.
    Returns the CLI run's launches."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from gd3d_torch.cli import align as align_cli
    from gd3d_torch.data.images import load_image_mast3r
    from gd3d_torch.sparse_ga import sparse_scene_optimizer
    from gd3d_torch.teachers.mast3r import Mast3rTeacher

    gpu = gpu_line()
    t0 = time.perf_counter()
    check_sparse_ga_known(dev, gpu)
    log(f"sparse_ga: (a), (b) done in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        views, _ = write_align_frames(root)
        with torch.device(dev):
            teacher = Mast3rTeacher()
        teacher.init_params(torch.Generator(device=dev).manual_seed(12))
        teacher.eval()
        images = torch.from_numpy(np.stack([load_image_mast3r(v)["img"] for v in views])).to(dev)
        teacher.face_forward(images[:1], images[1:2])
        del images
        out = root / "sga"
        res, c, c_by, wall, peak = _counted_run(lambda: align_cli.main(
            ["--images", *views, "--output", str(out), "--sparse-ga", "--ga-niter1",
             str(SGA_CLI_STEPS), "--ga-niter2", str(SGA_CLI_STEPS), "--ply", "--html"],
            teacher=teacher))
        st = res["stats"]
        n, (H, W) = ALIGN_VIEWS, ALIGN_HW
        want = {"poses": (n, 4, 4), "focals": (n,), "principal_points": (n, 2),
                "depthmaps": (n, H, W), "pts3d": (n, H * W, 3), "images": (n, H, W, 3)}
        with np.load(out / "scene.npz") as z:
            shapes = {k: z[k].shape for k in z.files}
            finite = all(np.isfinite(z[k]).all() for k in z.files)
        launches_ok = (c_by["K1"] == ALIGN_TEACHER_LAUNCHES["K1"]
                       and c["K5"] == ALIGN_TEACHER_LAUNCHES["K5"]
                       and all(v == 0 for k, v in c.items() if k not in ("K1", "K5")))
        files_ok = all((out / f).stat().st_size > 0 for f in ("pointcloud.ply", "scene.html"))
        ok = shapes == want and finite and launches_ok and files_ok
        losses = res["res"]["losses"]
        log(f"sparse_ga: CLI --sparse-ga ({SGA_CLI_STEPS} + {SGA_CLI_STEPS} steps, subsample 8) "
            f"on {n} views of "
            f"{H}x{W}: {st['pairs']} pairs, {st['correspondences']} correspondences; teacher "
            f"call {st['teacher_s']:.3f} s, coarse {st['coarse_s']:.3f} s "
            f"({st['coarse_ms_per_iter']:.3f} ms a step), fine {st['fine_s']:.3f} s "
            f"({st['fine_ms_per_iter']:.3f} ms a step), exports {st['export_s']:.3f} s, wall "
            f"{wall:.2f} s, peak_mem_gib {peak:.3f}; loss coarse {losses['coarse'][0]:.4f} -> "
            f"{losses['coarse'][-1]:.4f}, fine {losses['fine'][0]:.4f} -> "
            f"{losses['fine'][-1]:.4f}; scene.npz {shapes} finite {finite}; launches {c}, K1 "
            f"{c_by['K1']} (want {ALIGN_TEACHER_LAUNCHES}) {'OK' if ok else 'FAIL'} [{gpu}]")
        if not ok:
            raise AssertionError("sparse_ga: the --sparse-ga CLI run's files or launches are wrong")
        scene = res["scene"]
        idle = profile_call("sparse_ga", lambda: sparse_scene_optimizer(
            scene, niter1=20, niter2=20, device=dev), "20 + 20 steps")
        log(f"sparse_ga: the two stages' idle share {idle:.3f} [{gpu}]")
        del teacher
        torch.cuda.empty_cache()
    log(f"sparse_ga: (c) done at {time.perf_counter() - t0:.1f} s")
    return c


# ---------------------------------------------------------------------------
# stereoflow: CroCo-Stereo / CroCo-Flow (gd3d_torch/cli/stereoflow.py)
# ---------------------------------------------------------------------------
# One step of a task at full width (CroCo v2 ViT-L encoder, Base decoder,
# batch 2): the encoder's 24 attentions over both views (K1 forward, K2
# backward, K5 forward and backward on q and k) and the decoder's 12 self
# attentions (the same) and 12 cross attentions (K5 only: their product is a
# plain einsum, as in gd3d)
SF_STEP = {"K1": 36, "K2": 36, "K5 fwd": 48, "K5 bwd": 48}
SF_STEPS = 2
SF_EVAL_PAIRS = 1  # KITTI pairs the eval CLI runs on
# the card against the CPU on a small model (head dim 64) and on --tiny
# (head dims 16 and 8, zero-padded to 64 by the flash wrappers): the train
# phase's tolerances, fp32 loss 1e-4 relative, the gradients, the AdamW
# moments and the updated weights 1e-3 of each tensor's largest value
SF_LOSS_TOL = 1e-4
SF_STATE_TOL = 1e-3
SF_SMALL = dict(croco=dict(enc_embed_dim=128, enc_depth=2, enc_num_heads=2, dec_embed_dim=128,
                           dec_depth=2, dec_num_heads=2),
                hooks=(0, 1, 2, 3), dpt_layer_dims=(8, 16, 24, 32), dpt_feature_dim=16,
                dpt_last_dim=8)
# the eval pairs: KITTI 2015's frame size, 2 pairs (8 overlapping 352x704
# tiles each at the default overlap 0.7)
SF_KITTI_HW = (375, 1242)


def write_stereoflow_tree(root, task, hw, n=2, seed=0):
    """A generic-layout tree: textured PNG pairs (the right view the left
    shifted), PFM disparities with +inf holes or .flo flows."""
    import numpy as np

    from gd3d_torch.data.fixtures import texture
    from gd3d_torch.data.flowio import write_flo, write_pfm
    from gd3d_torch.data.png import encode_png_rgb

    rng = np.random.RandomState(seed)
    H, W = hw
    for d in ("left", "right", "gt"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        big = texture(rng, H, W + 16)
        (root / "left" / f"p{i}.png").write_bytes(encode_png_rgb(np.ascontiguousarray(big[:, 16:])))
        (root / "right" / f"p{i}.png").write_bytes(encode_png_rgb(np.ascontiguousarray(big[:, :W])))
        if task == "stereo":
            gt = np.full((H, W), 16.0, np.float32) + rng.rand(H, W).astype(np.float32)
            gt[rng.rand(H, W) < 0.1] = np.inf
            write_pfm(str(root / "gt" / f"p{i}.pfm"), gt)
        else:
            gt = np.zeros((H, W, 2), np.float32)
            gt[..., 0] = 16.0
            write_flo(str(root / "gt" / f"p{i}.flo"), gt + rng.randn(H, W, 2).astype(np.float32))


def write_kitti_tree(root, n=2, seed=1):
    """KITTI 2015's stereo layout at its frame size: image_2/3 PNG pairs and
    disp_occ_0 16-bit disparities with invalid (0) pixels."""
    import numpy as np

    from gd3d_torch.data.fixtures import texture
    from gd3d_torch.data.flowio import write_kitti_disp
    from gd3d_torch.data.png import encode_png_rgb

    rng = np.random.RandomState(seed)
    H, W = SF_KITTI_HW
    t = root / "training"
    for d in ("image_2", "image_3", "disp_occ_0"):
        (t / d).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        big = texture(rng, H, W + 24)
        (t / "image_2" / f"{i:06d}_10.png").write_bytes(
            encode_png_rgb(np.ascontiguousarray(big[:, 24:])))
        (t / "image_3" / f"{i:06d}_10.png").write_bytes(
            encode_png_rgb(np.ascontiguousarray(big[:, :W])))
        disp = np.full((H, W), 24.0, np.float32)
        disp[rng.rand(H, W) < 0.3] = np.inf
        write_kitti_disp(str(t / "disp_occ_0" / f"{i:06d}_10.png"), disp)


def sf_launches(c) -> dict:
    """The stereoflow launches of a counted run (read just after it): K1,
    K2, K5 forward and backward, and the other kernels' total."""
    from gd3d_torch.kernels import backward_launches

    bwd = backward_launches()["K5"]
    return {"K1": c["K1"], "K2": c["K2"], "K5 fwd": c["K5"] - bwd, "K5 bwd": bwd,
            "other": sum(v for k, v in c.items() if k not in ("K1", "K2", "K5"))}


def check_stereoflow_train(dev, root, task, gpu: str) -> dict:
    """(a) gd3d_torch.cli.stereoflow train at full width, SF_STEPS steps of
    batch 2 from a seeded init file: its launches SF_STEPS x SF_STEP at the
    crop's length (fp32, counted just around the run), finite losses, every
    trained tensor moved; then one more step profiled. Returns the run's
    launches."""
    import numpy as np
    import torch

    from gd3d_torch.cli import stereoflow as sf_cli
    from gd3d_torch.data.flowio import StereoFlowPairs, discover_pairs
    from gd3d_torch.models.stereoflow import StereoFlow
    from gd3d_torch.models.vit import init_params_
    from gd3d_torch.stereoflow import CRITERIA, DEFAULT_CRITERION, DEFAULT_CROP
    from gd3d_torch.stereoflow import build_stereoflow_train_step, make_stereoflow_optimizer

    tree = root / task
    write_stereoflow_tree(tree, task, (384, 768) if task == "stereo" else (384, 512))
    args = sf_cli.parse_args(["train", "--task", task, "--root", str(tree), "--output", "x"])
    with torch.device(dev):
        model = StereoFlow(sf_cli.model_config(args))
    init_params_(model, torch.Generator(device=dev).manual_seed(21))
    init = root / f"init_{task}.npz"
    sf_cli.save_params(init, model)
    n_params = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    out = root / f"run_{task}"
    res, c, c_by, wall, peak = _counted_run(lambda: sf_cli.main(
        ["train", "--task", task, "--root", str(tree), "--output", str(out), "--steps",
         str(SF_STEPS), "--batch", "2", "--warmup", "1", "--ckpt", str(init)]))
    got = sf_launches(c)
    N = STEREOFLOW_LENGTHS["CroCo-Stereo" if task == "stereo" else "CroCo-Flow"]
    want = {k: v * SF_STEPS for k, v in SF_STEP.items()}
    lengths_ok = (c_by["K1"] == {("float32", N): want["K1"]}
                  and c_by["K2"] == {("float32", N): want["K2"]}
                  and c_by["K5"] == {("float32", N): want["K5 fwd"] + want["K5 bwd"]})
    launches_ok = all(got[k] == v for k, v in want.items()) and got["other"] == 0 and lengths_ok
    losses = [r["loss"] for r in res["records"]]
    with np.load(init) as a, np.load(out / "params_final.npz") as b:
        same = [k for k in a.files if np.array_equal(a[k], b[k])]
        n_tensors = len(a.files)
    step_s = res["stats"]["step_s"]
    ok = launches_ok and all(math.isfinite(v) for v in losses) and not same
    crop = DEFAULT_CROP[task]
    log(f"stereoflow: train {task} at full width ({n_params / 1e6:.1f} M parameters, crop "
        f"{crop[0]}x{crop[1]}, N = {N}, batch 2) {SF_STEPS} steps: losses "
        f"{[round(v, 4) for v in losses]}; step s {[round(v, 4) for v in step_s]} (steady "
        f"{float(np.median(step_s[1:])):.4f} s a step), wall {wall:.2f} s, peak_mem_gib "
        f"{peak:.3f}; {n_tensors - len(same)} of {n_tensors} trained tensors moved "
        f"{'(unmoved: ' + str(same[:4]) + ')' if same else ''}; launches {got} (want "
        f"{want}, by length {c_by['K1']} {c_by['K2']} {c_by['K5']}) {'OK' if ok else 'FAIL'} "
        f"[{gpu}]")
    if not ok:
        raise AssertionError(f"stereoflow: the {task} training run's launches, losses or "
                             "updates are wrong")

    # one more step under the profiler: each kernel's share of its device time
    del res
    torch.cuda.empty_cache()
    args = sf_cli.parse_args(["train", "--task", task, "--root", str(tree), "--output", "x",
                              "--ckpt", str(out / "params_final.npz")])
    model, _ = sf_cli.build_model(args, dev)
    opt = make_stereoflow_optimizer(model, 3e-5, 10, 1)
    step = build_stereoflow_train_step(model, CRITERIA[DEFAULT_CRITERION[task]], opt)
    ds = StereoFlowPairs(discover_pairs(str(tree), "generic", task), task, crop_size=crop)
    items = [ds[0], ds[1]]
    batch = [torch.from_numpy(np.stack([it[k] for it in items])).to(dev)
             for k in ("img1", "img2", "gt")]
    step(*batch)  # warm
    idle = profile_call(f"stereoflow {task}", lambda: step(*batch), "train step")
    log(f"stereoflow: {task} train step idle share {idle:.3f} [{gpu}]")
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return c


def check_stereoflow_agree(dev, root, gpu: str) -> None:
    """(b) one AdamW step of a small stereo model (head dim 64) on the card
    against the CPU plain path, from shared weights on one batch of the
    tree: the loss, every gradient, AdamW's moments and the updated weights."""
    import numpy as np
    import torch

    from gd3d_torch.data.flowio import StereoFlowPairs, discover_pairs
    from gd3d_torch.models.croco import CrocoConfig
    from gd3d_torch.models.stereoflow import StereoFlow, StereoFlowConfig
    from gd3d_torch.models.vit import init_params_
    from gd3d_torch.stereoflow import CRITERIA, build_stereoflow_train_step
    from gd3d_torch.stereoflow import make_stereoflow_optimizer

    cfg = StereoFlowConfig(croco=CrocoConfig(**SF_SMALL["croco"]),
                           **{k: v for k, v in SF_SMALL.items() if k != "croco"})
    ds = StereoFlowPairs(discover_pairs(str(root / "stereo"), "generic", "stereo"), "stereo",
                         crop_size=(64, 96), seed=5)
    items = [ds[0], ds[1]]
    batch = [torch.from_numpy(np.stack([it[k] for it in items])) for k in ("img1", "img2", "gt")]
    ref = StereoFlow(cfg)
    init_params_(ref, torch.Generator().manual_seed(5))
    runs = {}
    for device in ("cpu", dev):
        model = StereoFlow(cfg).to(device)
        model.load_state_dict(ref.state_dict())
        opt = make_stereoflow_optimizer(model, 1e-4, 4, 1)
        step = build_stereoflow_train_step(model, CRITERIA["LaplacianLossBounded2()"], opt)
        loss = float(step(*(t.to(device) for t in batch)))
        runs[str(device)] = (loss, {k: p.grad.cpu() for k, p in opt.params.items()},
                             {k: v.cpu() for k, v in opt.mu.items()},
                             {k: v.cpu() for k, v in opt.nu.items()},
                             {k: p.detach().cpu() for k, p in opt.params.items()})
    (lc, *cpu), (lg, *card) = runs["cpu"], runs[str(dev)]

    def worst(a, b):
        return max(float((a[k] - b[k]).abs().max() / max(float(b[k].abs().max()), 1e-12))
                   for k in b)

    errs = {name: worst(g, w) for name, g, w in zip(("grads", "mu", "nu", "params"), card, cpu)}
    loss_err = abs(lg - lc) / abs(lc)
    ok = (loss_err <= SF_LOSS_TOL and all(math.isfinite(e) and e <= SF_STATE_TOL
                                          for e in errs.values()))
    log(f"stereoflow: card against CPU, one AdamW step of a small stereo model (head dim 64, "
        f"64x96 crop, batch 2): loss {lg:.6f} vs {lc:.6f} rel {loss_err:.3e} (tol "
        f"{SF_LOSS_TOL:g}); worst tensor " + " ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f" (tol {SF_STATE_TOL:g} of its max) {'OK' if ok else 'FAIL'} [{gpu}]")
    if not ok:
        raise AssertionError("stereoflow: the card's training step disagrees with the CPU's")


def check_stereoflow_tiny(dev, root, gpu: str) -> dict:
    """(b2) gd3d_torch.cli.stereoflow train --tiny (head dims 16 and 8, which
    the flash wrappers zero-pad to 64) for two steps on the card and the same
    steps on the CPU (the first at the warm-up's zero learning rate, so the
    second moves the weights), from one init file on (a)'s stereo tree: the
    last loss (SF_LOSS_TOL), and AdamW's moments and the updated weights
    (SF_STATE_TOL of each tensor's largest value). Returns the card run's
    launches."""
    import torch

    from gd3d_torch.cli import stereoflow as sf_cli
    from gd3d_torch.models.stereoflow import StereoFlow
    from gd3d_torch.models.vit import init_params_

    base = ["train", "--task", "stereo", "--tiny", "--root", str(root / "stereo"), "--steps",
            "2", "--batch", "2", "--warmup", "1"]
    model = StereoFlow(sf_cli.model_config(sf_cli.parse_args([*base, "--output", "x"])))
    init_params_(model, torch.Generator().manual_seed(23))
    init = root / "init_tiny.npz"
    sf_cli.save_params(init, model)
    runs = {}
    for device in ("cpu", "cuda"):
        res, c, c_by, wall, _ = _counted_run(lambda: sf_cli.main(
            [*base, "--output", str(root / f"tiny_{device}"), "--ckpt", str(init), "--device",
             device]))
        opt = res["optimizer"]
        runs[device] = (res["records"][-1]["loss"],
                        *({k: v.detach().cpu() for k, v in d.items()}
                          for d in (opt.mu, opt.nu, opt.params)), c, c_by, wall)
    (lc, *cpu, _, _, wall_c), (lg, *card, c, c_by, wall_g) = runs["cpu"], runs["cuda"]

    def worst(a, b):
        return max(float((a[k] - b[k]).abs().max() / max(float(b[k].abs().max()), 1e-12))
                   for k in b)

    errs = {name: worst(g, w) for name, g, w in zip(("mu", "nu", "params"), card, cpu)}
    loss_err = abs(lg - lc) / abs(lc)
    launched = c["K1"] > 0 and c["K2"] > 0 and c["K5"] > 0
    ok = launched and loss_err <= SF_LOSS_TOL and all(
        math.isfinite(e) and e <= SF_STATE_TOL for e in errs.values())
    log(f"stereoflow: train --tiny two steps, card against CPU (head dims 16 and 8, 64x96 "
        f"crop, batch 2): loss {lg:.6f} vs {lc:.6f} rel {loss_err:.3e} (tol {SF_LOSS_TOL:g}); "
        "worst tensor " + " ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f" (tol {SF_STATE_TOL:g} of its max); card wall {wall_g:.2f} s, CPU {wall_c:.2f} s; "
        f"launches {c} by length {c_by['K1']} {c_by['K2']} {'OK' if ok else 'FAIL'} [{gpu}]")
    if not ok:
        raise AssertionError("stereoflow: the --tiny step on the card disagrees with the CPU's "
                             "or launched no kernel")
    return c


def check_stereoflow_eval(dev, root, gpu: str) -> dict:
    """(c) eval on SF_EVAL_PAIRS pairs of a KITTI 2015 tree at 375x1242 (8 tiles a
    pair, one forward each) and predict on one pair: the files, their
    shapes, finite values, the launches (a step's forward ones a pair, 36
    K1 and 48 K5; no backward). Returns the launches."""
    import json as _json

    import numpy as np
    import torch

    from gd3d_torch.cli import stereoflow as sf_cli
    from gd3d_torch.data.flowio import read_pfm

    write_kitti_tree(root / "kitti", n=SF_EVAL_PAIRS)
    ckpt = str(root / "run_stereo" / "params_final.npz")
    out = root / "eval"
    res, c, _, wall, peak = _counted_run(lambda: sf_cli.main(
        ["eval", "--task", "stereo", "--root", str(root / "kitti"), "--layout", "kitti15",
         "--output", str(out), "--ckpt", ckpt, "--save", "metrics", "pred", "visu"]))
    got = sf_launches(c)
    H, W = SF_KITTI_HW
    metrics = _json.loads((out / "metrics.json").read_text())
    n = SF_EVAL_PAIRS
    preds = [np.load(out / f"training_image_2_{i:06d}_10_pred.npy") for i in range(n)]
    pngs = [(out / f"training_image_2_{i:06d}_10_pred.png").stat().st_size for i in range(n)]
    # one forward a pair (all 8 tiles in one batch), no backward
    want = {"K1": n * SF_STEP["K1"], "K2": 0, "K5 fwd": n * SF_STEP["K5 fwd"], "K5 bwd": 0,
            "other": 0}
    launches_ok = got == want
    ok = (launches_ok and sorted(metrics) == ["L1err", "bad@0.5", "bad@1.0", "bad@2.0", "bad@3.0"]
          and all(math.isfinite(v) for v in metrics.values())
          and all(p.shape == (H, W, 1) and np.isfinite(p).all() for p in preds) and min(pngs) > 0)
    log(f"stereoflow: eval {n} KITTI pair(s) of {H}x{W} (8 tiles a pair, overlap 0.7): wall "
        f"{wall:.2f} s ({wall / n:.3f} s a pair), peak_mem_gib {peak:.3f}; metrics "
        f"{ {k: round(v, 4) for k, v in metrics.items()} }; launches {got} (want {want}) "
        f"{'OK' if ok else 'FAIL'} [{gpu}]")
    if not ok:
        raise AssertionError("stereoflow: the eval run's files or launches are wrong")
    pred_path = root / "pred.pfm"
    res, c2, _, wall, peak = _counted_run(lambda: sf_cli.main(
        ["predict", "--task", "stereo", "--ckpt", ckpt, "--left",
         str(root / "kitti" / "training" / "image_2" / "000000_10.png"), "--right",
         str(root / "kitti" / "training" / "image_3" / "000000_10.png"), "--output",
         str(pred_path), "--visu", str(root / "pred_visu.png")]))
    got2 = sf_launches(c2)
    disp = read_pfm(str(pred_path))[0]
    ok = (disp.shape == (H, W) and np.isfinite(disp).all()
          and (root / "pred_visu.png").stat().st_size > 0 and c2["K1"] == SF_STEP["K1"])
    log(f"stereoflow: predict one KITTI pair -> .pfm {disp.shape}, wall {wall:.2f} s; "
        f"launches {got2} {'OK' if ok else 'FAIL'} [{gpu}]")
    if not ok:
        raise AssertionError("stereoflow: the predict run's file or launches are wrong")
    for k in c:
        c[k] += c2[k]
    torch.cuda.empty_cache()
    return c


def check_stereoflow(dev) -> dict:
    """The stereoflow phase: (a) train both tasks at full width through the
    CLI, (b) the card against the CPU on a small model and on --tiny through
    the CLI, (c) eval and predict at KITTI's frame size. Returns the
    launches of (a), (b)'s --tiny card run and (c)."""
    import tempfile
    from pathlib import Path

    gpu = gpu_line()
    t0 = time.perf_counter()
    counts = {k: 0 for k in REPLACES}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for task in ("stereo", "flow"):
            for k, v in check_stereoflow_train(dev, root, task, gpu).items():
                counts[k] += v
            log(f"stereoflow: (a) {task} done at {time.perf_counter() - t0:.1f} s")
        check_stereoflow_agree(dev, root, gpu)
        for k, v in check_stereoflow_tiny(dev, root, gpu).items():
            counts[k] += v
        log(f"stereoflow: (b) done at {time.perf_counter() - t0:.1f} s")
        for k, v in check_stereoflow_eval(dev, root, gpu).items():
            counts[k] += v
        log(f"stereoflow: (c) done at {time.perf_counter() - t0:.1f} s")
    return counts


# the pretraining phase: launches a step at each objective's lengths, the
# CroCo net at 224^2 with mask 0.9 (20 visible tokens of 196) and batch 16,
# MASt3R at 512^2 (1024 tokens) with batch 2 (its 2B = 4 sequences)
PT_STEPS = 2
PT_STEP = {"croco": {"K1": 60, "K2": 60, "K5 fwd": 72, "K5 bwd": 72},
           "mast3r": {"K1": 48, "K2": 48, "K5 fwd": 72, "K5 bwd": 72}}
PT_BY_LENGTH = {  # (K1 = K2, K5 forward + backward) launches a step by length
    "croco": ({20: 24, 196: 36}, {20: 48, 196: 96}),
    "mast3r": ({1024: 48}, {1024: 144}),
    "co3d": ({196: 48}, {196: 144}),
}
# the card against the CPU on a small model the kernels take (head dim 64;
# the --tiny trunk's 16 and 8 are not kernel widths), --tiny's heads and
# 64^2 views (16 tokens; 2 visible under CroCo's mask): the loss 1e-4
# relative, the gradients and AdamW's moments 1e-3 of each tensor's largest
# value, the updated weights as ||card - CPU|| / ||CPU|| over all tensors,
# RESUME_TOL: not element by element, because AdamW's first update,
# lr g / (|g| + eps), turns the rounding of a gradient at the noise floor
# (the key bias's, zero in exact arithmetic) into up to lr of a
# zero-initialised bias (2.7e-5 of the largest weight at lr 1e-4 on NVIDIA
# H100 80GB HBM3, 700.00 W: PERF.md §6). The straight run against the resumed one as
# the train phase's ME check: each record RESUME_TOL relative, the final
# weights RESUME_TOL and AdamW's moments STATE_TOL as ||resumed - straight||
# / ||straight|| over all tensors, the step counts exactly
PT_SMALL = dict(patch_size=16, enc_embed_dim=128, enc_depth=2, enc_num_heads=2,
                dec_embed_dim=128, dec_depth=2, dec_num_heads=2)
PT_LOSS_TOL = 1e-4
PT_STATE_TOL = 1e-3


def pt_rel_l2(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over all tensors of two name -> tensor (or
    array) dicts."""
    import numpy as np

    num = den = 0.0
    for k, w in want.items():
        a, b = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        num += float(np.square(a - b).sum())
        den += float(np.square(b).sum())
    return math.sqrt(num / den) if den else math.sqrt(num)


def pt_launches(c, c_by, objective: str, steps: int) -> tuple:
    """(launches, want, ok) of a counted pretraining run."""
    got = sf_launches(c)
    want = {k: v * steps for k, v in PT_STEP["croco" if objective == "croco" else "mast3r"].items()}
    attn, rope = PT_BY_LENGTH[objective]
    by_ok = (c_by["K1"] == {("float32", n): v * steps for n, v in attn.items()}
             and c_by["K2"] == c_by["K1"]
             and c_by["K5"] == {("float32", n): v * steps for n, v in rope.items()})
    ok = all(got[k] == v for k, v in want.items()) and got["other"] == 0 and by_ok
    return got, want, ok


def check_pretrain_kernels(dev, gpu: str) -> None:
    """(a) K1, K2 and K5 at the pretraining shapes against their plain twins
    (fp32, TF32 off): the CroCo net's masked encoder (16 sequences of 20
    tokens, under one 64-row tile, K5 on per-row gathered positions), its
    full encoder and decoder (196 tokens), the MASt3R encoder and decoder
    at 512^2 (1024 tokens)."""
    import numpy as np
    import torch

    from gd3d_torch.ops.rope2d import grid_positions

    g = torch.Generator(device=dev).manual_seed(4321)
    rep = KernelReport()
    f32 = torch.float32
    for where, B, N, H in (("CroCo pretraining masked encoder", 16, 20, 16),
                           ("CroCo pretraining encoder", 16, 196, 16),
                           ("CroCo pretraining decoder", 16, 196, 12),
                           ("MASt3R pretraining encoder", 4, 1024, 16),
                           ("MASt3R pretraining decoder", 4, 1024, 12)):
        for kern in ("K1", "K2"):
            attn_case(rep, g, dev, kern, where, B, N, H, 64, f32, False, repeat=kern == "K2")
    # the visible tokens' positions: a random 0.9 mask a row, the visible
    # ones in patch order (the model's stable argsort)
    grid14 = grid_positions(14, 14, 16, device=dev)
    mask = torch.from_numpy(np.argsort(np.random.RandomState(3).rand(16, 196), axis=1,
                                       kind="stable") < 176).to(dev)
    vis = torch.argsort(mask.to(torch.int32), dim=1, stable=True)[:, :20]
    pos_vis = grid14[torch.arange(16, device=dev)[:, None], vis]
    grid32 = grid_positions(32, 32, 4, device=dev)
    for where, B, N, H, kind, qpos, kpos in (
            ("CroCo pretraining masked encoder", 16, 20, 16, "qkv", pos_vis, pos_vis),
            ("CroCo pretraining encoder", 16, 196, 16, "qkv", grid14, grid14),
            ("CroCo pretraining decoder self", 16, 196, 12, "qkv", grid14, grid14),
            ("CroCo pretraining decoder cross", 16, 196, 12, "separate", grid14, grid14),
            ("MASt3R pretraining encoder", 4, 1024, 16, "qkv", grid32, grid32),
            ("MASt3R pretraining decoder self", 4, 1024, 12, "qkv", grid32, grid32),
            ("MASt3R pretraining decoder cross", 4, 1024, 12, "separate", grid32, grid32)):
        rope_pair_case(rep, g, dev, where, B, N, H, f32, kind, qpos, kpos)
    if not rep.ok:
        raise AssertionError("pretrain: a kernel disagrees with its plain version at the "
                             "pretraining shapes")
    log(f"pretrain: (a) kernels at the pretraining shapes OK [{gpu}]")


def pt_face_forward(model, batch, z_mean: float = 2.0) -> None:
    """Mast3rTeacher.face_forward for a Mast3r being trained: rescale both
    DPT heads' last conv so that on this batch x, y, z have unit spread
    around (0, 0, z_mean) and the conf channel unit spread around 0. flax's
    lecun-normal init leaves those channels O(10-100) at full width: pts3d
    = xyz / |xyz| * expm1(|xyz|) and conf = 1 + exp(c) then overflow fp32 on
    some pairs (gd3d's init draws the same distributions). The conv stays
    linear, so this is only another random init of it."""
    import torch

    from gd3d_torch.teachers.mast3r import no_tf32

    heads = (model.downstream_head1, model.downstream_head2)
    outs = []
    hooks = [h.dpt.head[4].register_forward_hook(lambda m, i, o: outs.append(o)) for h in heads]
    try:
        with torch.no_grad(), no_tf32():
            model(batch["img1"], batch["img2"])
    finally:
        for hook in hooks:
            hook.remove()
    with torch.no_grad():
        for head, out in zip(heads, outs):
            ch = out[:, :4]  # (2B, 4, H, W): xyz and conf, NCHW inside the head
            mean, std = ch.mean(dim=(0, 2, 3)), ch.std(dim=(0, 2, 3))
            conv = head.dpt.head[4]
            conv.weight[:4] /= std[:, None, None, None]
            conv.bias[:4] = (conv.bias[:4] - mean) / std
            conv.bias[2] += z_mean


def check_pretrain_run(dev, name: str, argv: list, objective: str, steps: int,
                       gpu: str, out) -> dict:
    """One pretraining CLI run at full width, counted from its first step:
    the launches a step at each length, finite losses and details, every
    trained tensor moved, the steady step time and peak memory; then one
    more step profiled. Through the CLI's on_start hook, before step 0: with
    --init-trunk, the weights hold the trunk file's tensors bit for bit; a
    MASt3R is face-forwarded on step 0's batch (pt_face_forward); the
    starting weights are kept, and the launch counts and the peak memory
    are reset. Returns the run's launches."""
    import numpy as np
    import torch

    from gd3d_torch.cli import pretrain as pt_cli
    from gd3d_torch.convert import mast3r_params
    from gd3d_torch.kernels import reset_launch_counts

    start = {}

    def on_start(model, device_batch):
        if "--init-trunk" in argv:
            trunk = argv[argv.index("--init-trunk") + 1]
            own = mast3r_params(model.state_dict())
            with np.load(trunk) as t:
                bad = [k for k in t.files if not np.array_equal(t[k], own[k])]
                log(f"pretrain: {name}'s weights before step 0 hold the trunk file: "
                    f"{len(t.files) - len(bad)} of {len(t.files)} trunk tensors equal "
                    f"{'OK' if not bad else 'FAIL ' + str(bad[:4])} [{gpu}]")
            if bad:
                raise AssertionError("pretrain: --init-trunk did not load the exported trunk")
        if objective == "mast3r":
            pt_face_forward(model, device_batch(1))  # step 0's batch (--seed 0)
        start.update({k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()

    run_argv = [*argv, "--steps", str(steps)]
    res, c, c_by, wall, peak = _counted_run(lambda: pt_cli.main(
        ["--output", str(out), *run_argv], on_start=on_start))
    got, want, launches_ok = pt_launches(c, c_by, name if name == "co3d" else objective, steps)
    losses = [r["loss"] for r in res["records"]]
    final = res["model"].state_dict()
    same = [k for k, v in start.items() if torch.equal(v, final[k].cpu())]
    n_params = sum(p.numel() for p in res["model"].parameters())
    step_s = res["step_s"]
    ok = launches_ok and all(math.isfinite(v) for r in res["records"] for v in r.values()) \
        and not same
    details = {k: v for k, v in res["records"][-1].items() if k not in ("step", "loss")}
    log(f"pretrain: {name} ({objective}) at full width ({n_params / 1e6:.1f} M parameters) "
        f"{' '.join(run_argv)}: losses {[round(v, 4) for v in losses]} (last step's details "
        f"{details}); step s {[round(v, 4) for v in step_s]} (steady "
        f"{float(np.median(step_s[1:])):.4f} s a step), wall {wall:.2f} s, peak_mem_gib "
        f"{peak:.3f}; {len(start) - len(same)} of {len(start)} trained tensors moved "
        f"{'(unmoved: ' + str(same[:4]) + ')' if same else ''}; launches {got} (want {want}, "
        f"by length {c_by['K1']} {c_by['K2']} {c_by['K5']}) {'OK' if ok else 'FAIL'} [{gpu}]")
    if not ok:
        raise AssertionError(f"pretrain: the {name} run's launches, losses or updates are wrong")
    del start, final
    batch = res["device_batch"](12345)
    step = res["step"]
    idle = profile_call(f"pretrain {name}", lambda: step(batch), "train step")
    log(f"pretrain: {name} train step idle share {idle:.3f} [{gpu}]")
    del res, batch, step
    torch.cuda.empty_cache()
    return c


def _step_state(opt, metrics) -> tuple:
    return (float(metrics["loss"]), {k: p.grad.cpu() for k, p in opt.params.items()},
            {k: v.cpu() for k, v in opt.adamw.mu.items()},
            {k: v.cpu() for k, v in opt.adamw.nu.items()},
            {k: p.detach().cpu() for k, p in opt.params.items()})


def check_pretrain_agree(dev, root, gpu: str) -> None:
    """(e) one step of each objective on a small model (head dim 64) on the
    card against the CPU plain path from shared weights on one batch, then
    through the CLI on the card a straight 4-step run against a 2 + 2
    resumed one."""
    import copy

    import numpy as np
    import torch

    from gd3d_torch.cli import pretrain as pt_cli
    from gd3d_torch.distill.pretrain import (
        PretrainOptimizer, build_croco_pretrain_step, build_mast3r_pretrain_step)
    from gd3d_torch.models.croco import CrocoConfig

    small = CrocoConfig(**PT_SMALL)
    for objective in ("croco", "mast3r"):
        flags = ["--objective", objective, "--tiny", "--batch", "2", "--corres", "32"]
        args = pt_cli.parse_args(["--output", "x", *flags, "--device", "cpu"])
        ref = pt_cli.build_model(args, torch.device("cpu"), croco=small)
        batch = pt_cli.make_batch_fn(args, 16)(7)
        runs = []
        for device in (torch.device("cpu"), dev):
            model = copy.deepcopy(ref).to(device)
            opt = PretrainOptimizer(model, lambda count: 1e-4, 1.0)
            step = (build_croco_pretrain_step(model, opt) if objective == "croco"
                    else build_mast3r_pretrain_step(model, opt, {"matching_weight": 0.075}))
            runs.append(_step_state(opt, step(pt_cli.to_device(batch, device))))
        (lc, *cpu), (lg, *card) = runs

        def worst(a, b):
            return max(float((a[k] - b[k]).abs().max() / max(float(b[k].abs().max()), 1e-12))
                       for k in b)

        errs = {n: worst(g, w) for n, g, w in zip(("grads", "mu", "nu"), card[:3], cpu[:3])}
        top = max(float(w.abs().max()) for w in cpu[3].values())
        w_max = max(float((card[3][k] - cpu[3][k]).abs().max()) for k in cpu[3])
        w_err = pt_rel_l2({k: v.numpy() for k, v in card[3].items()},
                          {k: v.numpy() for k, v in cpu[3].items()})
        loss_err = abs(lg - lc) / abs(lc)
        ok = (loss_err <= PT_LOSS_TOL and w_err <= RESUME_TOL
              and all(math.isfinite(e) and e <= PT_STATE_TOL for e in errs.values()))
        log(f"pretrain: card against CPU, one {objective} step of a small model (head dim 64, "
            f"64^2, batch 2): loss {lg:.6f} vs {lc:.6f} rel {loss_err:.3e} (tol "
            f"{PT_LOSS_TOL:g}); worst tensor " + " ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + f" (tol {PT_STATE_TOL:g} of its max); weights {w_err:.3e} relative L2 (tol "
            f"{RESUME_TOL:g}; the largest element difference {w_max:.3e}, "
            f"{w_max / top:.3e} of the largest weight, {w_max / 1e-4:.3f} lr) "
            f"{'OK' if ok else 'FAIL'} [{gpu}]")
        if not ok:
            raise AssertionError(f"pretrain: the card's {objective} step disagrees with the CPU's")

        # straight 4 steps against 2 + 2 resumed, through the CLI on the card
        base = [*flags, "--warmup", "2"]
        straight = pt_cli.main(["--output", str(root / f"{objective}_a"), *base, "--steps", "4"],
                               croco=small)
        b = root / f"{objective}_b"
        pt_cli.main(["--output", str(b), *base, "--steps", "2", "--ckpt-every", "2"], croco=small)
        resumed = pt_cli.main(["--output", str(b), *base, "--steps", "4", "--resume",
                               str(b / "state_last.npz")], croco=small)
        ra = [json.loads(x) for x in (root / f"{objective}_a" / "metrics.jsonl").read_text().splitlines()]
        rb = [json.loads(x) for x in (b / "metrics.jsonl").read_text().splitlines()]
        rec_err = max(abs(x[k] - y[k]) / max(abs(x[k]), 1e-6)
                      for x, y in zip(ra, rb) for k in x) if len(ra) == len(rb) == 4 else math.inf
        with np.load(root / f"{objective}_a" / "params_final.npz") as za, \
                np.load(b / "params_final.npz") as zb:
            fin_err = pt_rel_l2({k: zb[k] for k in zb.files}, {k: za[k] for k in za.files})
        so, ro = straight["optimizer"].state_dict(), resumed["optimizer"].state_dict()
        mom_err = {m: pt_rel_l2({k: v.cpu().numpy() for k, v in ro.items() if k.startswith(m)},
                                {k: v.cpu().numpy() for k, v in so.items() if k.startswith(m)})
                   for m in ("mu/", "nu/")}
        counts_ok = int(so["count"]) == int(ro["count"]) == 4
        ok = (rec_err <= RESUME_TOL and fin_err <= RESUME_TOL and counts_ok
              and all(e <= PT_STATE_TOL for e in mom_err.values()))
        log(f"pretrain: {objective} straight 4 steps against 2 + 2 resumed on the card: records "
            f"{rec_err:.3e} (tol {RESUME_TOL:g}), final weights {fin_err:.3e} relative L2 (tol "
            f"{RESUME_TOL:g}), moments " + " ".join(f"{k[:-1]} {e:.3e}" for k, e in
                                                     mom_err.items())
            + f" (tol {PT_STATE_TOL:g}), AdamW counts {int(so['count'])} {int(ro['count'])} "
            f"{'OK' if ok else 'FAIL'} [{gpu}]")
        if not ok:
            raise AssertionError(f"pretrain: the resumed {objective} run differs from the "
                                 "straight one")


def check_pretrain(dev) -> dict:
    """The pretrain phase: (a) the kernels at the pretraining shapes, (b)
    CroCo at full width, exporting the DUSt3R trunk, (c) MASt3R at 512^2
    from that trunk (its load checked before step 0), (d) MASt3R on a
    fabricated Co3D-v2 tree, (e) the card against the CPU and a resumed run
    on a small model. Returns the launches of (b), (c) and (d)."""
    import tempfile
    from pathlib import Path

    from gd3d_torch.data.fixtures import write_co3d_tree
    from gd3d_torch.teachers.mast3r import no_tf32

    gpu = gpu_line()
    t0 = time.perf_counter()
    counts = {k: 0 for k in REPLACES}
    with no_tf32():
        check_pretrain_kernels(dev, gpu)
    log(f"pretrain: (a) done at {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        c_argv = ["--objective", "croco", "--export-dust3r", "--batch", "16", "--img", "224"]
        for k, v in check_pretrain_run(dev, "croco", c_argv, "croco", PT_STEPS, gpu,
                                       root / "croco").items():
            counts[k] += v
        log(f"pretrain: (b) done at {time.perf_counter() - t0:.1f} s")
        m_argv = ["--objective", "mast3r", "--init-trunk", str(root / "croco" / "dust3r_trunk.npz"),
                  "--img", "512", "--batch", "2", "--corres", "256"]
        for k, v in check_pretrain_run(dev, "mast3r", m_argv, "mast3r", PT_STEPS, gpu,
                                       root / "mast3r").items():
            counts[k] += v
        log(f"pretrain: (c) done at {time.perf_counter() - t0:.1f} s")
        co3d = write_co3d_tree(root / "co3d_tree")
        d_argv = ["--objective", "mast3r", "--co3d-root", str(co3d), "--img", "224", "--batch",
                  "2", "--corres", "256"]
        for k, v in check_pretrain_run(dev, "co3d", d_argv, "mast3r", 2, gpu,
                                       root / "co3d").items():
            counts[k] += v
        log(f"pretrain: (d) done at {time.perf_counter() - t0:.1f} s")
        check_pretrain_agree(dev, root, gpu)
        log(f"pretrain: (e) done at {time.perf_counter() - t0:.1f} s")
    return counts


# The datagen phase: the objaverse MASt3R path's flash launches a step on
# the rendered 512^2 tree (the train phase's synthetic run has the same
# lengths)
DATAGEN_MAST3R = (("K1", "float32", (4801, 769), 20), ("K2", "float32", (4801, 769), 12),
                  ("K1", "float32", (768,), 48))


def check_datagen(dev) -> dict:
    """The datagen phase (see the module docstring, 14): the render and
    preprocessing CLIs on the host, their trees against the committed
    digests of gd3d's, each preprocessed tree through its reader, and 2
    full-width objaverse MASt3R steps on the rendered tree. Returns the
    launches of (c)."""
    import contextlib
    import io
    import multiprocessing
    import os
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    from pathlib import Path

    import numpy as np

    from gd3d_torch.cli import preprocess, render
    from gd3d_torch.data import fixtures
    from gd3d_torch.data import stereo_views as sv

    gpu = gpu_line()
    ref = json.loads(fixtures.DATAGEN_DIGESTS.read_text())
    bad, trees = [], []

    quiet = contextlib.redirect_stdout(io.StringIO())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        glb_root = tmp / "assets"
        fixtures.write_glb(glb_root / fixtures.GLB_NAME)
        for run in fixtures.RENDER_RUNS:
            t0 = time.perf_counter()
            with quiet:
                poses = render.main(fixtures.render_argv(run, glb_root, tmp / "render" / run))
            dt = time.perf_counter() - t0
            objects = [d for d in (tmp / "render" / run).iterdir() if d.is_dir()]
            views = len(objects) * len(poses)
            log(f"datagen: render {run}: {len(objects)} objects x {len(poses)} views at 512^2 in "
                f"{dt:.3f} s, {dt / views:.4f} host s a view (the card's machine; {gpu})")
            trees.append(("render", run, tmp / "render" / run))
        for dataset in fixtures.RAW_DATASETS + ("habitat",):
            if dataset == "megadepth":  # its HDF5 depth: the formats phase's (c)
                continue
            spec = None if dataset == "habitat" else fixtures.write_raw_tree(
                dataset, tmp / "raw" / dataset)
            out = tmp / "pre" / dataset
            t0 = time.perf_counter()
            with quiet:
                preprocess.main(fixtures.preprocess_argv(dataset, spec, out))
            dt = time.perf_counter() - t0
            frames = sum(1 for p in out.rglob("*") if p.suffix.lower() in (".jpg", ".jpeg"))
            log(f"datagen: preprocess {dataset}: {frames} frames in {dt:.3f} s, "
                f"{dt / frames:.4f} host s a frame ({gpu})")
            trees.append(("preprocess", dataset, out))
            cls, kw = fixtures.TREE_VIEWS[dataset]
            ds = getattr(sv, cls)(str(out), resolution=(224, 224), seed=1, **kw)
            batch = sv.views_pretrain_batch(ds, [0], np.random.RandomState(0), n_corres=256)
            finite = all(np.isfinite(np.asarray(batch[k], np.float64)).all()
                         for k in ("img1", "img2"))
            log(f"datagen: {cls} on it: {len(ds)} pairs, a batch of img1 "
                f"{tuple(batch['img1'].shape)}, valid correspondences "
                f"{int(np.asarray(batch['gt1']['valid_corres']).sum())}/256, finite {finite} "
                f"{'OK' if finite and len(ds) else 'FAIL'}")
            if not (finite and len(ds)):
                bad.append(f"{dataset} reader")
        # every file of every tree decoded, in a pool: the JPEGs' Python
        # entropy decode is most of the phase's host time
        t0 = time.perf_counter()
        workers = min(8, os.cpu_count() or 1)
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            for kind, name, tree in trees:
                files = fixtures.tree_files(tree)
                got = dict(zip(files, pool.map(fixtures.file_digest, [tree / f for f in files])))
                wrong = fixtures.mismatches(got, ref[kind][name])
                log(f"datagen: {kind} {name}: {len(got)} files, decoded digests equal gd3d's "
                    f"committed ones {not wrong} {'OK' if not wrong else 'FAIL ' + str(wrong[:4])}")
                if wrong:
                    bad.append(f"{kind} {name}")
        log(f"datagen: every tree decoded and digested in {time.perf_counter() - t0:.2f} s "
            f"({workers} processes)")
        if bad:
            raise AssertionError(f"datagen: {bad}")

        root = tmp / "objaverse"
        names = []
        for run in fixtures.RENDER_RUNS:
            for d in sorted(p for p in (tmp / "render" / run).iterdir() if p.is_dir()):
                shutil.copytree(d, root / "objaverse_renderings" / d.name)
                names.append(d.name)
        (root / "10k.txt").write_text("\n".join(names) + "\n")
        shutil.copyfile(tmp / "render" / "procedural" / "obj_poses.npy", root / "obj_poses.npy")
        res = run_cli("datagen objaverse MASt3R",
                      ["--config", "finetune_timm_mast3r_objaverse", "--data-root", str(root),
                       "--epochs", "1", "--steps-per-epoch", "2", "--workers", "0"],
                      tmp / "train", DATAGEN_MAST3R, KERNELS,
                      # a few keypoints a pair on these small objects: the
                      # intra-depth loss, the depth head's only one, is 0
                      ("depth_diff_head.",), profile=False)
    return res["counts"]


# ---------------------------------------------------------------------------
# formats: the decoders of every file gd3d reads (gd3d_torch/data/{jpeg,png,
# bmp,webp,vp8,vp8l,exr,hdf5}.py)
# ---------------------------------------------------------------------------
FORMATS_NITER = 30


def formats_dir():
    from pathlib import Path

    return Path(__file__).resolve().parent / "gd3d_torch" / "data" / "testdata" / "formats"


def _write_exr():
    """tests/exr_writer.py's write_exr, loaded from its file alone: the port
    writes no EXR, so the EXR fixtures of (a) and (d) come from the tests'
    numpy writer."""
    import importlib.util

    path = formats_dir().parents[3] / "tests" / "exr_writer.py"
    spec = importlib.util.spec_from_file_location("exr_writer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.write_exr


def _view_mismatches(got, want, where=""):
    """Where two stereo-view items (nested dicts, lists and arrays) differ:
    keys, lengths, dtypes, shapes or values."""
    import numpy as np

    if isinstance(want, dict):
        if set(got) != set(want):
            return [f"{where}: keys {sorted(set(got) ^ set(want))}"]
        return [m for k in want for m in _view_mismatches(got[k], want[k], f"{where}/{k}")]
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return [f"{where}: length {len(got)} != {len(want)}"]
        return [m for i, (g, w) in enumerate(zip(got, want))
                for m in _view_mismatches(g, w, f"{where}[{i}]")]
    if isinstance(want, np.ndarray):
        same = (isinstance(got, np.ndarray) and got.dtype == want.dtype
                and got.shape == want.shape and np.array_equal(got, want, equal_nan=
                                                               want.dtype.kind == "f"))
        return [] if same else [f"{where}: arrays differ"]
    return [] if got == want else [f"{where}: {got!r} != {want!r}"]


def _formats_digest(kind, name):
    """The port's array of one committed fixture (as
    tests/test_torch_formats_wiring.py takes it), and the seconds its
    decode took."""
    import hashlib

    import numpy as np

    from gd3d_torch.data import exr, flowio, hdf5, images

    root = formats_dir()
    t0 = time.perf_counter()
    if kind == "image":
        arr = images.decode_rgb((root / name).read_bytes(), name, composite=False)
    elif kind == "view":
        arr = images.load_image_mast3r(str(root / "views" / name), 512)["img"]
    elif kind == "exr":
        arr = exr.read_exr(root / name)
    elif kind == "hdf5":
        arr = hdf5.read_dataset(root / name, "depth")
    else:
        arr = flowio.read_gt(str(root / name), "stereo" if name.endswith(".h5") else "flow")
    dt = time.perf_counter() - t0
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest(), dt, arr


def check_formats_fixtures(tmp, gpu: str) -> None:
    """(a): every committed fixture to its digest, and the host ms per decode
    at the sizes users meet."""
    import struct

    import numpy as np

    from gd3d_torch.data import bmp, exr, hdf5

    write_exr = _write_exr()
    digests = json.loads((formats_dir() / "digests.json").read_text())
    bad, ms, decoded = [], {}, {}
    for kind, entries in sorted(digests.items()):
        for name, want in sorted(entries.items()):
            got, dt, arr = _formats_digest(kind, name)
            ms[name] = dt * 1e3
            decoded[name] = arr
            if got != want:
                bad.append(f"{kind} {name}")
    n = sum(len(v) for v in digests.values())
    log(f"formats: (a) {n} committed fixtures decoded to their digests (PIL's RGB, gd3d's "
        f"load_image_mast3r, the EXR writer's values, h5py's arrays, gd3d's flowio) "
        f"{not bad} {'OK' if not bad else 'FAIL ' + str(bad)}")
    # the same pixels as a 512x384 24-bit BMP, and 1024x768 EXR and HDF5 depth
    rgb = decoded["lossy_512x384.webp"]
    h, w = rgb.shape[:2]
    rows = rgb[::-1, :, ::-1].tobytes()
    (tmp / "big.bmp").write_bytes(b"BM" + struct.pack("<IHHI", 54 + len(rows), 0, 0, 54)
                                  + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(rows),
                                                2835, 2835, 0, 0) + rows)
    t0 = time.perf_counter()
    got = bmp.pil_rgb(bmp.decode_bmp(tmp / "big.bmp"))
    ms["bmp 512x384"] = (time.perf_counter() - t0) * 1e3
    ok_bmp = np.array_equal(got, rgb)
    yy, xx = np.mgrid[0:768, 0:1024]
    depth = (2.0 + np.sin(yy / 37.0) + np.cos(xx / 53.0)).astype(np.float32)
    depth = np.round(depth * 1024) / 1024
    write_exr(tmp / "big.exr", depth, "ZIP")
    t0 = time.perf_counter()
    ok_exr = np.array_equal(exr.read_exr(tmp / "big.exr"), depth)
    ms["exr 1024x768 ZIP"] = (time.perf_counter() - t0) * 1e3
    hdf5.write_dataset(tmp / "big.h5", "depth", depth)
    t0 = time.perf_counter()
    ok_h5 = np.array_equal(hdf5.read_dataset(tmp / "big.h5", "depth"), depth)
    ms["hdf5 1024x768 gzip"] = (time.perf_counter() - t0) * 1e3
    ok = not bad and ok_bmp and ok_exr and ok_h5
    log(f"formats: (a) host ms per decode (the card's machine; {gpu}): "
        f"progressive JPEG 854x480 4:2:0 {ms['progressive_854x480.jpg']:.1f}, lossy WebP "
        f"512x384 {ms['lossy_512x384.webp']:.1f}, lossless WebP 512x384 "
        f"{ms['lossless_512x384.webp']:.1f}, 24-bit BMP 512x384 {ms['bmp 512x384']:.1f} "
        f"(equal {ok_bmp}), ZIP EXR 1024x768 {ms['exr 1024x768 ZIP']:.1f} (equal {ok_exr}), "
        f"chunked gzip HDF5 1024x768 {ms['hdf5 1024x768 gzip']:.1f} (equal {ok_h5}); "
        f"the rest: " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(ms.items())
                                  if "512x384" not in k and "854x480" not in k
                                  and "1024x768" not in k)
        + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("formats: a decoder disagrees with its fixture")


def check_formats_align(dev, tmp, gpu: str) -> dict:
    """(b): the align CLI on the four views with the full-width fp32 MASt3R
    teacher. Returns its launches."""
    import shutil

    import numpy as np
    import torch

    from gd3d_torch.cli import align as align_cli
    from gd3d_torch.data.images import load_image_mast3r
    from gd3d_torch.teachers.mast3r import Mast3rTeacher

    digests = json.loads((formats_dir() / "digests.json").read_text())["view"]
    views = tmp / "views"
    shutil.copytree(formats_dir() / "views", views)
    loaded_ok = all(_formats_digest("view", n)[0] == d for n, d in digests.items())
    with torch.device(dev):
        teacher = Mast3rTeacher()
    teacher.init_params(torch.Generator(device=dev).manual_seed(15))
    teacher.eval()
    images = torch.from_numpy(np.stack([load_image_mast3r(str(v))["img"]
                                        for v in sorted(views.iterdir())])).to(dev)
    teacher.face_forward(images[:1], images[1:2])
    res, c, c_by, wall, peak = _counted_run(lambda: align_cli.main(
        ["--images", str(views), "--output", str(tmp / "align"), "--sparse", "0",
         "--niter", str(FORMATS_NITER)], teacher=teacher))
    loss = _check_scene_npz(tmp / "align" / "scene.npz", True, ALIGN_VIEWS, FORMATS_NITER)
    launches_ok = (c_by["K1"] == ALIGN_TEACHER_LAUNCHES["K1"]
                   and c["K5"] == ALIGN_TEACHER_LAUNCHES["K5"]
                   and all(v == 0 for k, v in c.items() if k not in ("K1", "K5")))
    st = res["stats"]
    ok = loaded_ok and launches_ok
    log(f"formats: (b) align CLI dense --niter {FORMATS_NITER} on "
        f"{sorted(p.name for p in views.iterdir())}: loaded arrays equal gd3d's "
        f"load_image_mast3r digests {loaded_ok}; {st['pairs']} pairs, teacher call "
        f"{st['teacher_s']:.3f} s, wall {wall:.2f} s, peak_mem_gib {peak:.3f}; {loss}; "
        f"launches {c}, K1 {c_by['K1']} (want {ALIGN_TEACHER_LAUNCHES}) "
        f"{'OK' if ok else 'FAIL'} [{gpu}]")
    if not ok:
        raise AssertionError("formats: the align run on the four formats is wrong")
    del teacher, images
    torch.cuda.empty_cache()
    return c


def check_formats_trees(tmp) -> None:
    """(c) MegaDepth from its HDF5 depth, (d) an EXR-only tree, (e) the HDF5
    stereo and flow ground truth."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from gd3d_torch.cli import preprocess
    from gd3d_torch.data import fixtures, flowio
    from gd3d_torch.data import stereo_views as sv

    quiet = contextlib.redirect_stdout(io.StringIO())
    write_exr = _write_exr()

    # (c) MegaDepth from its HDF5 depth
    ref = json.loads(fixtures.DATAGEN_DIGESTS.read_text())["preprocess"]["megadepth"]
    spec = fixtures.write_raw_tree("megadepth", tmp / "raw" / "megadepth")
    t0 = time.perf_counter()
    with quiet:
        preprocess.main(fixtures.preprocess_argv("megadepth", spec, tmp / "megadepth"))
    dt = time.perf_counter() - t0
    got = {f: fixtures.file_digest(tmp / "megadepth" / f)
           for f in fixtures.tree_files(tmp / "megadepth")}
    wrong = fixtures.mismatches(got, ref)
    cls, kw = fixtures.TREE_VIEWS["megadepth"]
    ds = getattr(sv, cls)(str(tmp / "megadepth"), resolution=(224, 224), seed=1, **kw)
    batch = sv.views_pretrain_batch(ds, [0], np.random.RandomState(0), n_corres=256)
    finite = all(np.isfinite(np.asarray(batch[k], np.float64)).all() for k in ("img1", "img2"))
    ok_c = not wrong and finite and len(ds) > 0
    log(f"formats: (c) MegaDepth preprocessed from .h5 depth in {dt:.3f} s: {len(got)} files "
        f"equal gd3d's committed digests {not wrong}; {cls}: {len(ds)} pairs, a finite batch "
        f"{finite} {'OK' if ok_c else 'FAIL ' + str(wrong[:4])}")
    # (d) an EXR-only BlendedMVS tree against its .npy twin
    spec = fixtures.write_raw_tree("blendedmvs", tmp / "raw" / "blendedmvs")
    with quiet:
        preprocess.main(fixtures.preprocess_argv("blendedmvs", spec, tmp / "bmvs_npy"))
    shutil.copytree(tmp / "bmvs_npy", tmp / "bmvs_exr")
    sibs = sorted((tmp / "bmvs_exr").rglob("*.exr.npy"))
    for npy in sibs:
        write_exr(str(npy)[:-4], np.load(npy), "ZIP")
        npy.unlink()
    cls, kw = fixtures.TREE_VIEWS["blendedmvs"]
    a = getattr(sv, cls)(str(tmp / "bmvs_npy"), resolution=(224, 224), seed=1, **kw)
    b = getattr(sv, cls)(str(tmp / "bmvs_exr"), resolution=(224, 224), seed=1, **kw)
    diff = [m for idx in range(min(len(a), 2)) for m in _view_mismatches(b[idx], a[idx],
                                                                         f"{cls}[{idx}]")]
    same = len(a) == len(b) > 0 and bool(sibs) and not diff
    log(f"formats: (d) {cls} on an EXR-only tree ({len(sibs)} ZIP depth files) equals the "
        f".npy tree, items 0-1 {same} {'OK' if same else 'FAIL ' + str(diff[:4])}")
    # (e) HDF5 stereo and flow ground truth
    flowd = json.loads((formats_dir() / "digests.json").read_text())["flowio"]
    ok_e = all(_formats_digest("flowio", n)[0] == d for n, d in flowd.items())
    flow = np.random.RandomState(0).randn(97, 131, 2).astype(np.float32)
    flowio.write_flo5(str(tmp / "w.flo5"), flow)
    round_trip = np.array_equal(flowio.read_gt(str(tmp / "w.flo5"), "flow"), flow)
    ok_e &= round_trip
    log(f"formats: (e) {sorted(flowd)} through flowio.read_gt to gd3d's digests, write_flo5 "
        f"round trip {round_trip} {'OK' if ok_e else 'FAIL'}")
    if not (ok_c and same and ok_e):
        raise AssertionError("formats: (c), (d) or (e) failed")


def check_formats(dev) -> dict:
    """The formats phase (see the module docstring, 15). Returns the launches
    of (b)."""
    import tempfile
    from pathlib import Path

    gpu = gpu_line()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        check_formats_fixtures(tmp, gpu)
        counts = check_formats_align(dev, tmp, gpu)
        check_formats_trees(tmp)
    log(f"formats: phase {time.perf_counter() - t_phase:.1f} s (host work and the align run; "
        f"{gpu})")
    return counts


def main() -> int:
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from gd3d_torch.kernels import build
    from gd3d_torch.teachers.mast3r import no_tf32

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    gpu = gpu_line()
    log(f"gpu: {gpu}")
    t0 = time.perf_counter()
    report = build.build()
    build.library()
    log(f"build: {build.library_path().name} in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"build: {line.strip()}")
    for line in sm90_resources(report):
        log(f"build: sm90 {line}")

    with no_tf32():
        kernels = check_kernels(dev)
    log(f"phase: kernels done at {time.perf_counter() - t_start:.1f} s")
    counts = {k: 0 for k in REPLACES}
    # the fp32 student at its lengths (2, 4161) and (2, 673): 8 main-pass
    # blocks from lora_start_block on and 4 cost-pass blocks take a backward
    fp32_student = (("K2", "float32", (4161, 673), 12), ("K1", "float32", (4161, 673), 20))
    runs = (("MASt3R", mast3r_setup, check_mast3r_teacher, ()),
            ("MASt3R fp32 student",
             lambda d: mast3r_setup(d, student_dtype="float32"), None, fp32_student),
            ("VGGT", vggt_setup, None, ()))
    for name, setup, check, expect in runs:
        for k, n in run_steps(name, setup, dev, n_steps=2, check_teacher=check,
                              expect=expect).items():
            counts[k] += n
        torch.cuda.empty_cache()
        log(f"phase: {name} steps done at {time.perf_counter() - t_start:.1f} s")
    with no_tf32():
        check_agreement(dev)
    log(f"phase: agree done at {time.perf_counter() - t_start:.1f} s")
    train_counts, vggt_steps = check_train(dev)
    for k, n in train_counts.items():
        counts[k] += n
    log(f"phase: train done at {time.perf_counter() - t_start:.1f} s")
    for k, n in check_eval(dev).items():
        counts[k] += n
    log(f"phase: eval done at {time.perf_counter() - t_start:.1f} s")
    for k, n in check_data(dev).items():
        counts[k] += n
    log(f"phase: data done at {time.perf_counter() - t_start:.1f} s")
    for k, n in check_pose(dev).items():
        counts[k] += n
    log(f"phase: pose done at {time.perf_counter() - t_start:.1f} s")
    for k, n in check_surface(dev, vggt_steps).items():
        counts[k] += n
    log(f"phase: surface done at {time.perf_counter() - t_start:.1f} s")
    for k, n in check_align(dev).items():
        counts[k] += n
    log(f"phase: align done at {time.perf_counter() - t_start:.1f} s")
    with no_tf32():
        sga_counts = check_sparse_ga(dev)
    for k, n in sga_counts.items():
        counts[k] += n
    log(f"phase: sparse_ga done at {time.perf_counter() - t_start:.1f} s")
    for k, n in check_stereoflow(dev).items():
        counts[k] += n
    log(f"phase: stereoflow done at {time.perf_counter() - t_start:.1f} s")
    for k, n in check_pretrain(dev).items():
        counts[k] += n
    log(f"phase: pretrain done at {time.perf_counter() - t_start:.1f} s")
    for k, n in check_datagen(dev).items():
        counts[k] += n
    log(f"phase: datagen done at {time.perf_counter() - t_start:.1f} s")
    for k, n in check_formats(dev).items():
        counts[k] += n
    log(f"phase: formats done at {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"kernels": [
        {"name": f"{k} {REPLACES[k][0]}", "route": "cuda", "source": REPLACES[k][1],
         "replaces": REPLACES[k][2], "launches": counts[k], **kernels[k]}
        for k in REPLACES]}))
    log(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
