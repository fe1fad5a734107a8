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
              and K2 in bf16 and fp32 at the four student shapes; K2 at the
              MASt3R student's main shape in both dtypes, and K4 and K4b at
              the MASt3R keypoint count, run twice and must give the same
              bits; K5 on one tensor and on each main-path layer's q and k in
              one launch;
  2. steps    three full-width MASt3R distillation steps (ViT-B/16 bf16
              student, MASt3R ViT-L/Base-decoder fp32 teacher, 336x512
              teacher and 512^2 student frames), three more with the
              student at its configured fp32 (the named config as gd3d's
              trainer runs it: 12 fp32 K2 and 20 fp32 K1 launches at the
              student's lengths a step, asserted), then three full-width
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
              digests, with host ms per decode and resize, and the
              progressive fixture refused; (b) the fp32 K1 at the eval's
              shapes, (8,1601,12,64) and (4,5986,12,64), in the kernels
              phase's format; (c) the card against the CPU plain path on
              shared weights: dense_grid_features at stride 8 on a 464x848
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
              JPEGs, --workers min(8, CPUs), 6 steps: 20 fp32 K1 at the
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
              solvePnPRansac answers on ~40 recorded scenes
              (gd3d_torch/eval/testdata/pnp_cv2.npz): the same inlier sets,
              poses within 1e-6 of their norm, host ms a RANSAC call and its
              iterations; (b) the fp32 K1 at (1,4097,12,64) in the kernels
              phase's format, and the card against the CPU plain path:
              frame_descriptors of a 512^2 frame (TOL) and mutual_nn_match
              on identical descriptors (equal indices); (c)
              gd3d_torch.cli.evaluate.main(["--pose", ...]) at full width on
              a fabricated tree (a known-answer object, asserted 1.0 at every
              threshold, and a 128 000-row template bank): 12 fp32 K1
              launches at N = 4097 a frame, seconds a frame by stage, RANSAC
              iterations, frames/s, peak memory; (d) the FiT3D harness's
              compare with run_pose (refine=False asserted); (e) the DUSt3R
              tracker on 4 frames of 336x512: 48 K1 and 72 K5 a pair
              forward, tracks against the plain twins' (TRACK_EQUAL_SHARE).

  9. surface gd3d's step options, TensorBoard and data-parallel training
              (check_surface): (a) three MASt3R steps in bench.py's bf16
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

Then one JSON line of the kernels (launches: the steps, train, eval, data,
pose and surface phases' runs together), the card line, and last the JSON result line. Exits non-zero, printing no result, without a CUDA device or if any
phase fails. The kernels and agree phases compare fp32 results too, so they
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
REPLACES = {
    "K1": ("flash_attention_fwd", "gd3d_torch/csrc/flash_fwd.cu",
           "gd3d/ops/attention.py:180"),
    "K2": ("flash_attention_bwd_fused", "gd3d_torch/csrc/flash_bwd.cu",
           "gd3d/kernels/flash_bwd_fused.py:262"),
    "K3": ("masked_softmax_kl_rows", "gd3d_torch/csrc/cost_kl.cu",
           "gd3d/kernels/cost_kl.py:59"),
    "K4": ("pairwise_rank_fwd", "gd3d_torch/csrc/pairwise_rank.cu",
           "gd3d/kernels/pairwise_rank.py:235"),
    "K4b": ("pairwise_rank_bwd", "gd3d_torch/csrc/pairwise_rank.cu",
            "gd3d/kernels/pairwise_rank.py:309"),
    "K5": ("rope2d_fwd", "gd3d_torch/csrc/rope2d.cu", "gd3d/kernels/rope2d.py:58"),
}
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
              run_library=None, designated=False, peak=None):
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
            self.results[kern].update(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                      library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def check_kernels(dev) -> dict:
    """Each kernel against its plain twin on the same inputs, at the shapes
    the main paths give it."""
    import torch
    import torch.nn.functional as F

    from gd3d_torch.kernels.cost_kl import _reference_rows, masked_softmax_kl_fwd
    from gd3d_torch.kernels.flash_bwd_fused import (
        flash_attention_bwd_fused, flash_attention_bwd_plain)
    from gd3d_torch.kernels.flash_fwd import flash_attention_fwd, flash_attention_fwd_plain
    from gd3d_torch.kernels.pairwise_rank import (
        pairwise_rank_bwd, pairwise_rank_bwd_plain, pairwise_rank_fwd,
        pairwise_rank_sums_plain, pairwise_ranking_sums)
    from gd3d_torch.kernels.rope2d import rope2d_fwd, rope2d_plain, rope2d_qk_fwd
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
    ]
    for kern, where, B, N, H, D, dt, designated in attn_cases:
        # q, k, v as the strided (B, N, H, D) views of one qkv projection
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
            if designated:  # every sum runs in a fixed order: the same bits again
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
                designated=designated and dt == f32,  # the JSON line's K2: fp32
                peak="tf32x3" if dt == f32 else None)

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

    # K4 forward and both gradient passes at each step's keypoint count
    for N, where, designated in ((672, "MASt3R", True), (300, "VGGT", False),
                                 (768, "objaverse MASt3R", False)):
        h = 128
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
    def pair(B, N, H, dt, kind):
        if kind == "qkv":
            qkv = torch.randn((B, N, 3, H, 64), generator=g, device=dev).to(dt)
            return qkv[:, :, 0].transpose(1, 2), qkv[:, :, 1].transpose(1, 2)
        return tuple(torch.randn((B, N, H, 64), generator=g, device=dev).to(dt).transpose(1, 2)
                     for _ in range(2))

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
    ]
    for where, B, N, H, dt, kind, qpos, kpos in pair_cases:
        q, k = pair(B, N, H, dt, kind)
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
                designated=where == "VGGT frame attention" and f0 > 0)
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
    return counts


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
    every = tuple(REPLACES)
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
    (testdata/digests.json, written and checked by tests/test_torch_jpeg.py);
    the progressive file refused. Returns the decoded images by name."""
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
    try:
        decode_jpeg(root / "progressive.jpg")
        refused = False
    except ValueError as e:
        refused = "progressive" in str(e)
    log(f"eval: codec progressive.jpg refused with a ValueError {refused} "
        f"{'OK' if refused else 'FAIL'}")
    frames = [v for k, v in decode_ms.items() if k.startswith("frame_")]
    frame_resize = [v for k, v in resize_ms.items() if k.startswith("frame_")]
    pascal_resize = [v for k, v in resize_ms.items() if k.startswith("pascal_")]
    log(f"eval: codec host ms per 854x480 4:2:0 decode (median of {len(frames)}) "
        f"{statistics.median(frames):.1f}; per 500x375 decode "
        f"{statistics.median(v for k, v in decode_ms.items() if k.startswith('pascal_')):.1f}; "
        f"per Lanczos 854x480 -> 848x464 {statistics.median(frame_resize):.1f}; per "
        f"500x375 -> 640x480 {statistics.median(pascal_resize):.1f}")
    if not (ok and refused):
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
    stride 8 on a 464x848 frame and at stride 16 on a 640^2 canvas; then
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
    canvas = resize_to_canvas(images["pascal_444.jpg"], 640)
    ok = True
    with no_tf32(), torch.no_grad():
        for what, img, stride in (("464x848 frame, stride 8", frames[0], 8),
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
    1752x1168 fixture with --workers min(8, CPUs), 6 steps: its launches a
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
    every = tuple(REPLACES)
    total = {k: 0 for k in REPLACES}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        fixtures.write_scannetpp_tree(root)
        fixtures.write_objaverse_tree(root)
        real = ["--data-root", str(root), "--epochs", "1", "--workers", str(workers)]
        runs = [
            ("data ScanNet++ MASt3R", ["--config", "finetune_timm_mast3r_scannetpp",
                                       "--steps-per-epoch", "6", *real],
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
POSE_TREE = dict(size=(512, 512), known_kps=2000, bank_frames=40, bank_kps=3200, bank_tests=3)
POSE_N = 4097
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
    scenes = sorted(int(k[1:].split("_")[0]) for k in rec.files if k.endswith("_pts"))
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
    bank = frame_descriptors(cpu_student, bank_rgb, bank_kp)
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
            str(ckpt), None, str(root / "data"), run_transfer=False, run_pose=True,
            device=dev))
    finally:
        Student.apply_refine = apply_refine
    keys_ok = list(res) == ["pose/fit3d", "pose/vanilla"]
    same = keys_ok and (res["pose/fit3d"].columns == res["pose/vanilla"].columns)
    want = {("float32", POSE_N): 2 * 12 * pose_frames(POSE_TREE)}
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
        log(f"pose: wrote the OnePose tree in {time.perf_counter() - t1:.1f} s")
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
                          tuple(REPLACES), ("depth_diff_head.depth_attention.",), profile=False)
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
    """The surface phase: (a) three MASt3R steps in bench.py's bf16
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
                  n_steps=3, check_teacher=check_bf16_teacher,
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
        for k, n in run_steps(name, setup, dev, n_steps=3, check_teacher=check,
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
