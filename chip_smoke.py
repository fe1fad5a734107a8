#!/usr/bin/env python3
"""Smoke run of the gd3d_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

It needs one card and takes no arguments. It prints the card's name and
power limit (nvidia-smi) and builds the CUDA kernels from gd3d_torch/csrc
with nvcc, one process per source (timed, with ptxas's register and spill
report), then runs these phases in order, one or more printed lines each:
  1. kernels  K1-K5 against their plain PyTorch twins at every main-path
              shape of both steps: max abs error against the stated
              tolerance, the median device time of each (the host enqueues
              behind a long matrix product, so its own time per call,
              host_us, is printed apart), the time of one PyTorch call that
              computes the same function where there is one (library_ms,
              timed here only, with the name of the device kernel it ran),
              and the bound: the larger of
              bytes over 3.35 TB/s and operations over the peak of their
              type (989 TFLOP/s bf16, 67 TFLOP/s fp32 off the tensor cores),
              with the achieved TFLOP/s (those operations over the kernel's
              time) and the share of the bound reached; K2 at the MASt3R
              student's main shape, and K4 and K4b at the MASt3R keypoint
              count, run twice and must give the same bits;
  2. steps    three full-width MASt3R distillation steps (ViT-B/16 bf16
              student, MASt3R ViT-L/Base-decoder fp32 teacher, 336x512
              teacher and 512^2 student frames), then three full-width VGGT
              steps (the same student, VGGT-1B teacher with its aggregator in
              bf16 and its heads fp32, 518^2 frames): one pair per step,
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
              (the bf16 tensor-core K1 and K2).

Then one JSON line of the kernels, the card line, and last the JSON result
line. Exits non-zero, printing no result, without a CUDA device or if any
phase fails. The kernels and agree phases compare fp32 results too, so they
run without TF32; the steps run with PyTorch's defaults (the teachers turn TF32
off themselves).
"""
from __future__ import annotations

import json
import math
import statistics
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
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> tuple[float, float]:
    """(median device time of one call in ms, host time of one call in us).
    CUDA events around each call; four long matrix products go first, so
    that the host enqueues every call while the device is still busy and the
    events see no host time. The host time is the enqueueing loop's."""
    import torch

    for _ in range(3):
        fn()
    plug = torch.empty((8192, 8192), device="cuda")
    torch.cuda.synchronize()
    for _ in range(4):  # ~0.1 s of fp32 work: iters calls enqueue in less
        torch.mm(plug, plug)
    events = []
    t0 = time.perf_counter()
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    host_us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events), host_us


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


def bound(nbytes: float, ops: float, dtype: str):
    """The least time the card could take: (ms, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want) -> tuple[float, float]:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()), float(want.abs().max())


class KernelReport:
    """Errors, times and bounds per kernel case; one designated case per
    kernel fills its entry of the JSON line."""

    def __init__(self):
        self.results = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None,
                            "bound_ms": None, "bound_by": None, "library_ms": None}
                        for k in REPLACES}
        self.ok = True

    def check(self, kern, where, pairs, run, run_plain, nbytes, ops, dtype, iters,
              run_library=None, designated=False):
        import torch

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
        b_ms, b_by = bound(nbytes, ops, dtype)
        log(f"kernels: {kern} {where}: {' '.join(parts)} {'OK' if line_ok else 'FAIL'} "
            f"kernel_ms={ms:.4f} host_us={host_us:.1f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib} bound_ms={b_ms:.4f} ({b_by}) tflops={ops / ms / 1e9:.2f} "
            f"bound_share={b_ms / ms:.3f}")
        self.ok &= line_ok
        r = self.results[kern]
        r["max_abs_err"] = max(r["max_abs_err"], worst)
        if designated:
            r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


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
    from gd3d_torch.kernels.rope2d import rope2d_fwd, rope2d_plain
    from gd3d_torch.ops.masks import masked_patch_cost
    from gd3d_torch.ops.rope2d import grid_positions

    g = torch.Generator(device=dev).manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    rep = KernelReport()
    attn_cases = [
        # (kernel, where on the main paths, B, N, H, D, dtype, designated)
        ("K1", "MASt3R student main pass", 2, 4161, 12, 64, bf16, True),
        ("K1", "MASt3R student cost pass", 2, 673, 12, 64, bf16, False),
        ("K1", "CroCo encoder", 2, 672, 16, 64, f32, False),
        ("K1", "CroCo decoder", 2, 672, 12, 64, f32, False),
        ("K1", "VGGT student main pass", 2, 6401, 12, 64, bf16, False),
        ("K1", "VGGT student cost pass", 2, 1370, 12, 64, bf16, False),
        ("K1", "DINOv2 + VGGT frame attention", 2, 1374, 16, 64, bf16, False),
        ("K1", "VGGT global attention", 1, 2748, 16, 64, bf16, False),
        ("K1", "VGGT camera trunk", 1, 2, 16, 128, f32, False),
        ("K2", "MASt3R student main pass", 2, 4161, 12, 64, bf16, True),
        ("K2", "MASt3R student cost pass", 2, 673, 12, 64, bf16, False),
        ("K2", "VGGT student main pass", 2, 6401, 12, 64, bf16, False),
        ("K2", "VGGT student cost pass", 2, 1370, 12, 64, bf16, False),
        ("K2", "fp32 operands", 2, 673, 12, 64, f32, False),
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
                designated=designated)

    # K3 at the cost volume of one pair, masked rows in
    for N, designated in ((672, True), (1369, False)):
        raw = torch.rand((1, N, N), generator=g, device=dev)
        mask = torch.rand((1, N), generator=g, device=dev) > 0.3
        teacher_p = masked_patch_cost(raw, mask[0])
        cost = torch.rand((1, N, N), generator=g, device=dev) * 2 - 1
        rep.check(
            "K3", f"cost-volume KL B=1 N={N} M={N} float32 ({int((~mask).sum())} masked rows)",
            [("kl", masked_softmax_kl_fwd(teacher_p, cost, mask),
              _reference_rows(teacher_p, cost, mask, 1e-8), "float32")],
            lambda: masked_softmax_kl_fwd(teacher_p, cost, mask),
            lambda: _reference_rows(teacher_p, cost, mask, 1e-8),
            nbytes=2 * N * N * 4 + N + N * 4, ops=8.0 * N * N, dtype="float32", iters=50,
            designated=designated)

    # K4 forward and both gradient passes at each step's keypoint count
    for N, where, designated in ((672, "MASt3R", True), (300, "VGGT", False)):
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
        ("VGGT frame attention", 2, 1374, 16, bf16, vggt_pos(2), True),
        ("VGGT global attention", 1, 2748, 16, bf16, vggt_pos(2).reshape(1, 2748, 2), False),
        ("CroCo encoder", 2, 672, 16, f32, grid_positions(21, 32, 2, device=dev), False),
        ("CroCo decoder", 2, 672, 12, f32, grid_positions(21, 32, 2, device=dev), False),
    ]
    for where, B, N, H, dt, pos, designated in rope_cases:
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
                dtype=dname, iters=50, designated=designated and f0 > 0)
    if not rep.ok:
        raise AssertionError("a kernel disagrees with its plain version")
    return rep.results


def mast3r_setup(dev, seed: int = 0):
    """Full-width student and MASt3R teacher with seeded random weights, on
    `dev` through the step builder, and one ScanNet++-geometry batch (as
    bench.py builds it)."""
    import dataclasses

    import torch

    from gd3d_torch.core.config import DistillConfig
    from gd3d_torch.distill.mast3r_step import build_mast3r_train_step
    from gd3d_torch.distill.train_state import make_optimizer
    from gd3d_torch.models.mast3r import Mast3rConfig
    from gd3d_torch.models.student import Student, split_params
    from gd3d_torch.models.vit import init_params_
    from gd3d_torch.teachers.mast3r import Mast3rTeacher

    cfg = DistillConfig(teacher="mast3r", dataset="scannetpp")
    cfg = cfg.replace(student=dataclasses.replace(cfg.student, compute_dtype="bfloat16"))
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


def vggt_setup(dev, seed: int = 1):
    """The finetune_timm_vggt_scannetpp configuration at full width: the
    ViT-B/16 bf16 student and the VGGT-1B teacher (bf16 aggregator, fp32
    heads), seeded random weights with the two pinned heads of
    bias_params_for_live_keypoints, on `dev` through the step builder; 518^2
    teacher and 512^2 student frames (bench.py's VGGT line)."""
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
    cfg = cfg.replace(student=dataclasses.replace(cfg.student, compute_dtype="bfloat16"))
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
        "rgb_vggt": torch.rand((1, 2, 518, 518, 3), generator=g, device=dev),
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


def run_steps(name, setup, dev, n_steps: int, check_teacher=None) -> dict:
    import torch

    from gd3d_torch.kernels import launch_counts, reset_launch_counts
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
    counts = launch_counts()
    check_step_keypoints(name, k4_args)
    if check_teacher is not None:
        check_teacher(teacher, batch)
    changed = [k for k, p in trainable.items() if not torch.equal(p, before_t[k])]
    moved = [k for k, p in frozen.items() if not torch.equal(p, before_f[k])]
    teacher_after = sum(float(p.double().sum()) for p in teacher.parameters())
    log(f"steps: {name} launches {counts}; trainable tensors changed {len(changed)}/"
        f"{len(trainable)}; frozen tensors changed {len(moved)}/{len(frozen)}; "
        f"teacher unchanged {teacher_after == teacher_sum}")
    unchanged = sorted(set(trainable) - set(changed))
    log(f"steps: {name} trainable tensors unchanged: {unchanged}")
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


def profile_step(name, step, batch) -> None:
    """Device time by kernel over one step, and the device's idle share of
    the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, 1.0)
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
    log(f"profile: {name} step wall {wall_ms:.2f} ms, kernel time {total:.2f} ms, device "
        f"busy {covered / 1e3:.2f} ms, idle share {1 - covered / 1e3 / wall_ms:.3f}")
    # the 20 longest, and every hand-written kernel (namespace gd3d) after them
    for i, (kname, ms, count) in enumerate(rows):
        if i < 20 or "gd3d::" in kname:
            log(f"profile: {name} {ms:9.3f} ms {100 * ms / total:5.1f}% x{count:<5d} "
                f"{kname[:90]}")


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
    for name, setup, check in (("MASt3R", mast3r_setup, check_mast3r_teacher),
                               ("VGGT", vggt_setup, None)):
        for k, n in run_steps(name, setup, dev, n_steps=3, check_teacher=check).items():
            counts[k] += n
        torch.cuda.empty_cache()
        log(f"phase: {name} steps done at {time.perf_counter() - t_start:.1f} s")
    with no_tf32():
        check_agreement(dev)
    log(f"phase: agree done at {time.perf_counter() - t_start:.1f} s")

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
