#!/usr/bin/env python3
"""Smoke run of the gd3d_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

It needs one card and takes no arguments. It prints the card's name and power limit (nvidia-smi) and builds the CUDA
kernels from gd3d_torch/csrc with nvcc (timed, with ptxas's register and
spill report), then runs these phases in order, one or more printed lines each:
  1. kernels  K1, K2, K3 against their plain PyTorch twins at every
              main-path shape: max abs error against the stated tolerance,
              and the median time of each;
  2. steps    three full-width MASt3R distillation train steps (ViT-B/16
              bf16 student, MASt3R ViT-L/Base-decoder fp32 teacher, 336x512
              teacher and 512^2 student frames, one pair, random weights
              from a seed): losses, keypoint count, step time, peak memory;
              the trainable parameters must change (all but the depth head's
              depth_attention branch, which training never calls), the
              frozen ones not, and K1, K2 and K3 must each have launched;
  3. profile  one more full-width step under torch.profiler: device time by
              kernel and the device's idle share of the step;
  4. agree    the same step's losses and gradients on a small input, CUDA
              kernels against the CPU plain path, with shared weights.

Then one JSON line of the kernels, and last the JSON result line. Exits
non-zero, printing no result, without a CUDA device or if any phase fails.
The kernels and agree phases compare fp32 results, so they run without
TF32; the steps run with PyTorch's defaults (the teacher turns TF32 off
itself).
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

REPLACES = {
    "K1": ("flash_attention_fwd", "gd3d_torch/csrc/flash_fwd.cu",
           "gd3d/ops/attention.py:180"),
    "K2": ("flash_attention_bwd_fused", "gd3d_torch/csrc/flash_bwd.cu",
           "gd3d/kernels/flash_bwd_fused.py:153"),
    "K3": ("masked_softmax_kl_rows", "gd3d_torch/csrc/cost_kl.cu",
           "gd3d/kernels/cost_kl.py:43"),
}
# Tolerance: max abs error <= TOL[dtype] * max(1, max |plain|). fp32: the
# kernels and the plain twin sum in different orders (<= 4161 terms);
# bf16: both round an fp32 result to bf16 (8 mantissa bits), so one ulp of
# the largest value can separate them. K1's log-sum-exp is fp32 whatever
# the operands, so it is held to the fp32 tolerance in every case.
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Median device time of one call, CUDA events around each call."""
    import torch

    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def max_err(got, want) -> tuple[float, float]:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()), float(want.abs().max())


def check_kernels(dev) -> dict:
    """Each kernel against its plain twin on the same inputs, at the shapes
    the main path gives it."""
    import torch

    from gd3d_torch.kernels.cost_kl import _reference_rows, masked_softmax_kl_fwd
    from gd3d_torch.kernels.flash_bwd_fused import (
        flash_attention_bwd_fused, flash_attention_bwd_plain)
    from gd3d_torch.kernels.flash_fwd import (
        flash_attention_fwd, flash_attention_fwd_plain)
    from gd3d_torch.ops.masks import masked_patch_cost

    g = torch.Generator(device=dev).manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    attn_cases = [
        # (kernel, where on the main path, B, N, H, dtype)
        ("K1", "student main pass", 2, 4161, 12, bf16),
        ("K1", "student cost pass", 2, 673, 12, bf16),
        ("K1", "teacher encoder", 2, 672, 16, f32),
        ("K1", "teacher decoder", 2, 672, 12, f32),
        ("K2", "student main pass", 2, 4161, 12, bf16),
        ("K2", "student cost pass", 2, 673, 12, bf16),
        ("K2", "fp32 operands", 2, 673, 12, f32),
    ]
    results = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None} for k in REPLACES}
    ok = True
    for kern, where, B, N, H, dt in attn_cases:
        # q, k, v as the strided (B, N, H, D) views of one qkv projection
        qkv = torch.randn((B, N, 3, H, 64), generator=g, device=dev).to(dt)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scale = 64 ** -0.5
        if kern == "K1":
            o, lse = flash_attention_fwd(q, k, v, scale)
            o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, scale)
            pairs = [("o", o, o_ref, dt), ("lse", lse, lse_ref, f32)]
            run = lambda: flash_attention_fwd(q, k, v, scale)  # noqa: E731
            run_plain = lambda: flash_attention_fwd_plain(q, k, v, scale)  # noqa: E731
        else:
            o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, scale)
            do = torch.randn((B, N, H, 64), generator=g, device=dev).to(dt)
            di = torch.einsum("bnhd,bnhd->bhn", o_ref.float(), do.float()).contiguous()
            grads = flash_attention_bwd_fused(q, k, v, lse_ref, do, di, scale)
            refs = flash_attention_bwd_plain(q, k, v, lse_ref, do, di, scale)
            pairs = [(n, a, b, dt) for n, a, b in zip(("dq", "dk", "dv"), grads, refs)]
            run = lambda: flash_attention_bwd_fused(q, k, v, lse_ref, do, di, scale)  # noqa: E731
            run_plain = lambda: flash_attention_bwd_plain(q, k, v, lse_ref, do, di, scale)  # noqa: E731
        torch.cuda.synchronize()
        worst, line_ok = 0.0, True
        parts = []
        for name, a, b, tol_dt in pairs:
            err, mag = max_err(a, b)
            tol = TOL[str(tol_dt).split(".")[-1]] * max(1.0, mag)
            line_ok &= math.isfinite(err) and err <= tol
            worst = max(worst, err)
            parts.append(f"{name} err={err:.3e} tol={tol:.1e}")
        iters = 10 if N > 1000 else 30
        ms, plain_ms = time_ms(run, iters), time_ms(run_plain, iters)
        log(f"kernels: {kern} {where} B={B} N={N} H={H} D=64 {str(dt)[6:]}: "
            f"{' '.join(parts)} {'OK' if line_ok else 'FAIL'} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
        ok &= line_ok
        r = results[kern]
        r["max_abs_err"] = max(r["max_abs_err"], worst)
        if where == "student main pass":
            r["ms"], r["plain_ms"] = ms, plain_ms

    # K3 at the cost volume of one pair (B=1, 672 patches), masked rows in
    B, N = 1, 672
    raw = torch.rand((B, N, N), generator=g, device=dev)
    mask = torch.rand((B, N), generator=g, device=dev) > 0.3
    teacher_p = masked_patch_cost(raw, mask[0])
    cost = torch.rand((B, N, N), generator=g, device=dev) * 2 - 1
    out = masked_softmax_kl_fwd(teacher_p, cost, mask)
    ref = _reference_rows(teacher_p, cost, mask, 1e-8)
    err, mag = max_err(out, ref)
    tol = TOL["float32"] * max(1.0, mag)
    k3_ok = math.isfinite(err) and err <= tol
    ms = time_ms(lambda: masked_softmax_kl_fwd(teacher_p, cost, mask), 50)
    plain_ms = time_ms(lambda: _reference_rows(teacher_p, cost, mask, 1e-8), 50)
    log(f"kernels: K3 cost-volume KL B={B} N={N} M={N} float32 "
        f"({int((~mask).sum())} masked rows): err={err:.3e} tol={tol:.1e} "
        f"{'OK' if k3_ok else 'FAIL'} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
    ok &= k3_ok
    results["K3"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version")
    return results


def flagship_setup(dev, seed: int = 0):
    """Full-width student and teacher on `dev` with seeded random weights,
    and one ScanNet++-geometry batch (as bench.py builds it)."""
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
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        student = Student(cfg.student)
        teacher = Mast3rTeacher(Mast3rConfig())
    init_params_(student, g)
    teacher.init_params(g)
    trainable, frozen = split_params(student)
    opt = make_optimizer(cfg.train, trainable.values())
    step = build_mast3r_train_step(student, teacher, cfg, opt, has_depth=False)
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


def run_steps(dev, n_steps: int = 3) -> dict:
    import torch

    from gd3d_torch.kernels import launch_counts, reset_launch_counts

    step, student, teacher, trainable, frozen, batch = flagship_setup(dev)
    before_t = {k: p.detach().clone() for k, p in trainable.items()}
    before_f = {k: p.detach().clone() for k, p in frozen.items()}
    teacher_sum = sum(float(p.double().sum()) for p in teacher.parameters())
    n_params = sum(p.numel() for p in student.parameters())
    n_teacher = sum(p.numel() for p in teacher.parameters())
    log(f"steps: student {n_params} params ({sum(p.numel() for p in trainable.values())} "
        f"trainable), teacher {n_teacher} params")
    torch.cuda.synchronize()
    reset_launch_counts()
    for i in range(n_steps):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        m = step(batch, 1.0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        vals = {k: float(v) for k, v in m.items()}
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        log(f"steps: step {i} " + " ".join(f"{k}={v:.6f}" for k, v in vals.items())
            + f" step_s={dt:.4f} peak_mem_gib={peak:.3f}")
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"non-finite metrics at step {i}: {vals}")
        if vals["num_kps"] <= 0:
            raise AssertionError("no keypoints survived the filters")
        if vals["depth_loss"] <= 0 or vals["intra_depth_loss"] <= 0:
            raise AssertionError(f"a depth loss is 0 at step {i}: {vals}")
    counts = launch_counts()
    changed = [k for k, p in trainable.items() if not torch.equal(p, before_t[k])]
    moved = [k for k, p in frozen.items() if not torch.equal(p, before_f[k])]
    teacher_after = sum(float(p.double().sum()) for p in teacher.parameters())
    log(f"steps: launches {counts}; trainable tensors changed {len(changed)}/"
        f"{len(trainable)}; frozen tensors changed {len(moved)}/{len(frozen)}; "
        f"teacher unchanged {teacher_after == teacher_sum}")
    unchanged = sorted(set(trainable) - set(changed))
    log(f"steps: trainable tensors unchanged: {unchanged}")
    # the depth head's depth_attention branch exists for checkpoint parity;
    # training calls the feature-only path (gd3d/models/vit.py:352-354)
    stuck = [k for k in unchanged if not k.startswith("depth_diff_head.depth_attention.")]
    if not changed or stuck:
        raise AssertionError(f"trainable parameters did not change: {stuck or 'all'}")
    if moved or teacher_after != teacher_sum:
        raise AssertionError(f"frozen parameters changed: {moved[:5]}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    profile_step(step, batch)
    return counts


def profile_step(step, batch) -> None:
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
    log(f"profile: step wall {wall_ms:.2f} ms, kernel time {total:.2f} ms, device busy "
        f"{covered / 1e3:.2f} ms, idle share {1 - covered / 1e3 / wall_ms:.3f}")
    for name, ms, count in rows[:20]:
        log(f"profile: {ms:9.3f} ms {100 * ms / total:5.1f}% x{count:<5d} {name[:90]}")


def check_agreement(dev) -> None:
    """Small input, fp32: the step's losses and trainable gradients with the
    CUDA kernels against the CPU plain path on shared weights."""
    import torch

    from gd3d_torch.core.config import DistillConfig, KeypointConfig, StudentConfig
    from gd3d_torch.distill.mast3r_step import mast3r_distill_loss
    from gd3d_torch.models.croco import CrocoConfig
    from gd3d_torch.models.mast3r import Mast3rConfig
    from gd3d_torch.models.student import Student, split_params
    from gd3d_torch.models.vit import init_params_
    from gd3d_torch.teachers.mast3r import Mast3rTeacher

    # head dim 64, as the kernels take
    cfg = DistillConfig(
        student=StudentConfig(embed_dim=128, depth=8, num_heads=2, pretrain_img_size=32,
                              adapter_bottleneck=8, target_res=64, depth_head_hidden=16),
        keypoints=KeypointConfig(nn_subsample=16))
    tcfg = Mast3rConfig(croco=CrocoConfig(enc_embed_dim=128, enc_depth=2, enc_num_heads=2,
                                          dec_embed_dim=128, dec_depth=2, dec_num_heads=2),
                        local_feat_dim=6, dpt_feature_dim=32, dpt_last_dim=16)
    g = torch.Generator().manual_seed(7)
    student, teacher = Student(cfg.student), Mast3rTeacher(tcfg)
    init_params_(student, g)
    teacher.init_params(g)
    with torch.no_grad():
        for n, p in student.named_parameters():
            if ".lora_b_" in n:
                p.normal_(0.0, 0.05, generator=g)
    H, W = 64, 96
    batch = {
        "rgb_1": torch.rand((1, 128, 128, 3), generator=g),
        "rgb_2": torch.rand((1, 128, 128, 3), generator=g),
        "rgb_mast3r_1": torch.rand((1, H, W, 3), generator=g) * 2 - 1,
        "rgb_mast3r_2": torch.rand((1, H, W, 3), generator=g) * 2 - 1,
        "intrinsic": torch.tensor([[[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]]]),
    }
    teacher.face_forward(batch["rgb_mast3r_1"], batch["rgb_mast3r_2"])
    results = []
    for device in ("cpu", dev):
        student.to(device)
        teacher.to(device)
        trainable, _ = split_params(student)
        for p in trainable.values():
            p.grad = None
        b = {k: v.to(device) for k, v in batch.items()}
        loss, m = mast3r_distill_loss(student, teacher, cfg, b, 1.0, has_depth=False)
        loss.backward()
        results.append(({k: float(v.detach()) for k, v in m.items()},
                        {k: p.grad.detach().cpu().clone() for k, p in trainable.items()
                         if p.grad is not None}))
    (m_cpu, g_cpu), (m_gpu, g_gpu) = results
    loss_err = max(abs(m_cpu[k] - m_gpu[k]) / max(1.0, abs(m_cpu[k])) for k in m_cpu)
    grad_err = max(float((g_cpu[k] - g_gpu[k]).abs().max())
                   / max(1e-3, float(g_cpu[k].abs().max())) for k in g_cpu)
    ok = (m_cpu["num_kps"] == m_gpu["num_kps"] and loss_err <= 1e-4 and grad_err <= 1e-3
          and g_cpu.keys() == g_gpu.keys())
    log(f"agree: cpu {m_cpu}")
    log(f"agree: gpu {m_gpu}")
    log(f"agree: loss rel err {loss_err:.3e} (tol 1e-4), grad rel err {grad_err:.3e} "
        f"(tol 1e-3, fp32 sums in another order) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the CUDA path disagrees with the CPU plain path")


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

    gpu = gpu_line()
    log(f"gpu: {gpu}")
    t0 = time.perf_counter()
    report = build.build()
    build.library()
    log(f"build: {build.library_path().name} in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "Used" in line or "spill" in line:
            log(f"build: {line.strip()}")

    with no_tf32():
        kernels = check_kernels(dev)
    counts = run_steps(dev)
    with no_tf32():
        check_agreement(dev)

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
