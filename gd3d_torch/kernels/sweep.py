"""Time kernels at the main paths' shapes for other values of their
compile-time constants. Needs a CUDA card and nvcc.

    python3 -m gd3d_torch.kernels.sweep

K5 and K3: the heads one K5 thread rotates (GD3D_ROPE_HEADS in
csrc/rope2d.cu: 4, 8, 16) and the rows one K3 block holds (GD3D_KL_ROWS in
csrc/cost_kl.cu: 1, 2, 4, 8). Each setting is a library of the two sources
built with -D flags into gd3d_torch/build/ (all nvcc processes started
together); the shipped defaults, 4 and 4, are one of them. Every case is
first checked against its plain twin. The settings are timed in the order
listed, then again in the reverse order, each case by chip_smoke.py's
method (kernels/timing.py). It prints the card line, then one JSON object
per setting and run: the median device time in ms of each case, and a
one-element add timed the same way ("floor", what a launch costs with no
work).

    python3 -m gd3d_torch.kernels.sweep k2 [--parent OTHER/csrc ...]

The fp32 K2 (K2_SETTINGS): its TF32 passes (GD3D_TF32_PASSES in
csrc/mma.cuh: 3, the split-precision build, or 1, single-pass TF32) and
the rows a warp takes at a time (GD3D_TF32_CHUNK in csrc/flash_bwd.cu: 32
or 16); the shipped defaults, p3 c32, come first. With each --parent
another revision's csrc/flash_bwd*.cu (flash_bwd.cu with the routes it
links to, and its own headers) is built beside them. Each build is held to
the plain twin at the fp32 student's four lengths (tolerance 1e-4 of max(1,
max |plain|)) and at (2, 673, 3, 64) to the tight bound TIGHT (2e-5); the
1-pass build is expected to miss both and is only reported. Then each is timed at the four lengths, in order and
again in reverse. To compare whole steps, run two revisions' chip_smoke.py
in one call.

    python3 -m gd3d_torch.kernels.sweep wide [--parent OTHER/csrc ...]

K1 and K2 in bf16 and in fp32 at head dims 128 and 256 (and 64, the
student's, as the yardstick) and above 256 (chip_smoke.py's cases: K1 on
the cluster kernels, K2 on the chunked ones; a parent from before the
cluster kernels runs its K1 on the chunked forward), through
gd3d_flash_fwd / gd3d_flash_bwd: the
shipped build of the flash sources (csrc/flash_*.cu) and, with each
--parent, another revision's, built from that revision's own flash sources
and timed the same way as k2's (a scratch copy whose plans are changed
times another plan: csrc/flash_fwd.cu's FwdPlan, flash_bwd_tf32_wide.cu's
Plan, sm90.cuh's wide_tiles). Each is held at every one of WIDE_CASES to
the plain twins (a single 64 x 64 tile first; tolerance of max(1, max
|plain|): bf16 1e-2, fp32 1e-4, LSE 1e-4); then K1 and K2 are timed at
each case, and K2's kernels apart at the long cases (torch.profiler). The
cases at head dims below their kernel width (the --tiny stereo model's 16
and 8, and 96 and 192 at (2,673,4,D)) run each build by the routes it
takes: a build that reads such a head dim direct (asked once, at D = 8) by
the wrappers' rule (flash_fwd.py::fwd_routed), an older one on the pad
route (fwd_padded: F.pad copies, the kernel at the width, O sliced), as
the wrappers of its revision ran it. That fork (takes_direct, the pad
branch of k1_routed / k2_routed) serves only parents whose kernels refuse
a head dim below the width; once no parent compared is that old, remove
it and time every build through fwd_routed / bwd_routed.
"""
from __future__ import annotations

import argparse
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
import subprocess
import sys

import torch

from gd3d_torch.kernels import build
from gd3d_torch.kernels.cost_kl import _reference_rows
from gd3d_torch.kernels.flash_bwd_fused import bwd_padded, bwd_routed, flash_attention_bwd_plain
from gd3d_torch.kernels.flash_fwd import flash_attention_fwd_plain, fwd_padded, fwd_routed
from gd3d_torch.kernels.rope2d import _NO_TASK, _task, rope2d_plain, vec_width
from gd3d_torch.kernels.timing import time_ms
from gd3d_torch.ops.masks import masked_patch_cost
from gd3d_torch.ops.rope2d import grid_positions
from gd3d_torch.teachers.mast3r import no_tf32

# (GD3D_ROPE_HEADS, GD3D_KL_ROWS): each constant swept with the other at its default
SETTINGS = ((4, 4), (8, 4), (16, 4), (4, 1), (4, 2), (4, 8))
SOURCES = ("rope2d.cu", "cost_kl.cu")


def variant(heads: int, rows: int):
    flags = (f"-DGD3D_ROPE_HEADS={heads}", f"-DGD3D_KL_ROWS={rows}")
    so = build.library_path().with_name(f"libgd3d_sweep_h{heads}_r{rows}.so")
    sources = [build.CSRC_DIR / name for name in SOURCES]
    return so, sources, flags


def rope_call(lib, pairs, base=100.0, f0=1.0):
    """One K5 launch on one (tokens, positions) pair or two, through `lib`;
    returns the outputs in (B, H, N, D) form."""
    tokens = pairs[0][0]
    outs, tasks = zip(*(_task(t, p) for t, p in pairs))
    err = lib.gd3d_rope2d(len(tasks), *tasks[0], *(tasks[1] if len(tasks) > 1 else _NO_TASK),
                          tokens.shape[-1], vec_width(tokens.shape[-1], tokens.dtype),
                          float(base), float(f0), int(tokens.dtype == torch.bfloat16),
                          torch.cuda.current_stream().cuda_stream)
    build.check(err, "sweep rope2d")
    return [o.transpose(1, 2) for o in outs]


def kl_call(lib, p, cost, mask):
    out = torch.empty(mask.shape, dtype=torch.float32, device=p.device)
    B, N, M = cost.shape
    err = lib.gd3d_cost_kl(p.data_ptr(), cost.data_ptr(), mask.data_ptr(), out.data_ptr(),
                           B, N, M, 1e-8, torch.cuda.current_stream().cuda_stream)
    build.check(err, "sweep cost_kl")
    return out


def cases(dev):
    """name -> (kind, inputs, plain result) at the shapes of chip_smoke.py."""
    g = torch.Generator(device=dev).manual_seed(1234)
    grid = grid_positions(37, 37, 2, device=dev) + 1
    vggt_pos = torch.cat([torch.zeros((2, 5, 2), dtype=grid.dtype, device=dev), grid], 1)
    croco_pos = grid_positions(21, 32, 2, device=dev)

    def normed(B, N):  # (B, H, N, D) views of q_norm/k_norm outputs
        return torch.randn((B, N, 16, 64), generator=g, device=dev).bfloat16().transpose(1, 2)

    def qkv(B, H):  # q and k, (B, H, N, D) views of one projection
        x = torch.randn((B, 672, 3, H, 64), generator=g, device=dev)
        return x[:, :, 0].transpose(1, 2), x[:, :, 1].transpose(1, 2)

    frame_q, frame_k = normed(2, 1374), normed(2, 1374)
    glob_pos = vggt_pos.reshape(1, 2748, 2)
    enc_q, enc_k = qkv(2, 16)
    dec_q, dec_k = qkv(1, 12)
    rope = {
        "k5 vggt frame single": [(frame_q, vggt_pos)],
        "k5 vggt frame pair": [(frame_q, vggt_pos), (frame_k, vggt_pos)],
        "k5 vggt global pair": [(normed(1, 2748), glob_pos), (normed(1, 2748), glob_pos)],
        "k5 croco enc single": [(enc_q, croco_pos)],
        "k5 croco enc pair": [(enc_q, croco_pos), (enc_k, croco_pos)],
        "k5 croco dec pair": [(dec_q, croco_pos[:1]), (dec_k, croco_pos[:1])],
    }
    out = {name: ("rope", pairs, [rope2d_plain(t, p) for t, p in pairs])
           for name, pairs in rope.items()}
    for n in (672, 1369):
        mask = torch.rand((1, n), generator=g, device=dev) > 0.3
        p = masked_patch_cost(torch.rand((1, n, n), generator=g, device=dev), mask[0])
        cost = torch.rand((1, n, n), generator=g, device=dev) * 2 - 1
        out[f"k3 {n}"] = ("kl", (p, cost, mask), [_reference_rows(p, cost, mask, 1e-8)])
    return out


def k5_k3(dev) -> int:
    builds = [variant(h, r) for h, r in SETTINGS]
    with ThreadPoolExecutor(len(builds)) as pool:  # every nvcc process at once
        list(pool.map(lambda b: build.compile_library(*b), builds))
    libs = [build.load(so) for so, _, _ in builds]
    work = cases(dev)
    one = torch.zeros(1, device=dev)
    for (heads, rows), lib in zip(SETTINGS, libs):
        for name, (kind, args, want) in work.items():
            got = rope_call(lib, args) if kind == "rope" else [kl_call(lib, *args)]
            for a, b in zip(got, want):
                tol = 1e-2 if a.dtype == torch.bfloat16 else 1e-4
                tol *= max(1.0, float(b.abs().max()))
                err = float((a.float() - b.float()).abs().max())
                if not err <= tol:
                    print(f"sweep: heads={heads} rows={rows} {name} err {err} > {tol}",
                          file=sys.stderr)
                    return 1
    order = list(zip(SETTINGS, libs))
    for run, settings in enumerate((order, order[::-1])):
        for (heads, rows), lib in settings:
            times = {"floor": time_ms(lambda: one.add_(1.0), 50)[0]}
            for name, (kind, args, _) in work.items():
                call = ((lambda a=args, lib=lib: rope_call(lib, a)) if kind == "rope"
                        else (lambda a=args, lib=lib: kl_call(lib, *a)))
                times[name] = time_ms(call, 50)[0]
            print(json.dumps({"run": run, "heads": heads, "rows": rows, "ms": times}),
                  flush=True)
    return 0


# ------------------------------------------------------------------ K2 fp32
K2_LENGTHS = ((2, 4161), (2, 673), (2, 6401), (2, 1370))  # the fp32 student's (B, N), H = 12
TIGHT = 2e-5  # the card test's bound at (2, 673, 3, 64)


# (TF32 passes, chunk rows); the shipped build first
K2_SETTINGS = ((3, 32), (1, 32), (3, 16))
K2_SOURCES = "flash_bwd*.cu"  # gd3d_flash_bwd and the launchers it calls


def revision_name(csrc: str) -> str:
    """A build's name for another revision's csrc directory: the directory
    that holds its package (outputs/parent/gd3d_torch/csrc -> "parent")."""
    return Path(csrc).resolve().parents[1].name


def variants(tag: str, pattern: str, settings, parents):
    """(name, library, sources, flags) of each build of the csrc sources
    that `pattern` matches: one for each (name, flags) of `settings`, and
    for each of `parents` (other revisions' csrc directories) one of the
    sources it holds that match."""
    src = sorted(build.CSRC_DIR.glob(pattern))
    out = [(name, build.library_path().with_name(f"libgd3d_sweep_{tag}_{i}.so"), src, flags)
           for i, (name, flags) in enumerate(settings)]
    for parent in parents or ():
        name = revision_name(parent)
        out.append((name, build.library_path().with_name(f"libgd3d_sweep_{tag}_{name}.so"),
                    sorted(Path(parent).resolve().glob(pattern)), ()))
    return out


def build_all(builds) -> dict:
    """Compiles every build at once, prints ptxas's registers, spills and
    warnings of each, and returns name -> library. If nvcc refuses any
    build, it prints each refusal and raises: no build is measured without
    the others."""
    def compile_one(b):
        try:
            return build.compile_library(*b[1:])
        except RuntimeError as e:
            return e

    with ThreadPoolExecutor(len(builds)) as pool:  # every nvcc process at once
        reports = list(pool.map(compile_one, builds))
    failed = [name for (name, *_), r in zip(builds, reports) if isinstance(r, RuntimeError)]
    for (name, *_), report in zip(builds, reports):
        if isinstance(report, RuntimeError):
            print(f"{name}: build failed: {str(report)[-3000:]}", flush=True)
            continue
        for line in report.splitlines():
            if any(w in line for w in ("Used", "spill", "Compiling entry", "warning")):
                print(f"{name}: {line.strip()}", flush=True)
    if failed:
        raise RuntimeError(f"sweep: nvcc refused the builds {failed}")
    return {name: build.load(so) for name, so, _, _ in builds}


def err_over_max(got, want) -> float:
    """The largest max |got - want| / max(1, max |want|) over the pairs."""
    return max(float((a.float() - b.float()).abs().max()) / max(1.0, float(b.float().abs().max()))
               for a, b in zip(got, want))


def time_turns(mode: str, libs: dict, calls: dict) -> None:
    """Times each of `calls` (case -> (fn(lib), iterations)) with every
    library, in order and again in reverse; one JSON line per library and
    turn."""
    order = list(libs.items())
    for run, turn in enumerate((order, order[::-1])):
        for name, lib in turn:
            times = {case: time_ms(lambda fn=fn, lib=lib: fn(lib), iters)[0]
                     for case, (fn, iters) in calls.items()}
            print(json.dumps({"run": run, mode: name, "ms": times}), flush=True)


def k2_call(lib, q, k, v, lse, do, di, scale):
    B, N, H, D = q.shape
    M = k.shape[1]
    dq = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, M, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, M, H, D), dtype=q.dtype, device=q.device)
    err = lib.gd3d_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, N, M, H, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3], float(scale),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    build.check(err, "sweep flash_bwd")
    return dq, dk, dv


def k1_call(lib, q, k, v, scale):
    B, N, H, D = q.shape
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    err = lib.gd3d_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, N, k.shape[1], H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "sweep flash_fwd")
    return o, lse


def k2_cases(dev):
    """name -> (operands, plain gradients): q, k, v as views of one qkv
    projection, random rows of dO, at each length and at the tight case."""
    g = torch.Generator(device=dev).manual_seed(1234)
    out = {}
    for B, N, H in [(B, N, 12) for B, N in K2_LENGTHS] + [(2, 673, 3)]:
        qkv = torch.randn((B, N, 3, H, 64), generator=g, device=dev)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        o, lse = flash_attention_fwd_plain(q, k, v, 0.125)
        do = torch.randn((B, N, H, 64), generator=g, device=dev)
        di = torch.einsum("bnhd,bnhd->bhn", o, do).contiguous()
        args = (q, k, v, lse, do, di, 0.125)
        out[f"({B},{N},{H},64)"] = (args, flash_attention_bwd_plain(*args))
    return out


def k2(dev, parents) -> int:
    libs = build_all(variants(
        "k2", K2_SOURCES, [(f"p{p} c{c}", (f"-DGD3D_TF32_PASSES={p}", f"-DGD3D_TF32_CHUNK={c}"))
                           for p, c in K2_SETTINGS], parents))
    with no_tf32():  # the plain twin in full fp32
        work = k2_cases(dev)
    ok, shipped = True, {f"p{p} c{c}" for p, c in K2_SETTINGS}
    for name, lib in libs.items():
        errs = {case: err_over_max(k2_call(lib, *args), want)
                for case, (args, want) in work.items()}
        tight = errs["(2,673,3,64)"] <= TIGHT
        within = all(e <= 1e-4 for e in errs.values())
        print(json.dumps({"k2": name, "err_over_max": errs, "within_1e-4": within,
                          "within_tight": tight}), flush=True)
        if not name.startswith("p1 "):
            ok &= within and (tight or name not in shipped)
    if not ok:
        print("sweep: a K2 build disagrees with its plain twin", file=sys.stderr)
        return 1
    time_turns("k2", libs, {case: (lambda lib, a=args: k2_call(lib, *a), 10)
                            for case, (args, _) in work.items() if not case.endswith(",3,64)")})
    return 0


# ------------------------------------------------------------ K1 / K2 wide
# (B, N, H, D): one tile at each wide width, ragged lengths, chip_smoke.py's
# wide cases, the student's width 768 re-headed, its head-dim-64 pass, the
# VGGT camera trunk (fp32 at 128 on a main path), the head dims below
# their kernel width: the --tiny stereo model's encoder and decoder, and
# chip_smoke.py's 96 and 192 at (2,673,4,D), and chip_smoke.py's cases
# above 256 (258 on the pad route to 264 in both dtypes)
WIDE_CASES = ((1, 64, 1, 128), (1, 64, 1, 256), (1, 81, 2, 128), (1, 81, 2, 256),
              (2, 673, 4, 128), (2, 673, 4, 256), (2, 4161, 6, 128), (2, 4161, 3, 256),
              (2, 4161, 12, 64), (1, 2, 16, 128), (4, 24, 2, 16), (2, 24, 2, 8),
              (2, 673, 4, 96), (2, 673, 4, 192),
              (2, 673, 2, 512), (2, 673, 2, 320), (2, 673, 2, 258), (1, 4161, 3, 512))
WIDE_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def wide_cases(dev):
    """(dtype name, B, N, H, D) -> (operands of K2, plain O and LSE, plain
    gradients), bf16 and fp32, M = N."""
    g = torch.Generator(device=dev).manual_seed(1234)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        for B, N, H, D in WIDE_CASES:
            q, k, v, do = (torch.randn((B, N, H, D), generator=g, device=dev).to(dt)
                           for _ in range(4))
            scale = D ** -0.5
            o, lse = flash_attention_fwd_plain(q, k, v, scale)
            di = torch.einsum("bnhd,bnhd->bhn", o.float(), do.float()).contiguous()
            args = (q, k, v, lse, do, di, scale)
            out[(str(dt).removeprefix("torch."), B, N, H, D)] = (
                args, (o, lse), flash_attention_bwd_plain(*args))
    return out


def takes_direct(lib) -> bool:
    """Whether a build's gd3d_flash_fwd reads a head dim below its kernel
    width as it is (bf16 at D = 8), or refuses it (an older revision's)."""
    q = torch.zeros((1, 8, 1, 8), dtype=torch.bfloat16, device="cuda")
    lse = torch.empty((1, 1, 8), device="cuda")
    err = lib.gd3d_flash_fwd(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), torch.empty_like(q).data_ptr(),
        lse.data_ptr(), 1, 8, 8, 1, 8, *(q.stride()[:3] * 4), 1.0, 1,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return err == 0


def k1_routed(lib, direct: bool, q, k, v, scale):
    """K1 of one build by its revision's route (takes_direct)."""
    return (fwd_routed if direct else fwd_padded)(
        lambda *a: k1_call(lib, *a), q, k, v, scale)


def k2_routed(lib, direct: bool, *args):
    """K2 of one build by its revision's route (takes_direct)."""
    return (bwd_routed if direct else bwd_padded)(lambda *a: k2_call(lib, *a), *args)


def wide(dev, parents) -> int:
    libs = build_all(variants("wide", "flash_*.cu", (("shipped", ()),), parents))
    direct = {lib: takes_direct(lib) for lib in libs.values()}  # by library
    print(json.dumps({"wide": "reads head dims below the width direct",
                      **{name: direct[lib] for name, lib in libs.items()}}), flush=True)
    with no_tf32():  # the plain twins in full fp32
        work = wide_cases(dev)
    ok = True
    for name, lib in libs.items():
        errs = {}
        for case, (args, (o, lse), grads) in work.items():
            q, k, v, _, _, _, scale = args
            got = k1_routed(lib, direct[lib], q, k, v, scale)
            e = {"o": err_over_max(got[:1], (o,)), "lse": err_over_max(got[1:], (lse,)),
                 "grads": err_over_max(k2_routed(lib, direct[lib], *args), grads)}
            tol = WIDE_TOL[q.dtype]
            e["ok"] = e["o"] <= tol and e["lse"] <= 1e-4 and e["grads"] <= tol
            errs[str(case)] = e
        within = all(e["ok"] for e in errs.values())
        print(json.dumps({"wide": name, "ok": within, "err_over_max": errs}), flush=True)
        ok &= within
    if not ok:
        print("sweep: a wide build disagrees with its plain twin", file=sys.stderr)
        return 1
    calls = {}
    for case, (args, _, _) in work.items():
        iters = 10 if case[2] > 1000 else 30
        calls[f"K1 {case}"] = (lambda lib, a=args: k1_routed(lib, direct[lib], *a[:3], a[6]),
                               iters)
        calls[f"K2 {case}"] = (lambda lib, a=args: k2_routed(lib, direct[lib], *a), iters)
    time_turns("wide", libs, calls)
    for name, lib in libs.items():  # K2's two kernels apart, at the long cases
        for case, (args, _, _) in work.items():
            if case[2] > 1000:
                split = kernel_ms(lambda: k2_call(lib, *args))
                print(json.dumps({"wide": name, "case": str(case), "K2 kernels ms": split}),
                      flush=True)
    return 0


def kernel_ms(fn, iters: int = 10) -> dict:
    """Device time of each kernel that `fn` launches, in ms a call
    (torch.profiler over `iters` calls after a warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.device_time_total / 1e3 / iters for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", nargs="?", choices=("k5k3", "k2", "wide"), default="k5k3")
    ap.add_argument("--parent", action="append",
                    help="another revision's csrc directory (k2, wide); may be repeated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip(), flush=True)
    if args.what == "k2":
        return k2(dev, args.parent)
    if args.what == "wide":
        return wide(dev, args.parent)
    return k5_k3(dev)


if __name__ == "__main__":
    sys.exit(main())
