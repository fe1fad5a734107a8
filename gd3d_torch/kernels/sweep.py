"""Time K5 and K3 at the main paths' shapes for other values of their
compile-time tuning constants: the heads one K5 thread rotates
(GD3D_ROPE_HEADS in csrc/rope2d.cu: 4, 8, 16) and the rows one K3 block
holds (GD3D_KL_ROWS in csrc/cost_kl.cu: 1, 2, 4, 8). Needs a CUDA card and
nvcc:

    python3 -m gd3d_torch.kernels.sweep

Each setting is a library of the two sources built with -D flags into
gd3d_torch/build/ (all nvcc processes started together); the shipped
defaults, 4 and 4, are one of them. Every case is first checked against its
plain twin. The settings are timed in the order listed, then again in the
reverse order, each case by chip_smoke.py's method (kernels/timing.py). It
prints the card line, then one JSON object per setting and run: the median
device time in ms of each case, and a one-element add timed the same way
("floor", what a launch costs with no work).
"""
from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys

import torch

from gd3d_torch.kernels import build
from gd3d_torch.kernels.cost_kl import _reference_rows
from gd3d_torch.kernels.rope2d import _NO_TASK, _task, rope2d_plain, vec_width
from gd3d_torch.kernels.timing import time_ms
from gd3d_torch.ops.masks import masked_patch_cost
from gd3d_torch.ops.rope2d import grid_positions

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


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip(), flush=True)
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


if __name__ == "__main__":
    sys.exit(main())
