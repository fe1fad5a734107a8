"""Time the default-config MASt3R step (the student at its configured fp32)
of one checkout's gd3d_torch on one NVIDIA GPU.

    python3 fp32_step.py [--root DIR] [--steps N]

The step is chip_smoke.py's "MASt3R fp32 student" run: the set-up is that
script's mast3r_setup (loaded from beside this file), the package is the
gd3d_torch found in DIR (default: this file's directory), so the same step
runs on another revision's kernels with no other change. Unpack that
revision with `git archive` into a gitignored directory and run, in one
process each and on one card:

    python3 fp32_step.py --root outputs/parent
    python3 fp32_step.py
    python3 fp32_step.py
    python3 fp32_step.py --root outputs/parent

After one warm-up step it times N steady steps (host clock around a step
that ends in torch.cuda.synchronize()) and profiles one more. It prints the
card line, then one JSON object: the step times in s, the peak memory of the
steady steps, and the profiled step's kernel time, and the device time and
launches of K2 (every kernel whose name holds "flash_bwd").
"""
from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path
import subprocess
import sys
import time

HERE = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose gd3d_torch runs")
    ap.add_argument("--steps", type=int, default=5, help="steady steps timed")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))  # before gd3d_torch is first imported
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("fp32_step: no CUDA device", file=sys.stderr)
        return 1
    import gd3d_torch

    if Path(gd3d_torch.__file__).resolve().parent.parent != root:
        print(f"fp32_step: gd3d_torch came from {gd3d_torch.__file__}, not {root}",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    step, *_, batch = smoke.mast3r_setup(dev, student_dtype="float32")
    step(batch, 1.0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(batch, 1.0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(batch, 1.0)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    k2 = [e for e in rows if "flash_bwd" in e.key]
    print(json.dumps({"root": str(root), "step_s": times, "peak_mem_gib": peak,
                      "kernel_ms": sum(e.device_time_total for e in rows) / 1e3,
                      "k2_device_ms": sum(e.device_time_total for e in k2) / 1e3,
                      "k2_launches": sum(e.count for e in k2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
