"""The data x model mesh on four cards (gd3d_torch/core/mesh.py,
parallel/sharding.py, parallel/sequence.py, parallel/fsdp.py): the train
CLI on finetune_timm_vggt_scannetpp --dev (full width: the ViT-B/16 student,
the VGGT-1B teacher with its aggregator in bf16, 518^2 frames) at mesh
2 x 2 with sequence_parallel and --fsdp-teacher, as 4 ranks on NCCL
(torch.distributed.run): the teacher sliced over each model group of 2,
FSDP-sharded over each data group of 2, its global attention on the ring
over the model group (the heads gathered for it). Against one card at the
same global batch (--batch-per-device 2, no mesh).

Every test carries the `cuda` marker and skips without four NVIDIA GPUs.
Run it where there are four, from the repo root:

    python -m pytest --noconftest -q -s tests/test_torch_parallel_cuda.py

It prints one JSON line: each run's step records, step times and each
card's peak memory, with nvidia-smi's name and power limit.

Tolerance: the keypoint count equal, each loss within BF16_TEACHER_TOL
(5e-2 relative, chip_smoke.py's bound for the bf16 teacher) of the one-card
run's: the mesh's ranks round their partial row-parallel products to bf16
before the all-reduce, where one card rounds each whole sum once, and the
ring merges bf16 blocks; in fp32 the CPU locks hold the same layout to 5e-4
(tests/test_torch_sequence_parallel.py).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

BF16_TEACHER_TOL = 5e-2
TIMEOUT_S = 900
LOSSES = ("loss", "ap_loss", "depth_loss", "intra_depth_loss", "kl_loss")
ROOT = Path(__file__).resolve().parents[1]
WORKER = str(ROOT / "tests" / "torch_parallel_worker.py")


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs: the 2 x 2 mesh puts one rank on each")


def _run(cmd, out: Path) -> tuple:
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT_S,
                         env=dict(os.environ, OMP_NUM_THREADS="4"))
    assert res.returncode == 0, (res.stdout[-4000:], res.stderr[-4000:])
    peaks = [json.loads(line) for line in res.stdout.splitlines() if line.startswith('{"rank"')]
    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    return [r for r in recs if "step" in r], sorted(peaks, key=lambda p: p["rank"])


def test_vggt_mesh_2x2_sequence_parallel_matches_one_card(four_cards, tmp_path):
    base = ["--config", "finetune_timm_vggt_scannetpp", "--dev"]
    mesh_steps, mesh_peaks = _run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         WORKER, "model=2", "sequence_parallel=1", "--"] + base + [
            "--multihost", "--fsdp-teacher", "--output", str(tmp_path / "mesh")],
        tmp_path / "mesh")
    one_steps, one_peaks = _run([sys.executable, WORKER, "--"] + base + [
        "--batch-per-device", "2", "--output", str(tmp_path / "one")], tmp_path / "one")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"gpu": gpu.strip().splitlines()[0], "mesh_2x2": {
        "steps": mesh_steps, "peak_gib": mesh_peaks}, "one_card": {
        "steps": one_steps, "peak_gib": one_peaks}}), flush=True)
    assert len(mesh_steps) == len(one_steps) == 2 and len(mesh_peaks) == 4
    for a, b in zip(mesh_steps, one_steps):
        assert a["num_kps"] == b["num_kps"] > 0
        for k in LOSSES:
            assert abs(a[k] - b[k]) <= BF16_TEACHER_TOL * max(abs(b[k]), 1e-6), (k, a[k], b[k])
