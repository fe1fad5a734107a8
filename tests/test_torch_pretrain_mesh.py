"""`gd3d_torch.cli.pretrain --mesh 2` on the CPU: two gloo processes under
torchrun (localhost rendezvous), each holding one row of a batch of 2,
against one process on the whole batch, on the mast3r objective (its
regression and matching means; the CroCo MSE's share is
tests/test_torch_pretrain_ops.py's).

The ranks' shares of every masked mean sum to the one-process values and
their gradients are summed before the clip, so metrics.jsonl matches to
its rounding (2e-5 absolute plus 1e-5 relative) and params_final.npz to
1e-5 of the largest parameter (fp32 sums split in two).
"""
import json
import os
import subprocess
import sys

import numpy as np

from gd3d_torch.cli import pretrain as P
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_mesh_two_gloo_ranks_equal_one_process(tmp_path):
    flags = ["--objective", "mast3r", "--tiny", "--cpu", "--batch", "2", "--steps", "2",
             "--corres", "16", "--lr", "1e-3"]
    P.main(["--output", str(tmp_path / "one"), *flags])
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "gd3d_torch.cli.pretrain", "--output", str(tmp_path / "two"), "--mesh", "2",
         *flags], env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    one, two = ([json.loads(line) for line in (tmp_path / d / "metrics.jsonl").read_text().splitlines()]
                for d in ("one", "two"))
    assert len(one) == len(two) == 2
    for a, b in zip(one, two):
        assert set(a) == set(b)
        for k in a:
            assert abs(a[k] - b[k]) <= 2e-5 + 1e-5 * abs(a[k]), (k, a[k], b[k])
    with np.load(tmp_path / "one" / "params_final.npz") as za, \
            np.load(tmp_path / "two" / "params_final.npz") as zb:
        top = max(np.abs(za[k]).max() for k in za.files)
        for k in za.files:
            assert np.abs(za[k] - zb[k]).max() <= 1e-5 * top, k
    assert not (tmp_path / "two" / "proc1").exists()  # rank 0 alone writes
