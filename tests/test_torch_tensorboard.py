"""The port's TensorBoard event files (gd3d_torch/core/tensorboard.py,
`--tensorboard` of gd3d_torch.cli.train) against TensorBoard's own reader
and TensorFlow's writer.

- The tiny ME run with --tensorboard on the CPU: its event file, read back
  with tensorboard's EventAccumulator, holds every metrics.jsonl record as
  TF2 scalars (rank-0 DT_FLOAT tensors, plugin "scalars"): the same tags,
  steps (epoch * steps + step) and values (float32, so compared after
  rounding the JSON value to float32).
- Where tensorflow imports: tf.summary.scalar writes the same records, and
  both files decode to the same (step, tag, value) list, each Value message
  byte for byte. Skipped where TF is absent.
- The port's reader checks every CRC: crc32c's check value, and a flipped
  byte raises.

TensorBoard and TensorFlow run in a subprocess: the port must not import
them, and TF in a test worker would load its own runtime there.
"""
import importlib.util
import json
import subprocess
import sys

import numpy as np
import pytest

from gd3d_torch.cli import train
from gd3d_torch.core.tensorboard import (crc32c, encode_event, frame_record, masked_crc32c,
                                         read_events)

READ = """
import json, sys
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
from tensorboard.util import tensor_util
out = []
for path in sys.argv[1:]:
    acc = EventAccumulator(path, size_guidance={"tensors": 0})
    acc.Reload()
    out.append(sorted((e.step, tag, float(tensor_util.make_ndarray(e.tensor_proto)))
                      for tag in acc.Tags()["tensors"] for e in acc.Tensors(tag)))
print(json.dumps(out))
"""

WRITE_TF = """
import json, sys
import tensorflow as tf
records = json.load(open(sys.argv[2]))
writer = tf.summary.create_file_writer(sys.argv[1])
for step, rec in records:
    with writer.as_default(step=step):
        for k, v in rec.items():
            tf.summary.scalar(k, v)
writer.close()
"""


def _run(script, *args):
    res = subprocess.run([sys.executable, "-c", script, *map(str, args)], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("tb") / "run"
    train.main(["--config", "finetune_timm_me_objaverse", "--tiny", "--dev", "--device", "cpu",
                "--tensorboard", "--output", str(out)])
    return out


def _records(run_dir):
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return [r for r in recs if "step" in r]


def test_event_file_reads_back_with_tensorboard(run_dir):
    (event_file,) = (run_dir / "tb").glob("events.out.tfevents.*")
    version, mine = read_events(event_file)
    assert version == "brain.Event:2"
    (got,) = json.loads(_run(READ, event_file))
    steps = 2  # --dev
    want = sorted((r["epoch"] * steps + r["step"], k, float(np.float32(v)))
                  for r in _records(run_dir) for k, v in r.items())
    assert len(want) == len(_records(run_dir)) * len(_records(run_dir)[0]) > 0
    assert [tuple(x) for x in got] == want
    assert sorted(mine) == want


def test_event_file_matches_tf_summary(run_dir, tmp_path):
    if importlib.util.find_spec("tensorflow") is None:
        pytest.skip("tensorflow is not installed")
    steps = 2
    records = [(r["epoch"] * steps + r["step"], r) for r in _records(run_dir)]
    (tmp_path / "records.json").write_text(json.dumps(records))
    _run(WRITE_TF, tmp_path / "tf", tmp_path / "records.json")
    (tf_file,) = (tmp_path / "tf").glob("events.out.tfevents.*")
    (mine_file,) = (run_dir / "tb").glob("events.out.tfevents.*")
    assert sorted(read_events(tf_file)[1]) == sorted(read_events(mine_file)[1])
    theirs, mine = json.loads(_run(READ, tf_file, mine_file))
    assert theirs == mine
    # each scalar's Summary message byte for byte (the Events around them
    # differ in wall_time only)
    from gd3d_torch.core.tensorboard import _fields, read_records

    def values(path):
        return sorted(bytes(v) for rec in read_records(path) for f, _, v in _fields(rec)
                      if f == 5)

    assert values(tf_file) == values(mine_file)


def test_record_crcs():
    assert crc32c(b"123456789") == 0xE3069283  # CRC-32C's check value
    rec = frame_record(encode_event(1.5, 7, scalar=("loss", 0.25)))
    assert rec[8:12] == masked_crc32c(rec[:8]).to_bytes(4, "little")
    assert rec[-4:] == masked_crc32c(rec[12:-4]).to_bytes(4, "little")


def test_reader_refuses_a_corrupt_record(tmp_path):
    good = frame_record(encode_event(1.0, file_version="brain.Event:2")) + frame_record(
        encode_event(2.0, 3, scalar=("loss", 0.5)))
    (tmp_path / "ok").write_bytes(good)
    assert read_events(tmp_path / "ok") == ("brain.Event:2", [(3, "loss", 0.5)])
    bad = bytearray(good)
    bad[-6] ^= 0x01  # a byte of the last record's data
    (tmp_path / "bad").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        read_events(tmp_path / "bad")
    (tmp_path / "short").write_bytes(good[:-3])
    with pytest.raises(ValueError, match="truncated"):
        read_events(tmp_path / "short")
