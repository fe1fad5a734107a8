"""The port's training CLI on the CPU at --tiny sizes (gd3d's --tiny
overrides) with synthetic data, driven in-process through
gd3d_torch.cli.train.main:

- each of the five named configs trains and writes gd3d's metrics.jsonl
  record keys, the adapter checkpoint and the restart state;
- --multistep 4 over 5 steps rounds the epoch up and logs steps 0-7;
- two epochs straight equal one epoch plus --resume, exactly (every
  logged number but the timings);
- --student-ckpt and --teacher-ckpt load upstream-layout state dicts that
  the test writes (only LoRA and adapter keys may be missing);
- every flag the port does not bring raises at start, as does --device
  cuda without a card; with OnePose data under --data-root the eval epoch
  runs the pose evaluation (the other evaluations' epoch is
  tests/test_torch_eval.py's);
- on fabricated ScanNet++ and Objaverse trees (gd3d_torch/data/fixtures.py)
  the ME, ScanNet++ MASt3R and Objaverse VGGT configs train a step on real
  data; --workers 2 and --workers 1 give the same host batches; an error in
  a worker is raised; a missing --data-root falls back to synthetic data
  with gd3d's warning.
"""
import json
import math

import numpy as np
import pytest
import torch

from gd3d_torch.cli import train
from gd3d_torch.core.config import NAMED_CONFIGS
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TEACHER_KEYS = {"loss", "ap_loss", "depth_loss", "intra_depth_loss", "kl_loss", "num_kps"}
ME_KEYS = {"loss", "ap_pos_overflow"}


def _main(tmp_path, *argv, name="run"):
    out = tmp_path / name
    run = train.main(["--tiny", "--synthetic", "--device", "cpu", "--output", str(out), *argv])
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    return run, out, records


@pytest.mark.parametrize("config", sorted(NAMED_CONFIGS))
def test_each_config_trains_and_writes_gd3ds_records(tmp_path, config):
    run, out, records = _main(tmp_path, "--config", config, "--epochs", "1",
                              "--steps-per-epoch", "2")
    keys = ME_KEYS if "_me_" in config else TEACHER_KEYS
    steps = [r for r in records if "step" in r]
    epochs = [r for r in records if "step" not in r]
    assert [r["step"] for r in steps] == [0, 1]
    for r in steps:
        assert set(r) == keys | {"epoch", "step", "time_s", "temperature"}
        assert all(isinstance(v, (int, float)) for v in r.values())
        assert r["temperature"] == 1.0 and r["epoch"] == 0
    assert len(epochs) == 1
    assert set(epochs[0]) == {f"epoch/{k}" for k in keys} | {
        "epoch", "epoch/host_wait_s", "epoch/wall_s"}
    assert (out / "ckpt_epoch_0001").exists() and (out / "last").exists()
    assert run.optimizer.calls == 2


def test_multistep_rounds_the_epoch_up(tmp_path):
    run, _, records = _main(tmp_path, "--config", "finetune_timm_mast3r_objaverse",
                            "--epochs", "1", "--steps-per-epoch", "5", "--multistep", "4")
    assert [r["step"] for r in records if "step" in r] == list(range(8))
    assert run.K == 4 and run.optimizer.calls == 8


@pytest.mark.parametrize("config", ["finetune_timm_me_objaverse",
                                    "finetune_timm_vggt_scannetpp"])
def test_resume_equals_the_straight_run(tmp_path, config):
    common = ["--config", config, "--steps-per-epoch", "2"]
    _, _, straight = _main(tmp_path, *common, "--epochs", "2", name="straight")
    _, first, _ = _main(tmp_path, *common, "--epochs", "1", name="split")
    run, _, resumed = _main(tmp_path, *common, "--epochs", "2", "--resume",
                            str(first / "last"), name="split")
    assert run.start_epoch == 1

    def numbers(records):
        return [{k: v for k, v in r.items() if k not in ("time_s", "epoch/host_wait_s",
                                                          "epoch/wall_s")} for r in records]

    assert len(straight) == len(resumed) == 6
    assert numbers(straight) == numbers(resumed)
    assert [r["temperature"] for r in resumed if "step" in r] == [1.0, 1.0, 0.75, 0.75]


def test_upstream_checkpoints_load(tmp_path):
    """A timm-layout student file (no LoRA keys, an extra classifier head)
    and a MASt3R file nested under 'model', written by the test from the
    port's own modules, load as they are."""
    run, _, _ = _main(tmp_path, "--config", "finetune_timm_mast3r_scannetpp", "--epochs", "1",
                      "--steps-per-epoch", "1", name="source")
    g = torch.Generator().manual_seed(3)
    vit = {k: torch.randn(v.shape, generator=g) for k, v in run.student.vit.state_dict().items()
           if ".lora_" not in k}
    vit["head.weight"] = torch.zeros(10, 32)
    teacher = {k: torch.randn(v.shape, generator=g) * 0.05
               for k, v in run.teacher.model.state_dict().items()}
    torch.save(vit, tmp_path / "timm.pth")
    torch.save({"model": teacher}, tmp_path / "mast3r.pth")
    loaded = train.setup(train.parse_args([
        "--tiny", "--synthetic", "--device", "cpu", "--output", str(tmp_path / "loaded"),
        "--config", "finetune_timm_mast3r_scannetpp", "--student-ckpt",
        str(tmp_path / "timm.pth"), "--teacher-ckpt", str(tmp_path / "mast3r.pth")]))
    for k, v in loaded.student.vit.state_dict().items():
        if ".lora_" not in k:
            assert torch.equal(v, vit[k]), k
    for k, v in loaded.teacher.model.state_dict().items():
        assert torch.equal(v, teacher[k]), k
    del vit["blocks.0.attn.qkv.weight"]
    torch.save(vit, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="blocks.0.attn.qkv.weight"):
        train.setup(train.parse_args([
            "--tiny", "--synthetic", "--device", "cpu", "--output", str(tmp_path / "x"),
            "--student-ckpt", str(tmp_path / "short.pth")]))


@pytest.mark.parametrize("flags,error,match", [
    (["--workers", "-1"], ValueError, "--workers"),
    (["--multistep", "0"], ValueError, "--multistep"),
    (["--fsdp-teacher"], ValueError, "--multihost"),
    (["--multihost"], RuntimeError, "MASTER_ADDR"),
])
def test_refused_flags_raise(tmp_path, flags, error, match):
    with pytest.raises(error, match=match):
        train.main(["--tiny", "--synthetic", "--device", "cpu", "--output",
                    str(tmp_path / "r"), *flags])
    assert not (tmp_path / "r").exists()  # refused before any work


def test_real_data_and_missing_card_raise(tmp_path):
    """An existing --data-root is real data, as in gd3d: without the
    config's files the first batch raises."""
    (tmp_path / "data").mkdir()
    with pytest.raises(FileNotFoundError, match="10k.txt"):
        train.main(["--tiny", "--device", "cpu", "--data-root", str(tmp_path / "data"),
                    "--output", str(tmp_path / "r")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="sees none"):
            train.main(["--tiny", "--synthetic", "--output", str(tmp_path / "r")])


def test_eval_epoch_runs_pose_where_its_data_exist(tmp_path):
    """No eval data: no summary. A fabricated OnePose-LowTexture tree
    (gd3d_torch/data/fixtures.py::write_onepose_tree): the eval epoch runs
    the pose evaluation and logs eval/pose/<col>."""
    from gd3d_torch.data.fixtures import write_onepose_tree

    root = tmp_path / "evaldata"
    root.mkdir()
    _, _, records = _main(tmp_path, "--epochs", "1", "--steps-per-epoch", "1",
                          "--eval-every", "1", "--data-root", str(root), "--debug-nans")
    assert all("eval" not in k for r in records for k in r)  # no data: no summary
    write_onepose_tree(root, size=(64, 80), known_kps=30, bank_frames=2, bank_kps=30,
                       bank_tests=2)
    _, out, records = _main(tmp_path, "--epochs", "1", "--steps-per-epoch", "1",
                            "--eval-every", "1", "--data-root", str(root), name="with_data")
    summary = [r for r in records if any(k.startswith("eval/") for k in r)]
    assert len(summary) == 1
    assert {f"eval/pose/threshold_{t}" for t in (1, 3, 5)} <= set(summary[0])
    assert summary[0]["eval/pose/threshold_1"] == 0.5  # the known answer's 1.0 in the mean
    assert (out / "epoch_1" / "pose_estimation.csv").exists()


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """A fabricated tree of both datasets, its ScanNet++ frames a 584x389
    JPEG (the 1752x1168 fixture is chip_smoke.py's)."""
    import numpy as np
    from PIL import Image

    from gd3d_torch.data import fixtures

    root = tmp_path_factory.mktemp("data")
    frame = root / "frame.jpg"
    rng = np.random.RandomState(0)
    Image.fromarray(rng.randint(0, 256, (389, 584, 3), dtype=np.uint8)).save(frame)
    fixtures.write_scannetpp_tree(root, jpeg=frame)
    fixtures.write_objaverse_tree(root)
    return root


def _real(tmp_path, data_root, config, *argv, name="run"):
    out = tmp_path / name
    run = train.main(["--tiny", "--device", "cpu", "--config", config, "--data-root",
                      str(data_root), "--epochs", "1", "--steps-per-epoch", "1",
                      "--output", str(out), *argv])
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    return run, records


@pytest.mark.parametrize("config,workers", [
    ("finetune_timm_me_objaverse", "0"),
    ("finetune_timm_mast3r_scannetpp", "2"),
    ("finetune_timm_vggt_objaverse", "0"),
])
def test_real_data_trains_a_step(tmp_path, data_root, config, workers):
    run, records = _real(tmp_path, data_root, config, "--workers", workers)
    steps = [r for r in records if "step" in r]
    assert len(steps) == 1 and run.optimizer.calls == 1
    assert all(math.isfinite(v) for v in steps[0].values())
    if workers == "0":  # (main() stopped a pool's workers)
        _, batch = next(train.host_batches(run, 0))
        assert all(v.dtype == np.uint8 for k, v in batch.items() if k.startswith("rgb"))


def _host_batches(data_root, tmp_path, workers, steps=2):
    run = train.setup(train.parse_args([
        "--tiny", "--device", "cpu", "--config", "finetune_timm_mast3r_objaverse",
        "--data-root", str(data_root), "--steps-per-epoch", str(steps), "--workers",
        str(workers), "--output", str(tmp_path / f"w{workers}")]))
    try:
        return [b for _, b in train.host_batches(run, 0)]
    finally:
        run.close()


def test_workers_give_the_same_batches(tmp_path, data_root):
    one, two = _host_batches(data_root, tmp_path, 1), _host_batches(data_root, tmp_path, 2)
    assert len(one) == len(two) == 2
    for a, b in zip(one, two):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_an_error_in_a_worker_is_raised(tmp_path, data_root):
    import shutil

    broken = tmp_path / "broken"
    shutil.copytree(data_root, broken)
    for p in (broken / "scannetpp" / "scenes").rglob("*.JPG"):
        p.write_bytes(b"\xff\xd8 not a jpeg")
    with pytest.raises(ValueError, match="JPEG"):
        _real(tmp_path, broken, "finetune_timm_mast3r_scannetpp", "--workers", "2")


def test_a_missing_data_root_falls_back_to_synthetic_data(tmp_path, capsys):
    run, _, records = _main(tmp_path, "--epochs", "1", "--steps-per-epoch", "1")
    assert "WARNING: data root" not in capsys.readouterr().out  # --synthetic: no warning
    out = tmp_path / "fallback"
    run = train.main(["--tiny", "--device", "cpu", "--data-root", str(tmp_path / "none"),
                      "--epochs", "1", "--steps-per-epoch", "1", "--output", str(out)])
    assert f"WARNING: data root {tmp_path / 'none'} missing; synthetic data" in \
        capsys.readouterr().out
    assert run.optimizer.calls == 1
