"""The port's configs and host data pipeline against gd3d's, on the CPU.

- every named config and every bundled YAML resolves, field by field, to
  what gd3d's resolve_config gives (dataclasses.asdict equality, exact);
- the YAML reader raises on an unknown combination and on lines it cannot
  read;
- the synthetic batches are bit-identical to gd3d's for the same seeds;
- pad_keypoints, collate and PrefetchIterator behave as gd3d's do (the
  cases of tests/test_train_runtime.py), and the device copier hands the
  step CPU tensors equal to the batch.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from gd3d.cli.train import _synthetic_teacher_batch as jsynthetic_teacher_batch
from gd3d.core import config as jcfglib
from gd3d.data import loader as jloader
from gd3d.data.synthetic import synthetic_me_batch as jsynthetic_me_batch
from gd3d_torch.core import config as cfglib
from gd3d_torch.data import loader
from gd3d_torch.data.synthetic import synthetic_me_batch, synthetic_teacher_batch

NAMES = sorted(cfglib.NAMED_CONFIGS)


def test_named_configs_are_gd3ds():
    assert sorted(jcfglib.NAMED_CONFIGS) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_config_resolves_field_by_field(name):
    """resolve_config(name) reads the bundled YAML in both packages; the
    factory alone must agree as well."""
    assert dataclasses.asdict(cfglib.resolve_config(name)) == dataclasses.asdict(
        jcfglib.resolve_config(name))
    assert dataclasses.asdict(cfglib.NAMED_CONFIGS[name]()) == dataclasses.asdict(
        jcfglib.NAMED_CONFIGS[name]())


@pytest.mark.parametrize("name", NAMES)
def test_bundled_yaml_matches_gd3ds(name):
    """Each of gd3d's YAML files, read by the port's reader, gives gd3d's
    config; the port's bundled copy gives the same."""
    import os

    jpath = os.path.join(os.path.dirname(jcfglib.__file__), "..", "configs", f"{name}.yaml")
    want = dataclasses.asdict(jcfglib.load_yaml_config(jpath))
    assert dataclasses.asdict(cfglib.load_yaml_config(jpath)) == want
    ppath = os.path.join(os.path.dirname(cfglib.__file__), "..", "configs", f"{name}.yaml")
    assert dataclasses.asdict(cfglib.load_yaml_config(ppath)) == want


def test_yaml_overrides_methods_and_refuses_what_it_cannot_read(tmp_path):
    p = tmp_path / "custom.yaml"
    p.write_text("# comment\nmatcher: vggt  # trailing\ndataset: objaverse\n"
                 "evaluation_methods:\n  - tracking\n")
    got, want = cfglib.resolve_config(str(p)), jcfglib.resolve_config(str(p))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.evaluation_methods == ("tracking",)
    bad = tmp_path / "bad.yaml"
    bad.write_text("matcher: nope\ndataset: scannetpp\n")
    with pytest.raises(ValueError, match="no named config"):
        cfglib.resolve_config(str(bad))
    for text in ("matcher: mast3r\nfoo: {a: 1}\n  b: 2\n", "matcher: [mast3r\n",
                 "just a line\n"):
        odd = tmp_path / "odd.yaml"
        odd.write_text(text)
        with pytest.raises(ValueError, match="cannot read"):
            cfglib.load_yaml_config(str(odd))


def test_yaml_with_document_marker_anchor_and_merge_resolves_as_gd3ds(tmp_path):
    """A config that starts with ---, shares its keys through an anchor and
    a << merge, and repeats a list by an alias: resolve_config gives what
    gd3d's load_yaml_config gives."""
    p = tmp_path / "merged.yaml"
    p.write_text("%YAML 1.1\n---\ncommon: &common\n  matcher: vggt\n  dataset: scannetpp\n"
                 "<<: *common\nevaluation_methods: &methods\n  - tracking\n  - pose\n"
                 "again: *methods\n...\n")
    got, want = cfglib.resolve_config(str(p)), jcfglib.load_yaml_config(str(p))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.evaluation_methods == ("tracking", "pose")


@pytest.mark.parametrize("seed,batch,img,n_kps", [(0, 1, 64, 64), (42, 2, 64, 128),
                                                   (10042, 1, 96, 300)])
def test_synthetic_me_batch_is_bit_identical(seed, batch, img, n_kps):
    got = synthetic_me_batch(seed, batch=batch, img=img, n_kps=n_kps)
    want = jsynthetic_me_batch(seed, batch=batch, img=img, n_kps=n_kps)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("name", [n for n in NAMES if "_me_" not in n])  # the teachers
@pytest.mark.parametrize("tiny", [True, False])
def test_synthetic_teacher_batch_is_bit_identical(name, tiny):
    cfg = cfglib.NAMED_CONFIGS[name]()
    got = synthetic_teacher_batch(cfg.teacher, cfg.dataset, 1, 10001, tiny=tiny)
    want = jsynthetic_teacher_batch(jcfglib.NAMED_CONFIGS[name](), 1, 10001, tiny=tiny)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("n,capacity,with_valid", [(5, 8, False), (8, 8, True), (11, 8, True)])
def test_pad_keypoints_matches_gd3d(n, capacity, with_valid):
    rng = np.random.RandomState(n)
    kps, pts = rng.rand(n, 2) * 64, rng.rand(n, 3)  # float64 in: both cast to float32
    valid = rng.rand(n) > 0.3 if with_valid else None
    for got, want in zip(loader.pad_keypoints(kps, pts, capacity, valid),
                         jloader.pad_keypoints(kps, pts, capacity, valid)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_collate_matches_gd3d():
    samples = [{"a": np.full((2,), i, np.float32), "name": "x", "none": None,
                "b": np.arange(3) + i} for i in range(3)]
    got, want = loader.collate(samples), jloader.collate(samples)
    assert got.keys() == want.keys() == {"a", "b"}
    for k in want:
        assert np.array_equal(got[k], want[k])


def test_prefetch_iterator_overlaps_and_preserves_order():
    def slow_gen():
        for i in range(5):
            time.sleep(0.05)
            yield i

    it = loader.PrefetchIterator(slow_gen(), depth=2)
    time.sleep(0.2)  # let the producer run ahead
    t0 = time.perf_counter()
    out = list(it)
    consumed = time.perf_counter() - t0
    assert out == [0, 1, 2, 3, 4]
    assert consumed < 0.25
    assert it.wait_time <= consumed + 1e-3


def test_prefetch_iterator_propagates_errors():
    def bad_gen():
        yield 1
        raise RuntimeError("boom")

    it = loader.PrefetchIterator(bad_gen())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_prefetch_loader_draws_as_gd3ds_and_raises_errors():
    data = [{"x": np.full((2,), i, np.float32)} for i in range(10)]
    got = list(loader.PrefetchLoader(data, batch_size=3, steps_per_epoch=4, seed=7))
    want = list(jloader.PrefetchLoader(data, batch_size=3, steps_per_epoch=4, seed=7))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert np.array_equal(g["x"], w["x"])

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError("decode failed")

    with pytest.raises(KeyError, match="decode failed"):
        list(loader.PrefetchLoader(Broken(), batch_size=1, steps_per_epoch=2))


def test_device_copier_on_the_cpu():
    batch = synthetic_me_batch(0, batch=1, img=32, n_kps=16)
    out = loader.DeviceCopier("cpu")(batch)
    assert out.event is None and out.ready() is out
    for k, v in batch.items():
        assert out[k].device.type == "cpu" and np.array_equal(out[k].numpy(), v)
        assert out[k].dtype == torch.from_numpy(v).dtype
