"""The port's FiT3D comparison harness (gd3d_torch/eval/fit3d.py) against
gd3d's (gd3d/eval/fit3d.py) on the CPU, with gd3d's own fixtures
(tests/test_fit3d.py: a tiny timm-layout state dict, PF-PASCAL, DAVIS and
OnePose trees):

- a local .pth loads into the vanilla student as gd3d's graft does, tensor
  by tensor (gd3d's params carried over by gd3d_torch/convert.py);
- an http(s) checkpoint goes through torch.hub.load_state_dict_from_url
  (monkeypatched: no download) with map_location="cpu", unwraps 'model' and
  'state_dict', and loads the same weights;
- compare() with both models from local files: gd3d's '{eval}/{model}'
  keys, the PCK and pose tables byte for byte as CSV, tracking within 1e-6,
  and refine=False in every evaluation;
- `python -m gd3d_torch.eval.fit3d --tiny --device cpu` prints and returns
  the tables.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import test_fit3d as gfix
from gd3d.core.config import StudentConfig as JStudentConfig
from gd3d.eval import fit3d as jfit3d
from gd3d_torch.convert import student_state_dict
from gd3d_torch.core.config import StudentConfig
from gd3d_torch.eval import fit3d
from gd3d_torch.models.student import Student

SMALL = dict(embed_dim=32, depth=2, num_heads=2, patch_size=16, pretrain_img_size=32,
             lora_start_block=99, use_adapters=False, target_res=64, depth_head_hidden=16)


def _vit_state(student):
    return {k: v for k, v in student.state_dict().items() if k.startswith("vit.")}


def _assert_same_vit(got_student, jparams, jcfg):
    want = {k: v for k, v in student_state_dict(jax.device_get(jparams), jcfg).items()
            if k.startswith("vit.")}
    got = _vit_state(got_student)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_local_pth_loads_as_gd3ds_graft(tmp_path):
    ckpt = tmp_path / "fit3d.pth"
    torch.save(gfix._timm_state(gfix.SMALL), ckpt)
    _, jparams = jfit3d.load_fit3d_student(str(ckpt), cfg=gfix.SMALL)
    got = fit3d.load_fit3d_student(str(ckpt), cfg=StudentConfig(**SMALL), device="cpu")
    _assert_same_vit(got, jparams, gfix.SMALL)
    assert not any(p.requires_grad for p in got.parameters()) and not got.training


@pytest.mark.parametrize("nest", [None, "model", "state_dict"])
def test_url_goes_through_torch_hub(monkeypatch, tmp_path, nest):
    st = gfix._timm_state(gfix.SMALL)
    calls = {}

    def fake_load(url, map_location=None):
        calls.update(url=url, map_location=map_location)
        return st if nest is None else {nest: st, "epoch": 3}

    monkeypatch.setattr(torch.hub, "load_state_dict_from_url", fake_load)
    got = fit3d.load_fit3d_student("https://example.com/clip_base_finetuned.pth",
                                   cfg=StudentConfig(**SMALL), device="cpu")
    assert calls == {"url": "https://example.com/clip_base_finetuned.pth", "map_location": "cpu"}
    torch.save(st, tmp_path / "local.pth")
    local = fit3d.load_fit3d_student(str(tmp_path / "local.pth"), cfg=StudentConfig(**SMALL),
                                     device="cpu")
    for k, v in _vit_state(local).items():
        torch.testing.assert_close(_vit_state(got)[k], v, rtol=0, atol=0)


def test_constants_are_gd3ds():
    assert fit3d.FIT3D_CKPT_URL == jfit3d.FIT3D_CKPT_URL
    assert dataclasses.asdict(fit3d.VANILLA_CFG) == dataclasses.asdict(jfit3d.VANILLA_CFG)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit3d")
    data_root = root / "data"
    gfix._pascal_fixture(data_root)
    gfix._tracking_fixture(data_root)
    gfix._onepose_fixture(data_root)
    for seed, name in ((0, "fit3d.pth"), (1, "vanilla.pth")):
        torch.save(gfix._timm_state(gfix.SMALL, seed), root / name)
    return root


def test_compare_matches_gd3d(data, tmp_path, monkeypatch):
    kw = dict(data_root=str(data / "data"), run_transfer=True, run_tracking=True,
              run_pose=True, num_videos=1, transfer_kwargs={"img_size": 64, "categories": ["cat"]})
    want = jfit3d.compare(str(data / "fit3d.pth"), str(data / "vanilla.pth"), cfg=gfix.SMALL, **kw)
    refines = []
    dense = Student.dense_grid_features

    def spy(self, *a, **k):
        refines.append(k.get("refine", True))
        return dense(self, *a, **k)

    monkeypatch.setattr(Student, "dense_grid_features", spy)
    got = fit3d.compare(str(data / "fit3d.pth"), str(data / "vanilla.pth"),
                        cfg=StudentConfig(**SMALL), device="cpu", **kw)
    assert list(got) == list(want) == [f"{e}/{m}" for m in ("fit3d", "vanilla")
                                       for e in ("transfer", "tracking", "pose")]
    assert refines and not any(refines)
    for key in want:
        want[key].to_csv(tmp_path / "want.csv")
        got[key].to_csv(tmp_path / "got.csv")
        if key.startswith("tracking"):
            w = want[key]
            assert got[key].index == list(w.index)
            for col in w.columns:
                np.testing.assert_allclose(got[key].columns[col], w[col].to_numpy(), rtol=1e-6,
                                           atol=1e-6)
        else:
            assert (tmp_path / "got.csv").read_bytes() == (tmp_path / "want.csv").read_bytes(), key


def test_main_runs_tiny(data, capsys):
    cfg = dataclasses.replace(fit3d.VANILLA_CFG, embed_dim=32, depth=4, num_heads=2,
                              pretrain_img_size=32, depth_head_hidden=16)
    jcfg = JStudentConfig(**dataclasses.asdict(cfg))
    torch.save(gfix._timm_state(jcfg, 2), data / "tiny.pth")
    res = fit3d.main(["--fit3d-ckpt", str(data / "tiny.pth"), "--vanilla-ckpt",
                      str(data / "tiny.pth"), "--data-root", str(data / "data"), "--pose",
                      "--tiny", "--device", "cpu"])
    assert list(res) == ["pose/fit3d", "pose/vanilla"]
    assert res["pose/fit3d"].columns == res["pose/vanilla"].columns
    out = capsys.readouterr().out
    assert "===== pose/fit3d" in out and "threshold_5" in out
