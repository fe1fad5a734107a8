"""The port's OnePose-LowTexture evaluation against gd3d's on the CPU, with one
seeded gd3d init of gd3d's eval config SMALL (embed 32, depth 2, patch 16)
carried into the port (gd3d_torch/convert.py::student_state_dict):

- cv2's INTER_LINEAR resize of float64 images (resample.resize_linear_cv):
  bit for bit at 2x and at sizes that are not multiples of 8, inside the
  1e-12 the descriptors need;
- frame_descriptors to 1e-5 (fp32 sums in another order), mutual_nn_match
  with equal indices (ties kept on the first index), grid_keypoints and
  query_pose_error (its clamp and its NaN) exactly;
- load_onepose_object on gd3d's driver fixture (tests/test_eval_drivers.py,
  PNGs written by cv2): equal arrays, the PNGs also decoded in a pool;
- evaluate_object with a capped template bank, and oneposepp on a tree from
  gd3d_torch/data/fixtures.py::write_onepose_tree, whose known-answer object
  scores 1.0 at every threshold: equal tables, the CSV bytes of gd3d's
  DataFrame.to_csv;
- gd3d_torch.cli.evaluate --pose --tiny --device cpu writes gd3d's
  pose_estimation.csv byte for byte on the same tree and weights (the
  train CLI's eval epoch is tests/test_torch_cli.py's).
"""
import json

import cv2
import jax
import numpy as np
import pytest
import torch

from gd3d.core.config import StudentConfig as JStudentConfig
from gd3d.eval import onepose as jonepose
from gd3d.models.student import Student as JStudent
from gd3d.ops.geometry import query_pose_error as jquery_pose_error
from gd3d_torch.cli import evaluate
from gd3d_torch.convert import student_state_dict
from gd3d_torch.core.config import StudentConfig
from gd3d_torch.data import fixtures
from gd3d_torch.data.resample import resize_linear_cv
from gd3d_torch.eval import onepose
from gd3d_torch.eval.images import make_pool
from gd3d_torch.models.student import Student
from gd3d_torch.ops.geometry import query_pose_error

SMALL = dict(embed_dim=32, depth=2, num_heads=2, patch_size=16, pretrain_img_size=32,
             lora_start_block=99, use_adapters=False, target_res=64, depth_head_hidden=16)
TREE = dict(size=(64, 80), known_kps=40, bank_frames=3, bank_kps=40, bank_tests=2)


def _port_student(jcfg, params, cfg):
    student = Student(cfg)
    student.load_state_dict(student_state_dict(jax.device_get(params), jcfg))
    return student.requires_grad_(False).eval()


@pytest.fixture(scope="module")
def students():
    jcfg = JStudentConfig(**SMALL)
    jstudent = JStudent(jcfg)
    params = jstudent.init(jax.random.key(0), img_size=32)
    return jstudent, params, _port_student(jcfg, params, StudentConfig(**SMALL))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("onepose")
    info = fixtures.write_onepose_tree(root, **TREE)
    return root, info


def _dirs(root):
    return str(root / "lowtexture_test_data"), str(root / "sfm_output" / "outputs_softmax_loftr_loftr")


@pytest.mark.parametrize("hw,out_hw", [((64, 80), (128, 160)), ((512, 512), (1024, 1024)),
                                       ((37, 53), (70, 101)), ((50, 61), (23, 41)),
                                       ((45, 30), (90, 60)), ((33, 17), (8, 50))])
def test_resize_linear_matches_cv2(hw, out_hw):
    rng = np.random.RandomState(hw[0])
    img = rng.randint(0, 256, hw + (3,)).astype(np.float64) / 255.0
    want = cv2.resize(img, out_hw[::-1])
    got = resize_linear_cv(img, out_hw[::-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("hw", [(40, 56), (64, 64)])
def test_frame_descriptors_match_gd3d(students, refine, hw):
    jstudent, params, student = students
    rng = np.random.RandomState(hw[1] + refine)
    rgb = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    kps = rng.uniform(0, [hw[1] - 1, hw[0] - 1], (37, 2))
    want = jonepose.frame_descriptors(jstudent, params, rgb, kps, refine)
    got = onepose.frame_descriptors(student, rgb, kps, refine)
    assert got.shape == want.shape == (37, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_mutual_nn_match_matches_gd3d():
    """Both directions over more than one ROW_CHUNK of rows."""
    rng = np.random.RandomState(2)
    desc_q = rng.randn(onepose.ROW_CHUNK + 300, 8).astype(np.float32)
    desc_t = rng.randn(onepose.ROW_CHUNK + 500, 8).astype(np.float32)
    desc_t[250:260] = desc_t[240:250]  # exact ties: the first index wins
    desc_q[:20] = desc_t[240:260] * 3
    for d in (desc_q, desc_t):
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = jonepose.mutual_nn_match(desc_q, desc_t)
    got = onepose.mutual_nn_match(torch.from_numpy(desc_q), torch.from_numpy(desc_t))
    np.testing.assert_array_equal(got, want)
    assert (got[:10] == np.arange(240, 250)).all() and (got >= 0).sum() > 20


def test_grid_keypoints_and_pose_error_match_gd3d():
    for h, w, s in ((64, 80, 4), (37, 53, 4), (16, 9, 3)):
        np.testing.assert_array_equal(onepose.grid_keypoints(h, w, s),
                                      jonepose.grid_keypoints(h, w, s))
    rng = np.random.RandomState(4)
    R = cv2.Rodrigues(np.array([0.1, 0.2, -0.3]))[0]
    cases = [(np.eye(4), np.eye(4)), (rng.randn(4, 4), rng.randn(3, 4)),
             (np.eye(4), np.diag([-1.0, -1.0, -1.0, 1.0]))]  # trace -3: arccos(-2) is NaN
    cases.append((np.hstack([R, rng.randn(3, 1)]), np.vstack([np.hstack([R.T, np.zeros((3, 1))]),
                                                            [0, 0, 0, 1]])))
    for pred, gt in cases:
        for unit in ("m", "cm", "mm"):
            got, want = query_pose_error(pred, gt, unit), jquery_pose_error(pred, gt, unit)
            np.testing.assert_array_equal(np.array(got), np.array(want))
    assert np.isnan(query_pose_error(*cases[2])[0])


def _gd3d_driver_tree(tmp_path):
    """gd3d's OnePose driver fixture (tests/test_eval_drivers.py:60-105)."""
    rng = np.random.RandomState(1)
    root, sfm, obj = tmp_path / "lowtexture", tmp_path / "sfm", "0700-toy"
    H, W = 64, 80
    (root / obj / "toy-1" / "anno_loftr").mkdir(parents=True)
    (root / obj / "toy-1" / "color").mkdir(parents=True)
    (sfm / obj / "anno").mkdir(parents=True)
    np.savez(sfm / obj / "anno" / "anno_3d_average.npz", keypoints3d=rng.rand(20, 3) * 0.1)
    for idx in ("0", "1"):
        kp2d = rng.rand(8, 2) * [W - 8, H - 8] + 4
        with open(root / obj / "toy-1" / "anno_loftr" / f"{idx}.json", "w") as f:
            json.dump({"keypoints2d": kp2d.tolist(),
                       "assign_matrix": [list(range(8)), list(range(8))]}, f)
        cv2.imwrite(str(root / obj / "toy-1" / "color" / f"{idx}.png"),
                    rng.randint(0, 255, (H, W, 3), np.uint8))
    for sub in ("color", "intrin_ba", "poses_ba"):
        (root / obj / "toy-2" / sub).mkdir(parents=True)
    cv2.imwrite(str(root / obj / "toy-2" / "color" / "0.png"),
                rng.randint(0, 255, (H, W, 3), np.uint8))
    np.savetxt(root / obj / "toy-2" / "intrin_ba" / "0.txt",
               np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]]))
    np.savetxt(root / obj / "toy-2" / "poses_ba" / "0.txt", np.eye(4))
    return str(root), str(sfm), obj


def _assert_same_object(got, want):
    (gt, gf), (wt, wf) = got, want
    assert len(gt) == len(wt) and len(gf) == len(wf)
    for g, w in zip(gt, wt):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    for g, w in zip(gf, wf):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_load_onepose_object_matches_gd3d(tmp_path):
    root, sfm, obj = _gd3d_driver_tree(tmp_path)
    want = jonepose.load_onepose_object(root, sfm, obj, every_nth=1)
    _assert_same_object(onepose.load_onepose_object(root, sfm, obj, every_nth=1), want)
    with make_pool(2) as pool:
        _assert_same_object(onepose.load_onepose_object(root, sfm, obj, every_nth=1, pool=pool),
                            want)
    assert len(want[0]) == 2 and len(want[1]) == 1


def test_evaluate_object_with_a_capped_bank_matches_gd3d(students, tree):
    jstudent, params, student = students
    lt, sfm = _dirs(tree[0])
    templates, frames = jonepose.load_onepose_object(lt, sfm, fixtures.ONEPOSE_BANK)
    kw = dict(template_cap=100)  # 120 rows: sampled by RandomState(0)
    want = jonepose.evaluate_object(jstudent, params, templates, frames, refine=True, **kw)
    stats = {}
    got = onepose.evaluate_object(student, templates, frames, refine=True, stats=stats, **kw)
    assert got == want
    assert stats["template_rows"] == 100 and stats["frames"] == len(frames) == 2


def test_oneposepp_matches_gd3d_and_the_known_answer(students, tree, tmp_path):
    jstudent, params, student = students
    lt, sfm = _dirs(tree[0])
    want = jonepose.oneposepp(jstudent, params, root=lt, sfm_dir=sfm)
    got = onepose.oneposepp(student, root=lt, sfm_dir=sfm)
    want.to_csv(tmp_path / "want.csv")
    got.to_csv(tmp_path / "got.csv")
    assert (tmp_path / "got.csv").read_bytes() == (tmp_path / "want.csv").read_bytes()
    assert got.index == [fixtures.ONEPOSE_KNOWN, fixtures.ONEPOSE_BANK]
    for th in (1, 3, 5):
        assert got.columns[f"threshold_{th}"][0] == 1.0


def test_evaluate_cli_pose_writes_gd3ds_csv(tmp_path, tree, monkeypatch):
    """--pose --tiny --device cpu on the fabricated tree: the CLI's tiny
    student carries gd3d weights (build_student patched), and its
    pose_estimation.csv is gd3d's oneposepp's to_csv byte for byte."""
    import dataclasses

    root, _ = tree
    cfg = evaluate.student_config("mast3r", tiny=True)
    jcfg = JStudentConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    jstudent = JStudent(jcfg)
    params = jstudent.init(jax.random.key(3), img_size=32)
    monkeypatch.setattr(evaluate, "build_student",
                        lambda args, device: _port_student(jcfg, params, cfg))
    res = evaluate.main(["--device", "cpu", "--tiny", "--pose", "--data-root", str(root),
                         "--out", str(tmp_path / "out")])
    lt, sfm = _dirs(root)
    jonepose.oneposepp(jstudent, params, root=lt, sfm_dir=sfm).to_csv(tmp_path / "want.csv")
    got = (res["out_dir"] / "pose_estimation.csv").read_bytes()
    assert got == (tmp_path / "want.csv").read_bytes()
    assert got.splitlines()[0] == b"objs,threshold_1,threshold_3,threshold_5"
    stats = res["stats"]["pose"]
    assert stats["frames"] == 4 and stats["templates"] == 4
    assert stats["ransac_iterations"] >= 2
