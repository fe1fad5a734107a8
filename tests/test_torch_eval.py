"""The port's evaluation against gd3d's on the CPU, with one seeded gd3d init
of gd3d's eval config SMALL (embed 32, depth 2) carried into the port by
gd3d_torch/convert.py::student_state_dict, and the same numpy-seeded inputs:

- the student's eval surfaces (dense_grid_features at strides 16 and 8,
  get_intermediate_feature) to 1e-5, and interpolate_features with
  normalize and stride;
- the tracker's functions: coordinates within 1e-4 px, occlusion flags
  equal; the TAP-Vid metrics equal;
- PCK matching's predicted pixels equal; semantic_transfer on a fabricated
  PF-PASCAL tree (JPEGs written by Pillow): the same CSV;
- tracking_single on a fabricated DAVIS tree at a small size: metrics
  within 1e-6; both drivers' tables the same with their JPEGs decoded in a
  pool of spawned processes;
- gd3d_torch.cli.evaluate --device cpu --tiny writes gd3d's CSV headers,
  --pose among them; the train CLI's eval epoch runs with eval data present.

Tolerances: fp32 sums in another order (the features' 1e-5; coordinates are
weighted means of pixel positions < 128, 1e-4 px); the PCK and the
occlusion flags are discrete and held exactly.
"""
import csv
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from gd3d.core.config import StudentConfig as JStudentConfig
from gd3d.eval import pck as jpck
from gd3d.eval import tracker as jtracker
from gd3d.eval import tracking as jtracking
from gd3d.eval import tracking_metrics as jmetrics
from gd3d.models.student import Student as JStudent
from gd3d.ops.interpolate import interpolate_features as jinterpolate
from gd3d_torch.cli import evaluate, train
from gd3d_torch.convert import student_state_dict
from gd3d_torch.core.config import StudentConfig
from gd3d_torch.eval import pck, tracker, tracking, tracking_metrics
from gd3d_torch.eval.images import make_pool
from gd3d_torch.models.student import Student
from gd3d_torch.ops.interpolate import interpolate_features

SMALL = dict(embed_dim=32, depth=2, num_heads=2, patch_size=16, pretrain_img_size=32,
             lora_start_block=99, use_adapters=False, target_res=64, depth_head_hidden=16)
PCK_HEADER = ["categories", "PCK0.05", "PCK0.10", "PCK0.15", "Weighted PCK0.05",
              "Weighted PCK0.10", "Weighted PCK0.15"]


@pytest.fixture(scope="module")
def students():
    jcfg = JStudentConfig(**SMALL)
    jstudent = JStudent(jcfg)
    params = jstudent.init(jax.random.key(0), img_size=32)
    student = Student(StudentConfig(**SMALL))
    student.load_state_dict(student_state_dict(jax.device_get(params), jcfg))
    student.requires_grad_(False).eval()
    return jstudent, params, student


def _t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("stride,refine", [(16, True), (8, True), (8, False)])
def test_dense_grid_features_matches_gd3d(students, stride, refine):
    jstudent, params, student = students
    imgs = np.random.RandomState(stride).rand(2, 64, 96, 3).astype(np.float32)
    want = jstudent.dense_grid_features(params, jnp.asarray(imgs), stride=stride,
                                        refine=refine)
    with torch.no_grad():
        got = student.dense_grid_features(_t(imgs), stride=stride, refine=refine)
    assert got.shape == want.shape == (2, 1 + (64 - 16) // stride, 1 + (96 - 16) // stride, 32)
    close(got, want, 1e-5)


@pytest.mark.parametrize("class_token", [False, True])
def test_get_intermediate_feature_matches_gd3d(students, class_token):
    jstudent, params, student = students
    rng = np.random.RandomState(4)
    rgbs = rng.rand(2, 48, 80, 3).astype(np.float32)
    pts = (rng.rand(2, 7, 2) * [80, 48]).astype(np.float32)
    want = jstudent.get_intermediate_feature(params, jnp.asarray(rgbs), jnp.asarray(pts),
                                             n=(0, 1), return_class_token=class_token)
    with torch.no_grad():
        got = student.get_intermediate_feature(_t(rgbs), _t(pts), n=(0, 1),
                                               return_class_token=class_token)
    for g, w in zip(got, want) if class_token else [(got, want)]:
        close(g, w, 1e-5)


@pytest.mark.parametrize("normalize,patch,stride", [(True, 14, 14), (False, 16, 8),
                                                    (True, 16, 8)])
def test_interpolate_features_matches_gd3d(normalize, patch, stride):
    rng = np.random.RandomState(patch + stride)
    desc = rng.randn(2, 6, 7, 11).astype(np.float32)
    pts = rng.uniform(-10, 110, size=(2, 9, 2)).astype(np.float32)
    kw = dict(normalize=normalize, patch_size=patch, stride=stride)
    close(interpolate_features(_t(desc), _t(pts), 64, 96, **kw),
          jinterpolate(jnp.asarray(desc), jnp.asarray(pts), 64, 96, **kw), 1e-5)


def _track_inputs(seed, T=5, N=6):
    """Features of a moving textured scene: a base field shifted by one
    column a frame plus noise, and one frame of pure noise (occlusion), so
    both cosine gates are crossed; queries at patch centres and off them."""
    rng = np.random.RandomState(seed)
    base = rng.randn(7, 14, 8).astype(np.float32)
    feats = np.stack([base[:, t % 3: t % 3 + 11] + 0.3 * rng.randn(7, 11, 8) for t in range(T)])
    feats[3] = rng.randn(7, 11, 8)
    feats = feats.astype(np.float32)
    q = np.stack([rng.uniform(0, 96, N), rng.uniform(0, 64, N), rng.randint(0, T, N)], 1)
    q[0] = [8.0, 8.0, 0]
    return feats, q.astype(np.float32)


@pytest.mark.parametrize("radius", [35, 10])
def test_tracker_matches_gd3d(radius):
    cfg_kw = dict(patch_size=16, stride=8, argmax_radius=radius, video_h=64, video_w=96)
    jcfg, cfg = jtracker.TrackerConfig(**cfg_kw), tracker.TrackerConfig(**cfg_kw)
    feats, q = _track_inputs(radius)
    jf, jq, tf, tq = jnp.asarray(feats), jnp.asarray(q), _t(feats), _t(q)
    want_traj = jtracker.generate_trajectories(jf, jq, jcfg)
    got_traj = tracker.generate_trajectories(tf, tq, cfg)
    close(got_traj, want_traj, 1e-4)
    # the later stages on gd3d's trajectories, so each stage is held alone
    traj = np.asarray(want_traj)
    want_cos, _ = jtracker.trajectory_cos_sims(jf, jnp.asarray(traj), jq, jcfg)
    got_cos, _ = tracker.trajectory_cos_sims(tf, _t(traj), tq, cfg)
    close(got_cos, want_cos, 1e-5)
    want_anchor = jtracker.anchor_trajectories(jf, jnp.asarray(traj), jcfg)
    close(tracker.anchor_trajectories(tf, _t(traj), cfg), want_anchor, 1e-4)
    cos = np.asarray(want_cos)
    vis = cos >= jcfg.anchor_cos_threshold
    assert vis.any() and not vis.all() and (cos < jcfg.cos_threshold).any()
    want_occ = jtracker.compute_occlusion(traj, cos, np.asarray(want_anchor), jcfg)
    got_occ = tracker.compute_occlusion(_t(traj), _t(cos), _t(np.asarray(want_anchor)), cfg)
    np.testing.assert_array_equal(got_occ.numpy(), want_occ)
    # and the whole inference end to end
    want_t, want_o = jtracker.infer_tracks(feats, q, jcfg)
    got_t, got_o = tracker.infer_tracks(tf, tq, cfg)
    close(got_t, want_t, 1e-4)
    np.testing.assert_array_equal(got_o.numpy(), want_o)


def test_compute_occlusion_without_visible_anchors_matches_gd3d():
    """A query with no anchor above the threshold, and one anchor only."""
    rng = np.random.RandomState(9)
    traj = rng.rand(3, 4, 2).astype(np.float32) * 50
    anchors = rng.rand(3, 4, 4, 2).astype(np.float32) * 50
    cos = np.array([[0.1, 0.65, 0.2, 0.5], [0.9, 0.1, 0.2, 0.61], [0.8, 0.75, 0.9, 0.3]],
                   np.float32)
    cfg = dict(video_h=64, video_w=96)
    want = jtracker.compute_occlusion(traj, cos, anchors, jtracker.TrackerConfig(**cfg))
    got = tracker.compute_occlusion(_t(traj), _t(cos), _t(anchors), tracker.TrackerConfig(**cfg))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["strided", "first"])
def test_tapvid_metrics_match_gd3d(mode):
    rng = np.random.RandomState(1)
    N, T = 7, 6
    q = np.stack([rng.randint(0, T, N), rng.rand(N) * 64, rng.rand(N) * 96], 1)[None]
    gt = rng.rand(1, N, T, 2) * 90
    pred = gt + rng.randn(1, N, T, 2) * 6
    gto, po = rng.rand(1, N, T) > 0.7, rng.rand(1, N, T) > 0.6
    for trackwise in (False, True):
        want = jmetrics.compute_tapvid_metrics(q, gto, gt, po, pred, mode, trackwise)
        got = tracking_metrics.compute_tapvid_metrics(q, gto, gt, po, pred, mode, trackwise)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    video = {"video_idx": 3, "h": 100, "w": 200,
             "query_points": {0: rng.rand(N, 2).tolist(), 2: rng.rand(2, 2).tolist()},
             "target_points": {0: gt[0], 2: gt[0, :2]},
             "occluded": {0: gto[0], 2: gto[0, :2]}}
    trajs, occs = {0: pred[0] * 0.5, 2: pred[0, :2] * 0.5}, {0: po[0], 2: po[0, :2]}
    assert (tracking_metrics.compute_tapvid_metrics_for_video(
        trajs, occs, {"videos": [video]}, 3, pred_video_sizes=[96, 48])
        == jmetrics.compute_tapvid_metrics_for_video(
            trajs, occs, {"videos": [video]}, 3, pred_video_sizes=[96, 48]))


def test_match_fn_predictions_match_gd3d(students):
    """Three pairs through batches of two (the tail padded), a pair with
    fewer keypoints than the others, on the 64^2 canvas."""
    jstudent, params, student = students
    rng = np.random.RandomState(5)
    pairs = []
    for n in (5, 5, 3):
        kps = np.concatenate([rng.uniform(0, 64, (n, 2)), np.ones((n, 1))], 1).astype(np.float32)
        pairs.append((rng.randint(0, 256, (64, 64, 3), np.uint8),
                      rng.randint(0, 256, (64, 64, 3), np.uint8), kps))
    want = jpck.make_match_fn(jstudent, 64, max_kps=20, batch_pairs=2).many(params, pairs)
    got = pck.make_match_fn(student, 64, max_kps=20, batch_pairs=2)(pairs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _pascal_tree(root, rng):
    """A PF-PASCAL tree: 4 Pillow JPEGs (landscape, portrait, grayscale) and
    the pair CSVs in the vendored format, 2 categories."""
    pdir = root / "PF-dataset-PASCAL"
    (pdir / "JPEGImages").mkdir(parents=True)
    names = []
    for i, (h, w) in enumerate([(80, 100), (90, 70), (60, 100), (100, 100)]):
        name = f"PF-dataset-PASCAL/JPEGImages/im{i}.jpg"
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        Image.fromarray(img[..., 0] if i == 2 else img).save(root / name, quality=90)
        names.append(name)

    def coords(n):
        return (";".join(f"{v:.4f}" for v in rng.uniform(2, 68, n)),
                ";".join(f"{v:.4f}" for v in rng.uniform(2, 58, n)))

    rows = [[names[0], names[1], 8, *coords(4), *coords(4)],
            [names[2], names[3], 8, *coords(3), *coords(3)],
            [names[1], names[2], 12, *coords(5), *coords(5)]]
    for view in ("same", "different"):
        with open(pdir / f"test_pairs_pf_{view}_views.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["source_image", "target_image", "class", "XA", "YA", "XB", "YB"])
            w.writerows(rows)
    return pdir


def test_semantic_transfer_matches_gd3d(students, tmp_path):
    jstudent, params, student = students
    pdir = _pascal_tree(tmp_path, np.random.RandomState(2))
    cats = ["cat", "dog"]
    want = jpck.semantic_transfer(jstudent, params, str(pdir), categories=cats, img_size=64)
    got = pck.semantic_transfer(student, str(pdir), categories=cats, img_size=64)
    want.to_csv(tmp_path / "want.csv")
    got.to_csv(tmp_path / "got.csv")
    assert (tmp_path / "got.csv").read_text() == (tmp_path / "want.csv").read_text()
    assert got.header() == PCK_HEADER


def _davis_tree(root, rng, T=3, H=96, W=128, videos=1):
    """A DAVIS tree of `videos` videos of T Pillow JPEG frames, and a
    strided benchmark pkl with queries in frames 0 and 2."""
    N = 2
    bench = {"videos": []}
    for v in range(videos):
        vdir = root / "davis_480" / str(v) / "video"
        vdir.mkdir(parents=True)
        for t in range(T):
            Image.fromarray(rng.randint(0, 256, (H, W, 3), np.uint8)).save(vdir / f"{t:05d}.jpg")
        bench["videos"].append({
            "video_idx": v, "h": H, "w": W,
            "query_points": {0: [[30.0, 40.0], [60.0, 50.0]], 2: [[90.0, 20.0]]},
            "target_points": {0: rng.uniform(0, 96, (N, T, 2)),
                              2: rng.uniform(0, 96, (1, T, 2))},
            "occluded": {0: rng.rand(N, T) > 0.7, 2: np.zeros((1, T), bool)},
        })
    with open(root / "tapvid_davis_data_strided.pkl", "wb") as f:
        pickle.dump(bench, f)
    return bench


def test_tracking_single_matches_gd3d(students, tmp_path):
    jstudent, params, student = students
    bench = _davis_tree(tmp_path, np.random.RandomState(3))
    video_root = str(tmp_path / "davis_480")
    want = jtracking.tracking_single(jstudent, params, 0, bench, video_root, size_hw=(64, 96))
    stats = {}
    got = tracking.tracking_single(student, 0, bench, video_root, size_hw=(64, 96), stats=stats)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert stats["frames"] == 3 and stats["queries"] == 3
    assert 0 < stats["decode_s"] + stats["features_s"] + stats["tracker_s"] <= stats["wall_s"]
    (video,) = stats.pop("videos")
    assert video == dict(stats, video_idx=0)
    # the table: gd3d's DataFrame(rows).set_index("video_idx") as CSV
    table = tracking.tracking(student, num_videos=1,
                              benchmark_pkl=str(tmp_path / "tapvid_davis_data_strided.pkl"),
                              video_root=video_root, size_hw=(64, 96))
    table.to_csv(tmp_path / "got.csv")
    pd.DataFrame([want]).set_index(["video_idx"]).to_csv(tmp_path / "want.csv")
    got_rows = list(csv.reader(open(tmp_path / "got.csv")))
    want_rows = list(csv.reader(open(tmp_path / "want.csv")))
    assert got_rows[0] == want_rows[0]
    close([float(v) for v in got_rows[1]], [float(v) for v in want_rows[1]], 1e-6)


def test_decode_pool_gives_the_same_tables(students, tmp_path):
    """Both drivers with their JPEGs decoded in two spawned processes, as the
    CLIs decode at full size, against the same drivers decoding in this
    process."""
    _, _, student = students
    rng = np.random.RandomState(9)
    pdir = _pascal_tree(tmp_path, rng)
    _davis_tree(tmp_path, rng)
    kw = dict(benchmark_pkl=str(tmp_path / "tapvid_davis_data_strided.pkl"),
              video_root=str(tmp_path / "davis_480"), num_videos=1, size_hw=(64, 96))
    want = [pck.semantic_transfer(student, str(pdir), categories=["cat", "dog"], img_size=64),
            tracking.tracking(student, **kw)]
    with make_pool(2) as pool:
        got = [pck.semantic_transfer(student, str(pdir), categories=["cat", "dog"],
                                     img_size=64, pool=pool),
               tracking.tracking(student, pool=pool, **kw)]
    for i, (g, w) in enumerate(zip(got, want)):
        g.to_csv(tmp_path / f"got{i}.csv")
        w.to_csv(tmp_path / f"want{i}.csv")
        assert (tmp_path / f"got{i}.csv").read_text() == (tmp_path / f"want{i}.csv").read_text()


def test_evaluate_cli_writes_gd3ds_csvs(tmp_path):
    rng = np.random.RandomState(6)
    _pascal_tree(tmp_path, rng)
    _davis_tree(tmp_path, rng)
    res = evaluate.main(["--device", "cpu", "--tiny", "--transfer", "--tracking",
                         "--num-videos", "1", "--data-root", str(tmp_path), "--out",
                         str(tmp_path / "out"), "--matcher", "me"])
    out = res["out_dir"]
    assert out.parent.parent.parent.parent == tmp_path / "out" / "timm"
    assert out.parts[-4:-1] == ("me", "ViT-B-16", "scannetpp")
    rows = list(csv.reader(open(out / "semantic_transfer.csv")))
    assert rows[0] == PCK_HEADER and [r[0] for r in rows[1:]] == ["cat", "dog"]
    rows = list(csv.reader(open(out / "tracking.csv")))
    want_header = ["video_idx", "occlusion_accuracy"] + [
        f"{m}_{t}" for t in (1, 2, 4, 8, 16) for m in ("pts_within", "jaccard")] + [
        "average_jaccard", "average_pts_within_thresh"]
    assert rows[0] == want_header and rows[1][0] == "0"
    assert all(np.isfinite(float(v)) for v in rows[1][1:])
    assert res["stats"]["tracking"]["frames"] == 3
    assert res["stats"]["semantic_transfer"]["pairs"] == 3


def test_evaluate_cli_runs_pose_with_the_other_evals(tmp_path):
    """--pose beside --transfer and --tracking: all three CSVs, gd3d's pose
    header, the known-answer object at 1.0 (gd3d's bytes are
    tests/test_torch_onepose.py's)."""
    from gd3d_torch.data.fixtures import ONEPOSE_KNOWN, write_onepose_tree

    rng = np.random.RandomState(7)
    _pascal_tree(tmp_path, rng)
    _davis_tree(tmp_path, rng)
    write_onepose_tree(tmp_path, size=(64, 80), known_kps=30, bank_frames=2, bank_kps=30,
                       bank_tests=2)
    res = evaluate.main(["--device", "cpu", "--tiny", "--pose", "--transfer", "--tracking",
                         "--num-videos", "1", "--data-root", str(tmp_path), "--out",
                         str(tmp_path / "out")])
    out = res["out_dir"]
    for name in ("pose_estimation.csv", "semantic_transfer.csv", "tracking.csv"):
        assert (out / name).exists()
    rows = list(csv.reader(open(out / "pose_estimation.csv")))
    assert rows[0] == ["objs", "threshold_1", "threshold_3", "threshold_5"]
    assert rows[1] == [ONEPOSE_KNOWN, "1.0", "1.0", "1.0"]
    assert list(res["tables"]) == ["pose", "tracking", "semantic_transfer"]
    assert res["stats"]["pose"]["frames"] == 4


def test_train_cli_eval_epoch_runs_with_eval_data(tmp_path):
    rng = np.random.RandomState(8)
    _pascal_tree(tmp_path, rng)
    _davis_tree(tmp_path, rng, videos=30)  # the callback's num_videos
    out = tmp_path / "run"
    train.main(["--tiny", "--synthetic", "--device", "cpu", "--output", str(out), "--epochs",
                "1", "--steps-per-epoch", "1", "--eval-every", "1", "--data-root",
                str(tmp_path)])
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    summary = [r for r in records if any(k.startswith("eval/") for k in r)]
    assert len(summary) == 1
    keys = set(summary[0])
    for tag in ("same", "diff"):
        assert {f"eval/pck_{tag}/{c}" for c in PCK_HEADER[1:]} <= keys
    assert "eval/tracking/average_jaccard" in keys
    assert all(np.isfinite(v) for v in summary[0].values())
    for name in ("semantic_transfer_same.csv", "semantic_transfer_diff.csv", "tracking.csv"):
        assert (out / "epoch_1" / name).exists()
