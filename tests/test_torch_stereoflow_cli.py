"""The port's stereo / flow CLI (gd3d_torch/cli/stereoflow.py) and the align
CLI's --sparse-ga path against gd3d's CLIs on the CPU, at --tiny.

The stereo and flow runs read a generic-layout tree written here (PNG
pairs of 70x100, PFM disparities with +inf holes, .flo flows) and start
from one weights file: the port's seeded init written as gd3d's flattened
param tree (what `train` writes), which both CLIs load with --ckpt. Each
package's params_final.npz is then evaluated by the other's CLI.

Tolerances: the training losses 1e-5 relative and the trained weights 1e-4
of each tensor's largest value (two AdamW steps, as
tests/test_torch_stereoflow.py); predictions, metrics and the .pfm / .flo
files 1e-4 of the largest value (the tiny model on shared weights); the
16-bit KITTI PNGs decode within one level of gd3d's (a prediction 1e-6 off
can round the other way); each visualisation decodes to exactly what
gd3d's vis_disparity / flow_to_color and cv2.imwrite make of the port's
own prediction (the colour bins of two predictions 1e-6 apart can differ).

--sparse-ga runs both align CLIs on tests/test_torch_align_cli.py's views
and tiny teacher (5 + 5 steps) from one SparseScene: scene.npz's keys,
shapes and images equal; focals, principal points and depth maps 1e-2 of
their largest value, poses and points 1e-2 after both are put in the MST
root camera's frame (the global rigid motion is free and Adam moves it on
fp32 noise: see tests/test_torch_sparse_ga.py); see ALIGN_TOL.
"""
import json

import cv2
import numpy as np
import pytest
import torch

from gd3d.cli.stereoflow import main as jmain
from gd3d_torch.cli import align
from gd3d_torch.cli import stereoflow as S
from gd3d_torch.data.flowio import read_flo, read_gt, read_kitti_disp, write_flo, write_pfm
from gd3d_torch.data.png import encode_png_rgb
from gd3d_torch.models.stereoflow import StereoFlow
from gd3d_torch.models.vit import init_params_
from tests.test_torch_align_cli import gd3d_cli, inputs  # noqa: F401 (fixtures)

TOL = 1e-4
# a random tiny teacher's sparse scene is degenerate (points behind the
# camera, clamped focals), and 5 fine steps of Adam at lr 0.02 turn its
# fp32 differences into measured 2.4e-3 (poses), 5.1e-3 (points) and 1e-3
# (principal points) of the largest value
ALIGN_TOL = 1e-2


def write_tree(root, task, n=2, hw=(70, 100), seed=3):
    rng = np.random.RandomState(seed)
    for d in ("left", "right", "gt"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        for side in ("left", "right"):
            (root / side / f"p{i}.png").write_bytes(
                encode_png_rgb(rng.randint(0, 256, (*hw, 3), dtype=np.uint8)))
        if task == "stereo":
            gt = (rng.rand(*hw) * 20 + 1).astype(np.float32)
            gt[::7, ::5] = np.inf
            write_pfm(str(root / "gt" / f"p{i}.pfm"), gt)
        else:
            write_flo(str(root / "gt" / f"p{i}.flo"), (rng.randn(*hw, 2) * 5).astype(np.float32))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Both tasks' trees and one starting weights file a task."""
    root = tmp_path_factory.mktemp("stereoflow_cli")
    out = {}
    for task in ("stereo", "flow"):
        write_tree(root / task, task)
        args = S.parse_args(["eval", "--task", task, "--tiny", "--root", "x", "--output", "y"])
        model = StereoFlow(S.model_config(args))
        init_params_(model, torch.Generator().manual_seed(11))
        S.save_params(root / f"init_{task}.npz", model)
        out[task] = (root / task, root / f"init_{task}.npz")
    return root, out


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= tol, err


def npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def gd3d_visu(pred, task, gt=None):
    """What gd3d's _write_visu writes for `pred`, as cv2.imread reads it."""
    from gd3d.data.flowio import flow_to_color, vis_disparity

    if task == "stereo":
        m = M = None
        if gt is not None and np.isfinite(gt).any():
            m, M = float(gt[np.isfinite(gt)].min()), float(gt[np.isfinite(gt)].max())
        return vis_disparity(pred[..., 0], m=m, M=M)
    ref = gt if gt is not None else pred
    fin = ref[np.isfinite(ref[..., 0])]
    norm = float(np.sqrt((fin ** 2).sum(-1)).max()) if fin.size else None
    return flow_to_color(pred.astype(np.float32), maxflow=norm)[..., ::-1]


def test_train_then_eval_across_packages(trees):
    """train: the same losses and weights as gd3d's CLI; eval: each
    package's params_final.npz read by the other package's CLI."""
    root, t = trees
    tree, init = t["stereo"]
    base = ["train", "--task", "stereo", "--tiny", "--root", str(tree), "--steps", "2",
            "--batch", "1", "--warmup", "1", "--ckpt", str(init)]
    jmain(base + ["--output", str(root / "g_run")])
    res = S.main(base + ["--output", str(root / "p_run"), "--device", "cpu"])
    want = [json.loads(x) for x in (root / "g_run" / "train_log.jsonl").read_text().splitlines()]
    got = [json.loads(x) for x in (root / "p_run" / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"])
    assert len(res["records"]) == 2 and len(res["stats"]["step_s"]) == 2
    gp, wp = npz(root / "p_run" / "params_final.npz"), npz(root / "g_run" / "params_final.npz")
    assert sorted(gp) == sorted(wp)
    for k in wp:
        assert gp[k].dtype == wp[k].dtype
        close(gp[k], wp[k])

    ev = ["eval", "--task", "stereo", "--tiny", "--root", str(tree), "--tile-overlap", "0.3",
          "--save", "metrics", "pred", "visu"]
    # gd3d's CLI on the port's weights, the port's CLI on gd3d's
    jmain(ev + ["--ckpt", str(root / "p_run" / "params_final.npz"), "--output",
                str(root / "g_eval")])
    out = S.main(ev + ["--ckpt", str(root / "g_run" / "params_final.npz"), "--output",
                       str(root / "p_eval"), "--device", "cpu"])
    wm = json.loads((root / "g_eval" / "metrics.json").read_text())
    gm = json.loads((root / "p_eval" / "metrics.json").read_text())
    assert sorted(gm) == sorted(wm) and out["pairs"] == 2
    close([gm[k] for k in sorted(wm)], [wm[k] for k in sorted(wm)])
    for name in ("left_p0", "left_p1"):
        close(np.load(root / "p_eval" / f"{name}_pred.npy"),
              np.load(root / "g_eval" / f"{name}_pred.npy"))
        gt = read_gt(str(tree / "gt" / f"{name[5:]}.pfm"), "stereo")
        np.testing.assert_array_equal(cv2.imread(str(root / "p_eval" / f"{name}_pred.png")),
                                      gd3d_visu(np.load(root / "p_eval" / f"{name}_pred.npy"),
                                                "stereo", gt))


@pytest.mark.parametrize("task,ext", [("stereo", ".pfm"), ("stereo", ".png"), ("flow", ".flo"),
                                      ("flow", ".npy")])
def test_predict_matches_gd3d(trees, task, ext):
    root, t = trees
    tree, init = t[task]
    base = ["predict", "--task", task, "--tiny", "--ckpt", str(init), "--left",
            str(tree / "left" / "p0.png"), "--right", str(tree / "right" / "p0.png"),
            "--tile-overlap", "0.3"]
    g_out, p_out = root / f"g_pred_{task}{ext}", root / f"p_pred_{task}{ext}"
    jmain(base + ["--output", str(g_out), "--visu", str(root / f"g_visu_{task}{ext}.png")])
    res = S.main(base + ["--output", str(p_out), "--visu", str(root / f"p_visu_{task}{ext}.png"),
                         "--device", "cpu", "--tile-batch", "2"])
    assert res["pred"].shape == (70, 100, 1 if task == "stereo" else 2)
    if ext == ".png":
        g, w = read_kitti_disp(str(p_out)), read_kitti_disp(str(g_out))
        assert g.shape == w.shape and np.abs(g - w).max() <= 1 / 256
    elif ext == ".pfm":
        from gd3d.data.flowio import read_pfm
        close(read_pfm(str(p_out))[0], read_pfm(str(g_out))[0])
    elif ext == ".flo":
        close(read_flo(str(p_out)), read_flo(str(g_out)))
    else:
        close(np.load(p_out), np.load(g_out))
    np.testing.assert_array_equal(cv2.imread(str(root / f"p_visu_{task}{ext}.png")),
                                  gd3d_visu(res["pred"], task))


def test_flow_train_and_eval(trees):
    """The flow task end to end on the port alone (the stereo test holds
    the shared code to gd3d): two steps, then eval on the result."""
    root, t = trees
    tree, init = t["flow"]
    res = S.main(["train", "--task", "flow", "--tiny", "--root", str(tree), "--steps", "2",
                  "--batch", "2", "--warmup", "1", "--output", str(root / "p_flow"),
                  "--device", "cpu"])
    losses = [r["loss"] for r in res["records"]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    out = S.main(["eval", "--task", "flow", "--tiny", "--root", str(tree), "--ckpt",
                  str(root / "p_flow" / "params_final.npz"), "--output",
                  str(root / "p_flow_eval"), "--device", "cpu"])
    assert {"L1err", "EPE", "bad@1.0", "s0-10"} <= set(out["metrics"])
    assert np.isfinite(out["metrics"]["EPE"])


def test_stereoflow_cli_refusals(trees, tmp_path):
    root, t = trees
    with pytest.raises(SystemExit):
        S.main(["train", "--task", "stereo", "--tiny", "--no-conf", "--criterion",
                "LaplacianLossBounded2()", "--root", "/nonexistent", "--output",
                str(tmp_path), "--device", "cpu"])
    tree, init = t["stereo"]
    with pytest.raises(SystemExit, match="format"):
        S.main(["predict", "--tiny", "--left", str(tree / "left" / "p0.png"), "--right",
                str(tree / "right" / "p0.png"), "--output", str(tmp_path / "x.tif"),
                "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            S.main(["eval", "--tiny", "--root", str(tree), "--output", str(tmp_path)])


def in_frame(poses, pts, k):
    """Poses and points in camera k's frame."""
    g = np.linalg.inv(poses[k].astype(np.float64))
    return np.einsum("ab,nbc->nac", g, poses), pts @ g[:3, :3].T + g[:3, 3]


def test_align_sparse_ga_matches_gd3d(inputs, gd3d_cli, monkeypatch):  # noqa: F811
    """Both CLIs on one SparseScene: gd3d's CLI is handed the scene the
    port's built (tests/test_torch_sparse_ga.py holds the port's
    build_scene_from_mast3r to gd3d's), since the densified depth of a
    random teacher's nearly coincident points is ill-conditioned."""
    import gd3d.sparse_ga as jsga
    import gd3d_torch.sparse_ga as tsga

    root, views, ckpt = inputs
    scenes = []
    build = tsga.build_scene_from_mast3r
    monkeypatch.setattr(tsga, "build_scene_from_mast3r",
                        lambda *a, **k: scenes.append(build(*a, **k)) or scenes[-1])
    argv = ["--images", *views, "--tiny", "--size", "224", "--teacher-ckpt", ckpt,
            "--sparse-ga", "--ga-niter1", "5", "--ga-niter2", "5", "--ga-subsample", "16",
            "--ply", "--html", "--tsdf", "0.3"]
    res = align.main(argv + ["--output", str(root / "port_sga"), "--device", "cpu"])
    monkeypatch.setattr(jsga, "build_scene_from_mast3r", lambda *a, **k: scenes[0])
    gd3d_cli(argv + ["--output", str(root / "gd3d_sga")])
    want, got = npz(root / "gd3d_sga" / "scene.npz"), npz(root / "port_sga" / "scene.npz")
    assert sorted(got) == sorted(want) == ["depthmaps", "focals", "images", "poses",
                                          "principal_points", "pts3d"]
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got["images"], want["images"])
    for k in ("focals", "principal_points", "depthmaps"):
        close(got[k], want[k], ALIGN_TOL)
    root_cam = scenes[0].mst_root
    for g, w in zip(in_frame(got["poses"], got["pts3d"], root_cam),
                    in_frame(want["poses"], want["pts3d"], root_cam)):
        close(g, w, ALIGN_TOL)
    st = res["stats"]
    assert st["pairs"] == 3 and st["correspondences"] > 0
    assert {"teacher_s", "coarse_s", "fine_s", "coarse_ms_per_iter", "export_s"} <= set(st)
    head = (root / "port_sga" / "pointcloud.ply").read_text().splitlines()[:3]
    assert head == (root / "gd3d_sga" / "pointcloud.ply").read_text().splitlines()[:3]
    assert b"<html" in (root / "port_sga" / "scene.html").read_bytes()[:200].lower()
