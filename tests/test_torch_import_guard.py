"""The port needs neither JAX nor gd3d, nor the packages the card's machine
lacks: in a fresh interpreter where `jax`, `gd3d`, PIL, cv2, pandas,
torchvision and timm (and their submodules) are absent (None in
sys.modules: importing them raises, and importlib.util.find_spec, which
torch probes them with, finds nothing), every
module of gd3d_torch imports, the training and evaluation CLIs included, and
the training CLI trains one tiny step on the CPU, on synthetic data and on
a fabricated Objaverse tree (the real-data readers: PNG decoding, the
augmentations, the dataset), and the evaluation CLI runs --pose --tiny on a
fabricated OnePose-LowTexture tree (PNG reads, cv2's resize, the EPnP
RANSAC), and the reconstruction CLIs run at --tiny on a fabricated
two-frame tree: align (--niter 2, dense, with the COLMAP exports), then
localize against its scene.npz, and align again on a WebP and a BMP view
(the committed formats fixtures); then the pretraining CLI prints its --help
and trains one tiny CPU step of each objective, on procedural pairs and
(mast3r) on a render tree written with the port's PNG encoder; then the
dataset-creation CLIs run with h5py absent too: the render CLI (one object,
two 64^2 views, procedural and from the fixture .glb) and the preprocessing
CLI on fabricated Co3D-v2, Waymo and MegaDepth raw trees (MegaDepth's
depth in HDF5). The CLI
modules import no torch at their top level, which their spawned decode
processes re-run, and neither do the data modules a worker imports."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys, tempfile

    BLOCKED = ("jax", "jaxlib", "gd3d", "flax", "optax", "orbax", "PIL", "cv2", "pandas",
               "torchvision", "timm", "h5py")
    for name in BLOCKED:
        sys.modules[name] = None
    import gd3d_torch
    names = [m.name for m in pkgutil.walk_packages(gd3d_torch.__path__, "gd3d_torch.")]
    for name in names:
        importlib.import_module(name)
    assert "gd3d_torch.cli.train" in names and "gd3d_torch.data.loader" in names
    assert "gd3d_torch.cli.evaluate" in names and "gd3d_torch.data.jpeg" in names
    for m in ("png", "exif", "images", "augment", "objaverse", "scannetpp", "pipeline",
              "fixtures", "bmp", "webp", "vp8", "vp8l", "exr", "hdf5"):
        assert f"gd3d_torch.data.{m}" in names, m
    for m in ("onepose", "pnp", "fit3d", "dust3r_tracker"):
        assert f"gd3d_torch.eval.{m}" in names, m
    for m in ("align", "tsdf", "crops", "visloc", "colmap_export", "colmap_db",
              "utils.html_viewer", "data.scene_graph", "cli.align", "cli.localize", "cli.demo",
              "cli.render", "cli.preprocess", "data.glb", "data.jpeg_encode", "data.undistort",
              "data.preprocess_habitat", "data.preprocess_scannetpp",
              "data.preprocess_arkitscenes", "data.preprocess_mvs", "data.preprocess_waymo"):
        assert f"gd3d_torch.{m}" in names, m
    from gd3d_torch.cli import train
    with tempfile.TemporaryDirectory() as out:
        train.main(["--tiny", "--synthetic", "--device", "cpu", "--epochs", "1",
                    "--steps-per-epoch", "1", "--output", out])
    from gd3d_torch.data import fixtures
    with tempfile.TemporaryDirectory() as root:
        fixtures.write_objaverse_tree(root)
        train.main(["--tiny", "--device", "cpu", "--epochs", "1", "--steps-per-epoch", "1",
                    "--data-root", root, "--output", root + "/out"])
    from gd3d_torch.cli import evaluate
    with tempfile.TemporaryDirectory() as root:
        fixtures.write_onepose_tree(root, size=(64, 80), known_kps=30, bank_frames=2,
                                    bank_kps=30, bank_tests=2)
        res = evaluate.main(["--tiny", "--pose", "--device", "cpu", "--data-root", root,
                             "--out", root + "/out"])
        assert (res["out_dir"] / "pose_estimation.csv").exists()
        assert res["tables"]["pose"].columns["threshold_1"][0] == 1.0
    import numpy as np
    import os
    from gd3d_torch.cli import align, localize
    from gd3d_torch.data.png import encode_png_rgb
    with tempfile.TemporaryDirectory() as root:
        big = fixtures.texture(np.random.RandomState(0), 96, 160)
        for k in range(2):
            with open(f"{root}/view_{k}.png", "wb") as f:
                f.write(encode_png_rgb(np.ascontiguousarray(big[:, 32 * k:32 * k + 128])))
        align.main(["--images", root, "--output", root + "/scene", "--tiny", "--device", "cpu",
                    "--size", "224", "--niter", "2", "--colmap", "--colmap-db", "--ply",
                    "--html"])
        res = localize.main(["--scene", root + "/scene/scene.npz", "--images",
                             root + "/view_1.png", "--output", root + "/loc", "--tiny",
                             "--device", "cpu", "--size", "224"])
        assert res["poses"].shape == (1, 4, 4)
    import shutil
    with tempfile.TemporaryDirectory() as root:
        views = os.path.join(os.path.dirname(fixtures.__file__), "testdata", "formats", "views")
        for name in ("view_1.webp", "view_2.bmp"):
            shutil.copy(os.path.join(views, name), root)
        align.main(["--images", root, "--output", root + "/scene", "--tiny", "--device", "cpu",
                    "--size", "224", "--niter", "2", "--sparse", "0"])
        assert np.load(root + "/scene/scene.npz")["images"].shape == (2, 224, 224, 3)
    import contextlib, io, runpy
    sys.argv = ["pretrain", "--help"]
    help_text = io.StringIO()
    with contextlib.redirect_stdout(help_text):
        try:
            runpy.run_module("gd3d_torch.cli.pretrain", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
    assert "--objective" in help_text.getvalue() and "--device" in help_text.getvalue()
    from gd3d_torch.cli import pretrain
    from gd3d_torch.data.png import encode_png
    from gd3d_torch.data.render_synthetic import (DEFAULT_INTRINSIC, fixed_poses,
                                                  procedural_object, render_mesh)
    with tempfile.TemporaryDirectory() as root:
        poses = fixed_poses(3)
        np.save(root + "/obj_poses.npy", poses)
        K = DEFAULT_INTRINSIC * (96 / 512.0)
        K[2, 2] = 1.0
        obj = procedural_object(np.random.RandomState(0))
        os.makedirs(root + "/obj")
        for i, E in enumerate(poses):
            rgb, depth, mask = render_mesh(*obj, E, K, 96)
            for kind, arr in (("color", rgb), ("depth", (depth * 1000).astype(np.uint16)),
                              ("mask", mask.astype(np.uint8) * 255)):
                with open(f"{root}/obj/{kind}_{i:06d}.png", "wb") as f:
                    f.write(encode_png(arr))
        for objective, data in (("croco", []), ("mast3r", []), ("mast3r", ["--data-root", root])):
            res = pretrain.main(["--output", root + "/out", "--objective", objective, "--tiny",
                                 "--device", "cpu", "--steps", "1", "--batch", "2",
                                 "--corres", "16", *data])
            assert np.isfinite(res["records"][0]["loss"])
    from gd3d_torch.cli import preprocess, render
    with tempfile.TemporaryDirectory() as root:
        fixtures.write_glb(root + "/glb/" + fixtures.GLB_NAME)
        for extra in ([], ["--glb-root", root + "/glb"]):
            poses = render.main(["--num-objects", "1", "--views", "2", "--size", "64",
                                 "--output", root + "/render", *extra])
            assert poses.shape == (2, 4, 4)
        assert os.path.exists(root + "/render/asset/mask_000001.png")
        assert os.path.exists(root + "/render/obj_00000/color_000001.png")
        for dataset in ("co3d", "waymo", "megadepth"):
            spec = fixtures.write_raw_tree(dataset, f"{root}/{dataset}_raw")
            preprocess.main(fixtures.preprocess_argv(dataset, spec, f"{root}/{dataset}_out"))
        assert os.path.exists(root + "/co3d_out/selected_seqs_train.json")
        assert os.path.exists(root + "/waymo_out/waymo_pairs.npz")
        assert os.path.exists(root + "/megadepth_out/0001/0/im_a.jpg.exr.npy")
    leaked = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("imported", len(names))
""")


def test_port_imports_without_jax_or_gd3d():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "imported" in res.stdout


def test_cli_modules_import_without_torch():
    """Nor do the modules a data worker imports (data/pipeline.py and the
    readers it calls)."""
    script = ("import sys, gd3d_torch.cli.evaluate, gd3d_torch.cli.train, "
              "gd3d_torch.cli.align, gd3d_torch.cli.localize, gd3d_torch.cli.demo, "
              "gd3d_torch.cli.pretrain, gd3d_torch.cli.render, gd3d_torch.cli.preprocess, "
              "gd3d_torch.data.preprocess_scannetpp, gd3d_torch.data.preprocess_waymo, "
              "gd3d_torch.data.preprocess_mvs, gd3d_torch.data.preprocess_arkitscenes, "
              "gd3d_torch.data.preprocess_habitat, gd3d_torch.data.glb, "
              "gd3d_torch.eval.images, gd3d_torch.eval.pnp, gd3d_torch.data.pipeline, "
              "gd3d_torch.data.objaverse, "
              "gd3d_torch.data.scannetpp, gd3d_torch.data.fixtures; "
              "print(sorted(m for m in sys.modules "
              "if m.split('.')[0] == 'torch' or m.startswith('gd3d_torch.models')))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "[]"
