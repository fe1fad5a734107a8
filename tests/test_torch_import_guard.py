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
localize against its scene.npz. The CLI modules import no torch at their
top level, which their spawned decode processes re-run, and neither do the
data modules a worker imports."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys, tempfile

    BLOCKED = ("jax", "jaxlib", "gd3d", "flax", "optax", "orbax", "PIL", "cv2", "pandas",
               "torchvision", "timm")
    for name in BLOCKED:
        sys.modules[name] = None
    import gd3d_torch
    names = [m.name for m in pkgutil.walk_packages(gd3d_torch.__path__, "gd3d_torch.")]
    for name in names:
        importlib.import_module(name)
    assert "gd3d_torch.cli.train" in names and "gd3d_torch.data.loader" in names
    assert "gd3d_torch.cli.evaluate" in names and "gd3d_torch.data.jpeg" in names
    for m in ("png", "exif", "images", "augment", "objaverse", "scannetpp", "pipeline",
              "fixtures"):
        assert f"gd3d_torch.data.{m}" in names, m
    for m in ("onepose", "pnp", "fit3d", "dust3r_tracker"):
        assert f"gd3d_torch.eval.{m}" in names, m
    for m in ("align", "tsdf", "crops", "visloc", "colmap_export", "colmap_db",
              "utils.html_viewer", "data.scene_graph", "cli.align", "cli.localize", "cli.demo"):
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
