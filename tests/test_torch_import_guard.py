"""The port needs neither JAX nor gd3d: in a fresh interpreter with `jax`
and `gd3d` (and their submodules) blocked on sys.meta_path, every module of
gd3d_torch imports, the training CLI included, and the CLI trains one tiny
step on the CPU."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys, tempfile

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "gd3d", "flax", "optax", "orbax"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import gd3d_torch
    names = [m.name for m in pkgutil.walk_packages(gd3d_torch.__path__, "gd3d_torch.")]
    for name in names:
        importlib.import_module(name)
    assert "gd3d_torch.cli.train" in names and "gd3d_torch.data.loader" in names
    from gd3d_torch.cli import train
    with tempfile.TemporaryDirectory() as out:
        train.main(["--tiny", "--synthetic", "--device", "cpu", "--epochs", "1",
                    "--steps-per-epoch", "1", "--output", out])
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "gd3d"))
    assert not leaked, leaked
    print("imported", len(names))
""")


def test_port_imports_without_jax_or_gd3d():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "imported" in res.stdout
