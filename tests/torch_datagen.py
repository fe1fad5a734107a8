"""Shared helpers of the dataset-creation tests (tests/test_torch_render.py,
tests/test_torch_preprocess_*.py): run gd3d's CLI and the port's on the
same fabricated input, compare the trees, compare the views that each
package's reader gives on its own tree.

    PYTHONPATH=. python tests/torch_datagen.py

rewrites gd3d_torch/data/testdata/datagen_digests.json from gd3d's CLIs
(the decoded-content digests of every tree that chip_smoke.py's datagen
phase makes: fixtures.RENDER_RUNS and each dataset of fixtures.RAW_DATASETS
plus habitat)."""
import contextlib
import io
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gd3d_torch.data import fixtures  # noqa: E402


def quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def preprocess_both(dataset: str, tmp: Path):
    """(gd3d's tree, the port's tree) of one dataset's fabricated input."""
    from gd3d.cli.preprocess import main as gd3d_main
    from gd3d_torch.cli.preprocess import main as port_main

    spec = None if dataset == "habitat" else fixtures.write_raw_tree(dataset, tmp / "raw")
    quiet(gd3d_main, fixtures.preprocess_argv(dataset, spec, tmp / "gd3d"))
    quiet(port_main, fixtures.preprocess_argv(dataset, spec, tmp / "port"))
    return tmp / "gd3d", tmp / "port"


def assert_trees_equal(gd3d_tree: Path, port_tree: Path) -> dict:
    """The same files; PNG, JSON, .npz and .npy contents equal; JPEGs
    byte-equal (so PIL decodes them to the same pixels). Returns the
    digests."""
    files = fixtures.tree_files(gd3d_tree)
    assert fixtures.tree_files(port_tree) == files
    got = fixtures.tree_digests(port_tree)
    for rel in files:
        if rel.lower().endswith((".jpg", ".jpeg")):  # equal bytes: decode one side
            assert (port_tree / rel).read_bytes() == (gd3d_tree / rel).read_bytes(), rel
        else:
            assert got[rel] == fixtures.file_digest(gd3d_tree / rel), rel
    return got


def committed() -> dict:
    return json.loads(fixtures.DATAGEN_DIGESTS.read_text())


def assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (where, want.dtype)
        assert got.shape == want.shape, (where, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, (where, got, want)


def assert_views_equal(dataset: str, gd3d_tree: Path, port_tree: Path,
                       resolution=(64, 48)) -> None:
    """The port's reader on its tree gives the views, and the pretraining
    batch, that gd3d's reader gives on gd3d's tree."""
    import gd3d.data.stereo_views as JS
    import gd3d_torch.data.stereo_views as TS

    cls, kw = fixtures.TREE_VIEWS[dataset]
    jds = getattr(JS, cls)(str(gd3d_tree), resolution=resolution, seed=3, **kw)
    tds = getattr(TS, cls)(str(port_tree), resolution=resolution, seed=3, **kw)
    assert len(tds) == len(jds) > 0
    for idx in range(min(len(jds), 2)):
        assert_same(tds[idx], jds[idx], f"{dataset}[{idx}]")
    idxs = np.arange(len(jds))[:2]
    assert_same(TS.views_pretrain_batch(tds, idxs, np.random.RandomState(5), n_corres=32),
                JS.views_pretrain_batch(jds, idxs, np.random.RandomState(5), n_corres=32))


def gd3d_digests() -> dict:
    """The digests of gd3d's trees (see the module docstring)."""
    from gd3d.cli.preprocess import main as gd3d_preprocess
    from gd3d.cli.render import main as gd3d_render

    out = {"render": {}, "preprocess": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        glb_root = tmp / "assets"
        fixtures.write_glb(glb_root / fixtures.GLB_NAME)
        for run in fixtures.RENDER_RUNS:
            quiet(gd3d_render, fixtures.render_argv(run, glb_root, tmp / "render" / run))
            out["render"][run] = fixtures.tree_digests(tmp / "render" / run)
        for dataset in fixtures.RAW_DATASETS + ("habitat",):
            spec = None if dataset == "habitat" else fixtures.write_raw_tree(dataset,
                                                                             tmp / dataset)
            quiet(gd3d_preprocess, fixtures.preprocess_argv(dataset, spec, tmp / f"{dataset}_out"))
            out["preprocess"][dataset] = fixtures.tree_digests(tmp / f"{dataset}_out")
    return out


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    digests = gd3d_digests()
    fixtures.DATAGEN_DIGESTS.write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    print(f"wrote {fixtures.DATAGEN_DIGESTS}: "
          f"{sum(len(v) for part in digests.values() for v in part.values())} files")
