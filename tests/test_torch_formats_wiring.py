"""The formats slice wired through the port, against gd3d on the CPU:

  * the committed fixtures (gd3d_torch/data/testdata/formats and exr,
    written by tests/torch_formats_gen.py; the animated WebPs, the HDF5
    filters, types, links and external storage and the EXR files of every
    channel set, container and compression among them): PIL, h5py, gd3d's
    load_image_mast3r and gd3d's flowio still give the committed digests, so
    the fixtures cannot drift, and the port gives them too, OpenCV 4.6's
    EXR arrays included, and its refusals where OpenCV returns None (what
    chip_smoke.py's formats phase checks on the card's machine);
  * the align CLI at --tiny on the four views (progressive JPEG, WebP, BMP,
    Adam7 PNG): scene.npz's images are gd3d's load_image_mast3r arrays;
  * a .glb whose texture is a WebP (with alpha) or a BMP, against gd3d's
    _decode_image (convert("RGB"), alpha dropped);
  * MegaDepth preprocessing on depth that h5py wrote, against gd3d's CLI;
  * read_depth_float on an EXR-only tree: the stereo-view dataset's items
    equal those of the same tree with .npy depth;
  * image_size of every image fixture against PIL's .size, and a broken
    file named in the error;
  * tests/torch_jpeg_writer.py's files (arithmetic-coded, lossless and
    block-smoothed JPEGs, written afresh, none committed): their bytes to
    the committed SHA-256 and the port's RGB to PIL's digest, and
    load_image_mast3r on three of them against gd3d's."""
import hashlib
import io
import json
import os
import shutil
import sys
from contextlib import chdir
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from torch_threads import one_torch_thread  # noqa: E402,F401
from gd3d_torch.data import exr, flowio, hdf5, images  # noqa: E402
from gd3d_torch.data import fixtures  # noqa: E402

FORMATS = ROOT / "gd3d_torch" / "data" / "testdata" / "formats"
EXR = ROOT / "gd3d_torch" / "data" / "testdata" / "exr"
DIGESTS = json.loads((FORMATS / "digests.json").read_text())


def sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def port_digest(kind, name):
    """The port's array of one fixture, as chip_smoke.py's formats phase
    takes it."""
    if kind == "image":
        return sha(images.decode_rgb((FORMATS / name).read_bytes(), name, composite=False))
    if kind == "view":
        return sha(images.load_image_mast3r(str(FORMATS / "views" / name), 512)["img"])
    if kind == "exr":
        return sha(exr.read_exr(FORMATS / name))
    if kind == "exr_cv":
        try:
            return sha(exr.read_exr(EXR / name))
        except exr.OpenCVRefuses:
            return None  # cv2.imread returns None for these
    if kind == "hdf5":
        return sha(hdf5.read_dataset(FORMATS / name, "depth"))
    if kind == "hdf5_more":
        from torch_formats_gen import h5_digest

        file, dataset = name.split("#")
        with chdir(FORMATS):  # external storage is named from the working directory
            return h5_digest(hdf5.read_dataset(FORMATS / file, dataset))
    return sha(flowio.read_gt(str(FORMATS / name), "stereo" if name.endswith(".h5") else "flow"))


def reference_digest(kind, name):
    """The libraries' (and gd3d's) array of one fixture."""
    if kind == "image":
        from PIL import Image

        return sha(np.asarray(Image.open(FORMATS / name).convert("RGB")))
    if kind == "view":
        from gd3d.data.images import load_image_mast3r

        return sha(load_image_mast3r(str(FORMATS / "views" / name), 512)["img"])
    if kind in ("exr", "exr_cv"):
        return None  # OpenCV's, held in tests/test_torch_exr_oracle.py with the live oracle
    if kind == "hdf5":
        import h5py

        with h5py.File(FORMATS / name) as f:
            return sha(np.asarray(f["depth"]))
    if kind == "hdf5_more":
        import h5py

        from torch_formats_gen import h5_digest

        file, dataset = name.split("#")
        with chdir(FORMATS), h5py.File(FORMATS / file) as f:
            return h5_digest(f[dataset][()])
    import gd3d.data.flowio as gflow

    return sha(gflow.read_gt(str(FORMATS / name), "stereo" if name.endswith(".h5") else "flow"))


CASES = sorted((kind, name) for kind, entries in DIGESTS.items() for name in entries
               if kind != "jpeg_writer")


@pytest.mark.parametrize("kind,name", CASES, ids=[f"{k}-{n}" for k, n in CASES])
def test_committed_fixtures_match_their_digests(kind, name):
    want = DIGESTS[kind][name]
    ref = reference_digest(kind, name)
    assert ref in (None, want), "the library no longer gives the committed digest"
    assert port_digest(kind, name) == want


def test_fixtures_stay_small():
    total = sum(p.stat().st_size for p in FORMATS.rglob("*") if p.is_file())
    assert total < 400_000, total


def test_exr_fixtures_stay_small():
    """The EXR fixtures (three 512x384 files among them, for timing) stay
    under 1.5 MB, and every one has its digest."""
    files = sorted(p.name for p in EXR.iterdir())
    assert files == sorted(DIGESTS["exr_cv"])
    assert sum((EXR / f).stat().st_size for f in files) < 1_500_000


@pytest.mark.parametrize("name", sorted(DIGESTS["image"]))
def test_image_size_matches_pil(name):
    from PIL import Image

    assert images.image_size(FORMATS / name) == Image.open(FORMATS / name).size


@pytest.mark.parametrize("name", ["progressive_854x480.jpg", "cmyk.jpg", "lossy_512x384.webp",
                                  "lossless_512x384.webp", "rle8.bmp", "adam7.png"])
def test_broken_files_are_named_in_the_error(tmp_path, name):
    """A truncated file read through images.open_rgb or images.image_size
    raises a ValueError naming its path: the bytes read once are handed on
    to each decoder with the file's name."""
    data = (FORMATS / name).read_bytes()
    path = tmp_path / name
    for cut, read in ((len(data) // 2, images.open_rgb), (20, images.image_size)):
        path.write_bytes(data[:cut])
        with pytest.raises(ValueError) as err:
            read(path)
        assert str(path) in str(err.value) and "<bytes>" not in str(err.value)


def test_align_cli_on_the_four_formats_equals_gd3d_load_images(tmp_path):
    from gd3d.data.images import load_image_mast3r
    from gd3d_torch.cli import align

    views = tmp_path / "views"
    shutil.copytree(FORMATS / "views", views)
    files = sorted(views.iterdir())
    assert [f.suffix for f in files] == [".jpg", ".webp", ".bmp", ".png"]
    res = align.main(["--images", str(views), "--output", str(tmp_path / "out"), "--tiny",
                      "--device", "cpu", "--size", "224", "--niter", "2", "--sparse", "0"])
    z = np.load(tmp_path / "out" / "scene.npz")
    want = np.stack([load_image_mast3r(str(f), 224)["img"] for f in files])
    np.testing.assert_array_equal(z["images"], want)
    assert np.isfinite(z["pts3d"]).all() and res is not None


@pytest.fixture(scope="module")
def writer_files():
    from torch_jpeg_writer import fixture_files

    return fixture_files()


@pytest.mark.parametrize("name", sorted(DIGESTS["jpeg_writer"]))
def test_jpeg_writer_files_match_their_digests(writer_files, name):
    """The writer still writes the committed bytes from its seeds (what
    chip_smoke.py's formats phase writes on the card's machine), PIL still
    decodes them to the committed RGB, and the port does too, through
    images.decode_rgb and image_size."""
    from PIL import Image

    data, want = writer_files[name], DIGESTS["jpeg_writer"][name]
    assert hashlib.sha256(data).hexdigest() == want["file"]
    assert sha(np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))) == want["rgb"]
    assert sha(images.decode_rgb(data, name, composite=False)) == want["rgb"]
    assert images.image_size(data) == Image.open(io.BytesIO(data)).size


@pytest.mark.parametrize("name", ["arith_seq_restart_dac.jpg", "lossless_p6_pt2_restart.jpg",
                                  "smooth_prog_420.jpg"])
def test_load_image_mast3r_equals_gd3d_on_written_jpegs(tmp_path, writer_files, name):
    """An arithmetic-coded, a lossless and a block-smoothed JPEG through
    the port's load_image_mast3r and gd3d's (PIL) at 512: the same array."""
    from gd3d.data.images import load_image_mast3r as gd3d_load

    path = tmp_path / name
    path.write_bytes(writer_files[name])
    got = images.load_image_mast3r(str(path), 512)
    want = gd3d_load(str(path), 512)
    assert got["img"].dtype == want["img"].dtype
    np.testing.assert_array_equal(got["img"], want["img"])


def test_align_cli_refuses_a_broken_view_by_name(tmp_path):
    from gd3d_torch.cli import align

    views = tmp_path / "views"
    shutil.copytree(FORMATS / "views", views)
    data = (views / "view_1.webp").read_bytes()
    (views / "view_1.webp").write_bytes(data[:40])
    with pytest.raises(ValueError, match="view_1.webp"):
        align.main(["--images", str(views), "--output", str(tmp_path / "out"), "--tiny",
                    "--device", "cpu", "--size", "224", "--niter", "2"])


def _glb_texture_gltf(data):
    gltf = {"buffers": [{"byteLength": len(data)}],
            "bufferViews": [{"buffer": 0, "byteLength": len(data)}],
            "images": [{"bufferView": 0}]}
    return gltf, data


@pytest.mark.parametrize("name", ["alpha.webp", "lossy_512x384.webp", "bgra32_v5.bmp",
                                  "rle8.bmp", "progressive_854x480.jpg", "adam7.png"])
def test_glb_texture_equals_gd3d(name):
    import gd3d.data.glb as J
    import gd3d_torch.data.glb as T

    gltf, data = _glb_texture_gltf((FORMATS / name).read_bytes())
    np.testing.assert_array_equal(T._decode_image(gltf, data, 0), J._decode_image(gltf, data, 0))


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_megadepth_cli_on_h5py_depth_equals_gd3d(tmp_path, libver):
    import h5py

    from gd3d.cli.preprocess import main as gd3d_main
    from gd3d_torch.cli.preprocess import main as port_main
    from torch_datagen import assert_trees_equal, quiet

    spec = fixtures.write_raw_tree("megadepth", tmp_path / "raw")
    for h5 in sorted((tmp_path / "raw").rglob("*.h5")):
        d = hdf5.read_dataset(h5, "depth")
        with h5py.File(h5, "w", libver=libver) as f:
            f.create_dataset("depth", data=d, compression="gzip", shuffle=True, chunks=(8, 16))
    quiet(gd3d_main, fixtures.preprocess_argv("megadepth", spec, tmp_path / "gd3d"))
    quiet(port_main, fixtures.preprocess_argv("megadepth", spec, tmp_path / "port"))
    assert assert_trees_equal(tmp_path / "gd3d", tmp_path / "port")


@pytest.mark.parametrize("dataset,compression", [("blendedmvs", "ZIP"),
                                                 ("staticthings3d", "PIZ"),
                                                 ("megadepth", "RLE")])
def test_exr_only_tree_equals_npy_tree(tmp_path, dataset, compression):
    """Each float depth sibling written as an EXR (and the sibling
    removed): the dataset's items are the .npy tree's."""
    import gd3d_torch.data.stereo_views as TS
    from exr_writer import write_exr
    from gd3d_torch.cli.preprocess import main as port_main
    from torch_datagen import assert_same, quiet

    spec = fixtures.write_raw_tree(dataset, tmp_path / "raw")
    quiet(port_main, fixtures.preprocess_argv(dataset, spec, tmp_path / "npy"))
    shutil.copytree(tmp_path / "npy", tmp_path / "exr")
    sibs = sorted((tmp_path / "exr").rglob("*.exr.npy"))
    assert sibs
    for npy in sibs:
        write_exr(str(npy)[:-4], np.load(npy), compression)
        npy.unlink()
    cls, kw = fixtures.TREE_VIEWS[dataset]
    a = getattr(TS, cls)(str(tmp_path / "npy"), resolution=(64, 48), seed=3, **kw)
    b = getattr(TS, cls)(str(tmp_path / "exr"), resolution=(64, 48), seed=3, **kw)
    assert len(a) == len(b) > 0
    for idx in range(min(len(a), 2)):
        assert_same(b[idx], a[idx], f"{dataset}[{idx}]")
    missing = tmp_path / "nothing.exr"
    with pytest.raises(ValueError, match="nothing.exr.*nothing.exr.npy"):
        TS.read_depth_float(str(missing))


def test_write_flo5_round_trip(tmp_path):
    import h5py

    flow = np.random.RandomState(0).randn(31, 45, 2).astype(np.float32)
    p = str(tmp_path / "w.flo5")
    flowio.write_flo5(p, flow)
    np.testing.assert_array_equal(flowio.read_gt(p, "flow"), flow)
    with h5py.File(p) as f:
        np.testing.assert_array_equal(np.asarray(f["flow"]), flow)
    assert os.path.getsize(p) > 0
