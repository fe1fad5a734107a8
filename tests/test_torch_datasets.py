"""The port's real-data readers against gd3d's on the installed cv2 and
PIL: the image loaders (gd3d_torch/data/images.py), the Objaverse and
ScanNet++ datasets (data/objaverse.py, data/scannetpp.py) on fabricated
trees (data/fixtures.py), the five configs' host batches (data/pipeline.py)
and the pair cache. Every comparison is exact: same keys, dtypes and bytes,
and the datasets' RandomStates equal after each sample.

A real-data host batch is compared as it crosses to the device: gd3d packs
its images to uint8 there (gd3d/cli/train.py::_pack_u8, which
pipeline.pack_u8 copies), and the port's batch is already packed.

The committed fixtures (gd3d_torch/data/testdata/) and their digests,
which chip_smoke.py's data phase holds the port to on the card, are checked
here too: cv2, PIL and gd3d must still give the committed digests, and so
must the port. `python tests/test_torch_datasets.py` writes the fixtures
and the digests anew.
"""
import argparse
import hashlib
import io
import json
import os
import pickle
import sys

import cv2
import numpy as np
import pytest
from PIL import Image, ImageOps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gd3d import native_runtime  # noqa: E402
from gd3d.data import augment as gaug  # noqa: E402
from gd3d.data import images as gimages  # noqa: E402
from gd3d.data import objaverse as gobj  # noqa: E402
from gd3d.data import scannetpp as gscan  # noqa: E402
from gd3d_torch.data import fixtures, images, objaverse, pipeline, scannetpp  # noqa: E402

TESTDATA = fixtures.TESTDATA


def _native_built() -> bool:
    """gd3d normalises images with its native library when it is built (its
    float32 arithmetic is the one the port copies); build it as
    tests/test_native.py does."""
    import shutil
    import subprocess

    if native_runtime.available():
        return True
    if shutil.which("g++") is None:
        return False
    subprocess.run([os.path.join(ROOT, "native", "build.sh")], check=True)
    native_runtime._lib = None
    return native_runtime.available()


pytestmark = pytest.mark.skipif(not _native_built(), reason="gd3d's native library unbuilt")


# ---------------------------------------------------------------------------
# Fixtures: written by cv2 and PIL
# ---------------------------------------------------------------------------

def texture(h, w, seed, c=3, noise=2.0):
    """A smooth multi-scale texture with a little noise."""
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w, c))
    for cell, amp in ((96, 60.0), (24, 30.0), (6, 10.0)):
        low = rng.randn(h // cell + 2, w // cell + 2, c)
        ys, xs = np.arange(h) / cell, np.arange(w) / cell
        y0, x0 = ys.astype(int), xs.astype(int)
        ty, tx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
        img += amp * ((low[y0][:, x0] * (1 - tx) + low[y0][:, x0 + 1] * tx) * (1 - ty)
                      + (low[y0 + 1][:, x0] * (1 - tx) + low[y0 + 1][:, x0 + 1] * tx) * ty)
    img += rng.randn(h, w, c) * noise
    return np.clip(img + 128, 0, 255).astype(np.uint8)


def render(k):
    """A 512^2 render of a textured, shaded ellipsoid: RGBA (anti-aliased
    alpha, black where transparent), 16-bit depth in mm, 8-bit mask."""
    rng = np.random.RandomState(100 + k)
    y, x = np.mgrid[0:512, 0:512] + 0.5
    cx, cy = 256 + rng.uniform(-30, 30), 256 + rng.uniform(-30, 30)
    r2 = ((x - cx) / rng.uniform(120, 190)) ** 2 + ((y - cy) / rng.uniform(120, 190)) ** 2
    inside = r2 < 1
    shade = np.sqrt(np.clip(1 - r2, 0, 1))
    col = texture(512, 512, k).astype(np.float64) * (0.35 + 0.65 * shade[..., None])
    rgba = np.zeros((512, 512, 4), np.uint8)
    rgba[..., :3] = np.where(inside[..., None], np.clip(col, 0, 255), 0).astype(np.uint8)
    rgba[..., 3] = np.round(np.clip((1 - r2) * 40, 0, 1) * 255).astype(np.uint8)
    depth = np.where(inside, np.round(2000 - 400 * shade + 3 * np.sin(x / 9)), 0)
    return rgba, depth.astype(np.uint16), np.where(inside, 255, 0).astype(np.uint8)


def _exif(orientation):
    ex = Image.Exif()
    ex[0x0112] = orientation
    return ex.tobytes()


def codec_images():
    """name -> a function writing it to a path: 45x37 images of each PNG
    kind, by cv2 (grey, RGB, RGBA at 8 and 16 bits, with libpng's adaptive
    filters, and RGB with the Average filter on every row) and by PIL (grey+alpha,
    palette with and without transparency, an RGB colour key, 16-bit grey
    with values below 255, an EXIF orientation)."""
    h, w = 37, 45
    t8 = texture(h, w, 1, c=4)
    t16 = (texture(h, w, 2, c=4).astype(np.uint16) * 257
           + np.random.RandomState(3).randint(0, 257, (h, w, 4))).astype(np.uint16)
    low16 = (np.random.RandomState(4).randint(0, 600, (h, w))).astype(np.uint16)
    pal = Image.fromarray(t8[..., :3]).quantize(64)
    key = t8[..., :3].copy()
    key[:5, :5] = (10, 20, 30)
    adaptive = [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS]
    return {
        "png_gray8.png": lambda p: cv2.imwrite(p, t8[..., 0], adaptive),
        "png_gray16.png": lambda p: cv2.imwrite(p, t16[..., 0], adaptive),
        "png_rgb8.png": lambda p: cv2.imwrite(p, t8[..., :3], adaptive),
        "png_rgb16.png": lambda p: cv2.imwrite(p, t16[..., :3], adaptive),
        "png_rgba8.png": lambda p: cv2.imwrite(p, t8, adaptive),
        "png_rgba16.png": lambda p: cv2.imwrite(p, t16, adaptive),
        "png_rgb8_avg.png": lambda p: cv2.imwrite(
            p, t8[..., :3], [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_FILTER_AVG]),
        "png_la8.png": lambda p: Image.fromarray(t8[..., :2], "LA").save(p),
        "png_palette.png": lambda p: pal.save(p),
        "png_palette_trns.png": lambda p: pal.save(p, transparency=5),
        "png_rgb_key.png": lambda p: Image.fromarray(key).save(p, transparency=(10, 20, 30)),
        "png_i16.png": lambda p: Image.fromarray(low16).save(p),
        "png_exif6.png": lambda p: Image.fromarray(t8[..., :3]).save(p, exif=_exif(6)),
    }


def write_fixtures():
    """Every fixture of gd3d_torch/data/testdata/ (about 1 MB)."""
    os.makedirs(TESTDATA, exist_ok=True)
    for name, write in codec_images().items():
        write(str(TESTDATA / name))
    for k in range(fixtures.RENDERS):
        rgba, depth, mask = render(k)
        color = str(TESTDATA / f"render_{k}_color.png")
        if k % 2:  # both writers: cv2 (libpng) and PIL
            cv2.imwrite(color, cv2.cvtColor(rgba, cv2.COLOR_RGBA2BGRA))
        else:
            Image.fromarray(rgba, "RGBA").save(color)
        cv2.imwrite(str(TESTDATA / f"render_{k}_depth.png"), depth,
                    [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
        cv2.imwrite(str(TESTDATA / f"render_{k}_mask.png"), mask)
    w, h = fixtures.DSLR_SIZE
    Image.fromarray(texture(h, w, 7)).save(TESTDATA / "dslr.jpg", quality=90)
    small = texture(30, 44, 8)
    for o in range(1, 9):
        Image.fromarray(small).save(TESTDATA / f"exif_{o}.jpg", quality=90, exif=_exif(o))


def png_filters(path):
    """The set of row filter types a PNG file uses."""
    import zlib

    from gd3d_torch.data import png

    data = open(path, "rb").read()
    dec = png.decode_png(data)
    chunks = dict(png.chunks(data, path))
    idat = zlib.decompress(b"".join(p for k, p in png.chunks(data, path) if k == b"IDAT"))
    h, w = dec.samples.shape[:2]
    stride = w * dec.samples.shape[2] * dec.bit_depth // 8
    assert b"IHDR" in chunks
    return {idat[y * (stride + 1)] for y in range(h)}


def _gd3d_config(name):
    from gd3d.core import config as jcfg

    return jcfg.resolve_config(name)


def gd3d_host_batches(config, root, epoch=0, steps=2, batch=1):
    """gd3d's first `steps` host batches of a real-data epoch at --workers 0
    (gd3d/cli/train.py's fetch), with its images packed to uint8 as gd3d
    packs them before the device (pipeline.pack_u8 is its _pack_u8)."""
    from gd3d.cli import train as jtrain
    from gd3d.data.loader import collate

    cfg = _gd3d_config(config)
    args = argparse.Namespace(synthetic=False, dev=False, data_root=str(root))
    ds = jtrain._make_epoch_dataset(args, cfg, epoch)
    tr = jtrain._sample_transform(cfg)
    return [pipeline.pack_u8(collate([tr(ds[(s * batch + i) % len(ds)])
                                      for i in range(batch)])) for s in range(steps)]


def reference_digests(tmp):
    """The digests of what cv2, PIL and gd3d give for the fixtures, in
    digests.json's layout (fixtures.port_digests computes the port's)."""
    sha = fixtures.sha
    names = sorted(os.listdir(TESTDATA))
    out = {"png": {}, "jpeg": {}, "loaders": {}, "augment": {}, "batches": {}}
    for name in (n for n in names if n.endswith(".png")):
        path = str(TESTDATA / name)
        rec = {m: sha(cv2.imread(path, f)) for m, f in fixtures.PNG_MODES.items()}
        rec["pil"] = sha(np.asarray(gimages._to_pil(path)))
        out["png"][name] = rec
    for name in (n for n in names if n.endswith(".jpg")):
        out["jpeg"][name] = {"pil": sha(np.asarray(gimages._to_pil(str(TESTDATA / name))))}
    for case, (kind, files, kw) in fixtures.LOADER_CASES.items():
        paths = [str(TESTDATA / f) for f in files]
        if kind == "mast3r":
            res = gimages.load_image_mast3r(paths[0], **kw)
            out["loaders"][case] = {"img": sha(res["img"]), "true_shape": sha(res["true_shape"])}
        elif kind == "vggt":
            out["loaders"][case] = {"img": sha(gimages.load_images_vggt(paths, **kw))}
        else:  # gd3d's ScanNetPPDataset._square_rgb before its / 255
            out["loaders"][case] = {"img": sha(np.asarray(Image.open(paths[0]).resize((512, 512))))}
    for case, spec in fixtures.AUGMENT_CASES.items():
        out["augment"][case] = fixtures.augment_record(lambda n: getattr(gaug, n), cv2.imread,
                                                       *spec)
    fixtures.write_scannetpp_tree(tmp)
    fixtures.write_objaverse_tree(tmp)
    for config, (_, _, steps) in fixtures.BATCH_RUNS.items():
        out["batches"][config] = [{k: sha(v) for k, v in b.items()}
                                  for b in gd3d_host_batches(config, tmp, steps=steps)]
    return out


def write_digests():
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        digests = reference_digests(tmp)
    digests["about"] = ("SHA-256 of the arrays cv2 5.0.0, PIL 12.1.0 and gd3d give for these "
                        "fixtures; written by python tests/test_torch_datasets.py")
    (TESTDATA / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

SECTIONS = ["png", "jpeg", "loaders", "augment", "batches"]


@pytest.fixture(scope="module")
def committed():
    return json.loads((TESTDATA / "digests.json").read_text())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_digests(str(tmp_path_factory.mktemp("reference")))


@pytest.mark.parametrize("section", SECTIONS)
def test_committed_digests_are_still_what_cv2_pil_and_gd3d_give(committed, reference, section):
    """Fails when cv2, PIL or gd3d drift from the committed digests (then
    `python tests/test_torch_datasets.py` writes them anew)."""
    assert fixtures.mismatches(reference[section], committed[section]) == []


@pytest.mark.parametrize("section", SECTIONS)
def test_port_gives_the_committed_digests(committed, section):
    got = fixtures.port_digests((section,))
    assert fixtures.mismatches(got[section], committed[section]) == []


def test_fixtures_use_every_png_filter():
    used = set()
    for name in os.listdir(TESTDATA):
        if name.endswith(".png"):
            used |= png_filters(str(TESTDATA / name))
    assert used == {0, 1, 2, 3, 4}


def _loader_files(tmp_path):
    """JPEG and PNG inputs of the loaders: downscaled (700x467), upscaled
    (300x200), square (512^2), portrait, RGBA, and EXIF orientations 1-8."""
    files = []
    for (h, w), kinds in (((467, 700), ("jpg", "png")), ((200, 300), ("jpg",)),
                          ((512, 512), ("png",)), ((333, 250), ("jpg",))):
        img = texture(h, w, h + w)
        for k in kinds:
            p = str(tmp_path / f"{h}x{w}.{k}")
            Image.fromarray(img).save(p, quality=90) if k == "jpg" else Image.fromarray(img).save(p)
            files.append(p)
    p = str(tmp_path / "rgba.png")
    Image.fromarray(render(1)[0], "RGBA").save(p)
    files.append(p)
    for o in range(1, 9):
        p = str(tmp_path / f"exif{o}.jpg")
        Image.fromarray(texture(120, 90, o)).save(p, quality=90, exif=_exif(o))
        files.append(p)
    return files


@pytest.mark.parametrize("size,square_ok", [(512, False), (512, True), (224, False)])
def test_load_image_mast3r_matches_gd3d(tmp_path, size, square_ok):
    for path in _loader_files(tmp_path):
        want = gimages.load_image_mast3r(path, size, square_ok)
        got = images.load_image_mast3r(path, size, square_ok)
        for k in ("img", "true_shape"):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, path
            np.testing.assert_array_equal(got[k], want[k], err_msg=path)


@pytest.mark.parametrize("mode", ["crop", "pad"])
def test_load_images_vggt_matches_gd3d(tmp_path, mode):
    files = _loader_files(tmp_path)
    for a, b in zip(files, files[1:]):
        try:
            want = gimages.load_images_vggt([a, b], mode)
        except AssertionError:  # gd3d refuses pairs of unequal shapes
            with pytest.raises(AssertionError):
                images.load_images_vggt([a, b], mode)
            continue
        got = images.load_images_vggt([a, b], mode)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{a} {b}")


def _same(got, want, where=""):
    assert set(got) == set(want), where
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
            assert np.asarray(g).dtype == np.asarray(w).dtype, (where, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {k}")
        else:
            assert type(g) is type(w) and g == w, (where, k, g, w)


def _same_rng(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a.rng.get_state(), b.rng.get_state()))


@pytest.fixture(scope="module")
def small_jpeg(tmp_path_factory):
    """A 584x389 frame: the ScanNet++ trees of these tests decode it instead
    of the 1752x1168 fixture, to keep them fast (the digests use that one)."""
    path = tmp_path_factory.mktemp("jpeg") / "frame.jpg"
    Image.fromarray(texture(389, 584, 11)).save(path, quality=90)
    return path


@pytest.fixture(scope="module")
def tree(tmp_path_factory, small_jpeg):
    root = tmp_path_factory.mktemp("tree")
    fixtures.write_scannetpp_tree(root, jpeg=small_jpeg)
    fixtures.write_objaverse_tree(root)
    return root


def _objaverse_pair(kind, root, seed):
    names = (root / "10k.txt").read_text().splitlines()
    renders = str(root / "objaverse_renderings")
    if kind in ("corr", "aug_corr"):
        poses = np.load(root / "obj_poses.npy")
        want = gobj.ObjaverseCorrDataset(renders, names, poses, seed=seed)
        got = objaverse.ObjaverseCorrDataset(renders, names, poses, seed=seed)
        if kind == "aug_corr":
            want = gobj.AugmentedCorrDataset(want, seed=seed)
            got = objaverse.AugmentedCorrDataset(got, seed=seed)
        return want, got
    vggt = kind.endswith("vggt")
    want = gobj.ObjaverseMASt3RDataset(renders, names, seed=seed, vggt=vggt)
    got = objaverse.ObjaverseMASt3RDataset(renders, names, seed=seed, vggt=vggt)
    if kind.startswith("aug"):
        want = gobj.AugmentedObjaverseDataset(want, seed=seed)
        got = objaverse.AugmentedObjaverseDataset(got, seed=seed)
    return want, got


@pytest.mark.parametrize("kind", ["corr", "aug_corr", "mast3r", "mast3r_vggt", "aug_mast3r",
                                  "aug_mast3r_vggt"])
def test_objaverse_datasets_match_gd3d(tree, kind):
    """Samples, and the RandomStates after each; the ME samples' 120 degree
    filter resamples here (the tree's poses span 150 degrees)."""
    for seed in (0, 5):
        want, got = _objaverse_pair(kind, tree, seed)
        for i in range(2):
            _same(got[i], want[i], f"{kind} seed {seed} sample {i}")
            assert _same_rng(got, want)
            if hasattr(want, "base"):
                assert _same_rng(got.base, want.base)


def test_objaverse_skips_a_broken_view_and_gives_up_after_ten_tries(tree, tmp_path):
    root = tmp_path / "t"
    fixtures.write_objaverse_tree(root)
    names = (root / "10k.txt").read_text().splitlines()
    renders = root / "objaverse_renderings"
    (renders / names[0] / "depth_000001.png").write_bytes(b"not a png")
    want = gobj.ObjaverseMASt3RDataset(str(renders), names, seed=3)
    got = objaverse.ObjaverseMASt3RDataset(str(renders), names, seed=3)
    for i in range(4):
        _same(got[i], want[i], f"sample {i}")
    for obj in names:
        for p in (renders / obj).glob("depth_*.png"):
            p.write_bytes(b"")
    with pytest.raises(RuntimeError, match="no loadable objaverse pair"):
        objaverse.ObjaverseMASt3RDataset(str(renders), names, seed=3)[0]


@pytest.mark.parametrize("vggt", [False, True], ids=["mast3r", "vggt"])
@pytest.mark.parametrize("augmented", [False, True], ids=["base", "augmented"])
def test_scannetpp_datasets_match_gd3d(tmp_path, small_jpeg, vggt, augmented):
    """On a tree where one frame carries EXIF orientation 6 (a small JPEG),
    so that the student square (no transpose) and the teacher images
    (transposed) take their different paths."""
    fixtures.write_scannetpp_tree(tmp_path, jpeg=small_jpeg)
    scene = fixtures.SCANNETPP_SCENES[0]
    images_dir = tmp_path / "scannetpp" / "scenes" / scene / "images"
    first = sorted(images_dir.iterdir())[0]
    first.write_bytes((TESTDATA / "exif_6.jpg").read_bytes())
    root = str(tmp_path / "scannetpp")
    want = gscan.ScanNetPPDataset(root, vggt=vggt, seed=1)
    got = scannetpp.ScanNetPPDataset(root, vggt=vggt, seed=1)
    if augmented:
        want = gscan.AugmentedScanNetPPDataset(want, seed=1)
        got = scannetpp.AugmentedScanNetPPDataset(got, seed=1)
    for i in range(6):
        try:
            w = want[i]
        except AssertionError:  # gd3d's load_images_vggt of a landscape and a portrait frame
            with pytest.raises(AssertionError):
                got[i]
        else:
            _same(got[i], w, f"sample {i}")
        assert _same_rng(got, want)


def test_pair_mining_matches_gd3d(tmp_path):
    rng = np.random.RandomState(0)
    for _ in range(20):
        a, b = np.eye(4), np.eye(4)
        a[:3, :3], _ = np.linalg.qr(rng.randn(3, 3))
        b[:3, :3], _ = np.linalg.qr(rng.randn(3, 3))
        a[:3, 3], b[:3, 3] = rng.randn(3) * 0.5, rng.randn(3) * 0.5
        assert scannetpp.is_co_view_transform(a, b) == gscan.is_co_view_transform(a, b)
    t = {"w": 1752, "h": 1168, "fl_x": 1150.3, "fl_y": 1149.1, "cx": 870.2, "cy": 590.7}
    np.testing.assert_array_equal(scannetpp.rescale_intrinsic(t), gscan.rescale_intrinsic(t))
    import random

    fixtures.write_scannetpp_tree(tmp_path, images=6)
    scene_to_imgs = {}
    for line in (tmp_path / "scannetpp/metadata/train_samples_all.txt").read_text().split():
        scene, img = line.split("_")
        scene_to_imgs.setdefault(scene, []).append(img)
    for total in (1, 4, 9, 1000):
        got = scannetpp.mine_pairs(tmp_path / "scannetpp", scene_to_imgs, total, random.Random(7))
        want = gscan.mine_pairs(tmp_path / "scannetpp", scene_to_imgs, total, random.Random(7))
        assert [p[:3] for p in got] == [p[:3] for p in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[3], w[3])


@pytest.mark.parametrize("writer", ["gd3d", "port"])
def test_pair_cache_is_read_by_the_other(tmp_path, writer):
    fixtures.write_scannetpp_tree(tmp_path)
    root = str(tmp_path / "scannetpp")
    first, second = (gscan, scannetpp) if writer == "gd3d" else (scannetpp, gscan)
    a = first.ScanNetPPDataset(root, seed=11)  # mines and writes the cache
    cache = tmp_path / "scannetpp" / "metadata" / "train_image_pairs.npy"
    assert cache.exists()
    with open(cache, "rb") as f:
        stored = pickle.load(f)
    b = second.ScanNetPPDataset(root, seed=99)  # another seed: it must read, not mine
    assert [p[:3] for p in b.image_pairs] == [p[:3] for p in a.image_pairs]
    assert [p[:3] for p in stored] == [p[:3] for p in a.image_pairs]
    for x, y in zip(a.image_pairs, b.image_pairs):
        np.testing.assert_array_equal(x[3], y[3])


CONFIGS = ["finetune_timm_me_objaverse", "finetune_timm_mast3r_objaverse",
           "finetune_timm_mast3r_scannetpp", "finetune_timm_vggt_objaverse",
           "finetune_timm_vggt_scannetpp"]


@pytest.mark.parametrize("config", CONFIGS)
def test_host_batches_match_gd3d(tmp_path, small_jpeg, config):
    """The first two host batches of epoch 1 at --workers 0, as they cross
    to the device: keys, dtypes and values."""
    gd3d_root, port_root = tmp_path / "gd3d", tmp_path / "port"
    for r in (gd3d_root, port_root):
        fixtures.write_scannetpp_tree(r, jpeg=small_jpeg)
        fixtures.write_objaverse_tree(r)
    want = gd3d_host_batches(config, gd3d_root, epoch=1)
    cfg = _gd3d_config(config)
    spec = pipeline.DataSpec(cfg.teacher, cfg.dataset, cfg.train.seed, str(port_root), 1)
    got = list(pipeline.EpochSource(spec, 0).batches(1, 2))
    assert len(got) == 2
    for s, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"step {s}")
        for k, v in g.items():
            if k.startswith("rgb"):
                assert v.dtype == np.uint8, k


def test_workers_give_the_same_batches_for_every_count(tree):
    spec = pipeline.DataSpec("mast3r", "objaverse", 42, str(tree), 2)
    runs = {}
    for n in (1, 3):
        source = pipeline.EpochSource(spec, n)
        try:
            runs[n] = list(source.batches(0, 3))
        finally:
            source.close()
    for a, b in zip(runs[1], runs[3]):
        _same(a, b)
    seq = list(pipeline.EpochSource(spec, 0).batches(0, 3))
    assert not all(np.array_equal(a["rgb_1"], b["rgb_1"]) for a, b in zip(seq, runs[1]))


def test_uint8_round_trip_of_every_value_matches_gd3ds_unpack():
    """gd3d's float images pack to the byte they came from, and the port's
    device unpacking (data/loader.py::unpack_u8) gives gd3d's _unpack_u8
    values (computed in jnp, as gd3d/cli/train.py does) bit for bit."""
    import jax.numpy as jnp
    import torch

    from gd3d_torch.data.loader import unpack_u8

    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, -1)
    mast3r = native_runtime.u8_to_f32_norm(u8, (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
    unit = (u8 / 255.0).astype(np.float32)
    packed = pipeline.pack_u8({"rgb_mast3r_1": mast3r, "rgb_1": unit, "rgb_vggt": unit})
    for k, v in packed.items():
        np.testing.assert_array_equal(v, u8, err_msg=k)
        want = np.asarray(v.astype(jnp.float32) / 127.5 - 1.0 if k.startswith("rgb_mast3r")
                          else jnp.asarray(v).astype(jnp.float32) / 255.0)
        got = unpack_u8(k, torch.from_numpy(v)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=k)
    # the port's loaders normalise as gd3d's native runtime does
    np.testing.assert_array_equal(images.u8_to_f32_norm(u8, (0.5,) * 3, (0.5,) * 3), mast3r)
    np.testing.assert_array_equal(images.u8_to_f32_norm(u8, (0.0,) * 3, (1.0,) * 3),
                                  native_runtime.u8_to_f32_norm(u8, (0.0,) * 3, (1.0,) * 3))


def test_keypoint_lift_matches_gd3d():
    from gd3d.ops.geometry import img_coord_2_obj_coord

    rng = np.random.RandomState(0)
    depth = rng.rand(64, 64) * 3
    poses = fixtures.objaverse_poses(4)
    for pose in poses:
        kp = rng.randint(0, 64, (50, 2))
        np.testing.assert_array_equal(
            objaverse.img_coord_2_obj_coord(kp, depth, objaverse.OBJAVERSE_INTRINSIC, pose),
            img_coord_2_obj_coord(kp, depth, gobj.OBJAVERSE_INTRINSIC, pose))
    np.testing.assert_array_equal(objaverse.MAST3R_INTRINSIC, gobj.MAST3R_INTRINSIC)


if __name__ == "__main__":
    write_fixtures()
    write_digests()
    print("wrote", TESTDATA)
