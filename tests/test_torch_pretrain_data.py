"""The port's pretraining data (gd3d_torch/data/render_synthetic.py,
pretrain_pairs.py, stereo_views.py, and resample.py's PIL and cv2 rules)
against gd3d's, PIL's and cv2's on the CPU.

Everything here is held bit for bit: the resizes against Pillow and cv2
on uint8 RGB, L and I;16 arrays up and down; the rasteriser against gd3d's
native library (native/libgd3d_native.so, which gd3d's render_mesh uses
wherever it is built, as here); the procedural and render-tree batches and
every stereo-view dataset's views (images, depth, K, poses, pts3d, masks)
and views_pretrain_batch (correspondences too) on fabricated trees, which
PIL writes as gd3d's tests do, and on the Co3D-v2 tree that chip_smoke.py
trains on (gd3d_torch/data/fixtures.py::write_co3d_tree, whose JPEG frames
`PYTHONPATH=. python tests/test_torch_pretrain_data.py` writes anew with PIL).
"""
import json
import os

import cv2
import numpy as np
import pytest
from PIL import Image

import gd3d.data.pretrain_pairs as JP
import gd3d.data.render_synthetic as JRS
import gd3d.data.stereo_views as JS
import gd3d_torch.data.pretrain_pairs as TP
import gd3d_torch.data.render_synthetic as TRS
import gd3d_torch.data.stereo_views as TS
from gd3d import native_runtime
from gd3d_torch.data import fixtures
from gd3d_torch.data import resample as R
from gd3d_torch.data.png import encode_png
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZES = [((37, 53), (20, 31)), ((37, 53), (90, 64)), ((64, 64), (64, 64)),
         ((30, 200), (112, 17)), ((96, 96), (224, 224))]


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
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (where, got, want.dtype)
        assert got.shape == want.shape, (where, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, (where, got, want)


# ---------------------------------------------------------------- resample
@pytest.mark.parametrize("hw,out", SIZES)
def test_pil_bilinear_and_nearest_and_cv2_nearest(hw, out):
    rng = np.random.RandomState(hw[0] * out[1])
    rgb = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
    grey = rng.randint(0, 256, hw).astype(np.uint8)
    i16 = rng.randint(0, 65536, hw).astype(np.uint16)
    depth = rng.rand(*hw).astype(np.float32)
    w, h = out
    np.testing.assert_array_equal(R.resize_bilinear(rgb, out),
                                  np.asarray(Image.fromarray(rgb).resize(out, Image.BILINEAR)))
    np.testing.assert_array_equal(R.resize_bilinear(grey, out),
                                  np.asarray(Image.fromarray(grey).resize(out, Image.BILINEAR)))
    for a in (rgb, grey, i16):
        im = Image.fromarray(a)
        assert im.mode in ("RGB", "L", "I;16")
        np.testing.assert_array_equal(R.resize_nearest_pil(a, out),
                                      np.asarray(im.resize(out, Image.NEAREST)))
    for a in (depth, rgb, i16):
        np.testing.assert_array_equal(R.resize_nearest_cv(a, out),
                                      cv2.resize(a, (w, h), interpolation=cv2.INTER_NEAREST))


# ------------------------------------------------- renderer and pairs
def test_native_rasteriser_is_in_place():
    assert native_runtime.available(), "gd3d's render_mesh must run its native library here"


@pytest.mark.parametrize("size", [64, 224, 512])
def test_render_mesh_equals_gd3d_native(size):
    poses = JRS.fixed_poses(42)
    K = JRS.DEFAULT_INTRINSIC * (size / 512.0)
    K[2, 2] = 1.0
    assert_same(TRS.fixed_poses(42), poses)
    assert_same(TRS.icosphere(2), JRS.icosphere(2))
    for i in range(3):
        obj = JRS.procedural_object(np.random.RandomState(i))
        assert_same(TRS.procedural_object(np.random.RandomState(i)), obj)
        E = poses[(i * 11) % 42]
        assert_same(TRS.render_mesh(*obj, E, K, size), JRS.render_mesh(*obj, E, K, size))


@pytest.mark.parametrize("seed,batch,img,corres", [(0, 2, 64, 32), (7, 3, 96, 256)])
def test_synthetic_pretrain_batch_equals_gd3d(seed, batch, img, corres):
    assert_same(TP.synthetic_pretrain_batch(seed, batch, img, corres),
                JP.synthetic_pretrain_batch(seed, batch, img, corres))


@pytest.fixture(scope="module")
def render_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("render")
    poses = JRS.render_object_tree(str(root), ["a", "b"], n_views=5, size=96, seed=1)
    np.save(root / "obj_poses.npy", poses)
    return root


@pytest.mark.parametrize("img", [64, 96, 150])
def test_rendered_pretrain_batch_equals_gd3d(render_tree, img):
    assert_same(TP.rendered_pretrain_batch(render_tree, 3, 2, img, 24),
                JP.rendered_pretrain_batch(render_tree, 3, 2, img, 24))


def test_rgba_colour_views_are_refused(tmp_path, render_tree):
    (tmp_path / "o").mkdir()
    for f in ("depth_000000.png", "mask_000000.png"):
        (tmp_path / "o" / f).write_bytes((render_tree / "a" / f).read_bytes())
    Image.new("RGBA", (96, 96)).save(tmp_path / "o" / "color_000000.png")
    with pytest.raises(ValueError, match="color_000000.png"):
        TP._load_view(tmp_path / "o", 0, 64)


# ------------------------------------------------------- stereo views
K_CAM = lambda w, h: np.array([[70.0, 0, w / 2], [0, 70.0, h / 2], [0, 0, 1]], np.float32)  # noqa: E731


def _img(rng, path, w, h):
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(path)


def _frame(rng, d, stem, w, h, depth=None, split_rt=False, pose=None):
    """jpg + the float depth's .exr.npy sibling + camera npz."""
    os.makedirs(d, exist_ok=True)
    _img(rng, os.path.join(d, stem + ".jpg"), w, h)
    if depth is None:
        depth = (rng.random((h, w)) * 2 + 1).astype(np.float32)
    np.save(os.path.join(d, stem + ".exr.npy"), depth)
    pose = np.eye(4, dtype=np.float32) if pose is None else pose
    if split_rt:
        np.savez(os.path.join(d, stem + ".npz"), intrinsics=K_CAM(w, h),
                 R_cam2world=pose[:3, :3], t_cam2world=pose[:3, 3])
    else:
        np.savez(os.path.join(d, stem + ".npz"), intrinsics=K_CAM(w, h), cam2world=pose)


def _orbit(i, n):
    a = 2 * np.pi * i / n
    c, s = np.cos(a), np.sin(a)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    pose[:3, 3] = [2 * s, 0, -2 * c]
    return pose


def make_co3d(root, w, h, rng, wild=False, n=8):
    base = os.path.join(root, "apple", "seq1")
    subs = ("rgb", "depth", "masks", "metadata") if wild else ("images", "depths", "masks")
    for sub in subs:
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    for i in range(n):
        if wild:
            _img(rng, os.path.join(base, "rgb", f"{i:0>5d}.jpg"), w, h)
            np.savez(os.path.join(base, "metadata", f"{i:0>5d}.npz"),
                     camera_intrinsics=K_CAM(w, h), camera_pose=_orbit(i, n))
            depth = (rng.random((h, w)) * 800 + 800).astype(np.uint16)
            Image.fromarray(depth).save(os.path.join(base, "depth", f"{i:0>5d}.png"))
            mask = np.full((h, w, 3), 255, np.uint8)  # an RGB mask: convert("L")
            mask[:5] = (10, 200, 30)
            Image.fromarray(mask).save(os.path.join(base, "masks", f"{i:0>5d}.png"))
            continue
        _img(rng, os.path.join(base, "images", f"frame{i:06n}.jpg"), w, h)
        np.savez(os.path.join(base, "images", f"frame{i:06n}.npz"),
                 camera_intrinsics=K_CAM(w, h), camera_pose=_orbit(i, n), maximum_depth=4.0)
        depth16 = ((rng.random((h, w)) * 0.4 + 0.4) * 65535).astype(np.uint16)
        if i == 2:
            depth16[:] = 0  # an empty frame: the loader walks to a valid one
        Image.fromarray(depth16).save(os.path.join(base, "depths", f"frame{i:06n}.jpg.geometric.png"))
        mask = np.zeros((h, w), np.uint8)
        mask[10:-10, 14:-14] = 255
        Image.fromarray(mask).save(os.path.join(base, "masks", f"frame{i:06n}.png"))
    with open(os.path.join(root, "selected_seqs_train.json"), "w") as f:
        json.dump({"apple": {"seq1": list(range(n))}}, f)


def _metadata_tree(root, rng, w, h, sub, rgb_dir, depth_dir, rgb_name, scene="s0", n=4):
    sdir = os.path.join(root, *sub, scene)
    os.makedirs(os.path.join(sdir, rgb_dir))
    os.makedirs(os.path.join(sdir, depth_dir))
    names, poses = [], []
    for i in range(n):
        name = rgb_name(i)
        names.append(name)
        _img(rng, os.path.join(sdir, rgb_dir, name.replace(".png", "") + ".jpg"), w, h)
        depth = (rng.random((h, w)) * 900 + 600).astype(np.uint16)
        Image.fromarray(depth).save(os.path.join(
            sdir, depth_dir, name if name.endswith(".png") else name + ".png"))
        poses.append(_orbit(i, 3 * n))
    np.savez(os.path.join(root, *sub, "all_metadata.npz"), scenes=np.array([scene]),
             sceneids=np.zeros(n, np.int64), images=np.array(names),
             intrinsics=np.stack([K_CAM(w, h)] * n), trajectories=np.stack(poses),
             pairs=np.array([[0, 1], [1, 2], [2, 3]], np.int64))


def make_scannetpp(root, w, h, rng):
    _metadata_tree(root, rng, w, h, (), "images", "depth", lambda i: f"frame_{i:04d}")


def make_arkit(root, w, h, rng):
    # stored as .png names, rgb saved as .jpg
    _metadata_tree(root, rng, w, h, ("Training",), "vga_wide", "lowres_depth",
                   lambda i: f"41069021_{i:.3f}.png", scene="41069021")


def make_blendedmvs(root, w, h, rng):
    rec = np.dtype([("seq_high", "<i8"), ("seq_low", "<i8"), ("im1", "<i4"), ("im2", "<i4"),
                    ("score", "<f4")])
    np.save(os.path.join(root, "blendedmvs_pairs.npy"),
            np.array([(0, 5, 0, 1, 0.9), (0, 7, 1, 0, 0.7), (0, 10, 0, 1, 0.8)], rec))
    for seql in (5, 7, 10):
        for i in range(2):
            _frame(rng, os.path.join(root, f"{0:08x}{seql:016x}"), f"{i:08n}", w, h,
                   split_rt=True, pose=_orbit(i, 8))


def make_megadepth(root, w, h, rng):
    rec = np.dtype([("scene_id", "<i8"), ("im1_id", "<i8"), ("im2_id", "<i8"), ("score", "<f4")])
    np.savez(os.path.join(root, "all_metadata.npz"), scenes=np.array(["0001 0", "0015 0"]),
             images=np.array(["im_a", "im_b", "im_c", "im_d"]),
             pairs=np.array([(0, 0, 1, 0.5), (0, 1, 0, 0.4), (1, 2, 3, 0.5)], rec))
    for scene, ims in (("0001", ("im_a", "im_b")), ("0015", ("im_c", "im_d"))):
        for i, im in enumerate(ims):
            _frame(rng, os.path.join(root, scene, "0"), im, w, h, pose=_orbit(i, 8))


def make_staticthings(root, w, h, rng):
    rec = np.dtype([("scene", "S2"), ("seq", "<i4"), ("cam1", "S1"), ("im1", "<i4"),
                    ("cam2", "S1"), ("im2", "<i4")])
    np.save(os.path.join(root, "staticthings_pairs.npy"),
            np.array([(b"A", 0, b"l", 6, b"r", 7), (b"A", 0, b"r", 6, b"l", 7)], rec))
    depth = (rng.random((h, w)) * 50 + 10).astype(np.float32)
    depth[:10] = 300.0  # the far plane mask_bg drops
    for cam in ("left", "right"):
        for i in (6, 7):
            d = os.path.join(root, "TRAIN", "A", "0000", cam)
            _frame(rng, d, f"{i:04n}", w, h, depth=depth)
            os.link(os.path.join(d, f"{i:04n}.jpg"), os.path.join(d, f"{i:04n}_clean.jpg"))
            os.rename(os.path.join(d, f"{i:04n}.jpg"), os.path.join(d, f"{i:04n}_final.jpg"))


def make_waymo(root, w, h, rng):
    np.savez(os.path.join(root, "waymo_pairs.npz"), scenes=np.array(["segment-1"]),
             frames=np.array(["00000_1", "00001_1"]), pairs=np.array([[0, 0, 1], [0, 1, 0]]))
    for i, f in enumerate(("00000_1", "00001_1")):
        _frame(rng, os.path.join(root, "segment-1"), f, w, h, pose=_orbit(i, 8))


def make_habitat(root, w, h, rng):
    data_dir = os.path.join(root, "sceneA")
    os.makedirs(data_dir)
    for i in range(1, 6):
        _img(rng, os.path.join(data_dir, f"00000_{i}.jpeg"), w, h)
        np.save(os.path.join(data_dir, f"00000_{i}_depth.exr.npy"),
                (rng.random((h, w)) * 2 + 1).astype(np.float32))
        t = [np.nan] * 3 if i == 2 else [0.1 * i, 0.0, 0.0]  # a broken pose
        with open(os.path.join(data_dir, f"00000_{i}_camera_params.json"), "w") as f:
            json.dump({"camera_intrinsics": K_CAM(w, h).tolist(),
                       "R_cam2world": np.eye(3).tolist(), "t_cam2world": t}, f)
    with open(os.path.join(root, "Habitat_1000000_scenes_train.txt"), "w") as f:
        f.write(os.path.join("sceneA", "00000") + "\n")


DATASETS = {
    "co3d": (make_co3d, "Co3dViews", dict(split="train")),
    "co3d_rand": (make_co3d, "Co3dViews", dict(split="train", mask_bg="rand")),
    "wildrgbd": (lambda r, w, h, g: make_co3d(r, w, h, g, wild=True), "WildRGBDViews",
                 dict(split="train")),
    "scannetpp": (make_scannetpp, "ScanNetppViews", dict(split="train")),
    "arkit": (make_arkit, "ARKitScenesViews", dict(split="train")),
    "blendedmvs": (make_blendedmvs, "BlendedMVSViews", dict(split="train")),
    "megadepth": (make_megadepth, "MegaDepthViews", dict(split="train")),
    "staticthings": (make_staticthings, "StaticThings3DViews", dict()),
    "waymo": (make_waymo, "WaymoViews", dict()),
    "habitat": (make_habitat, "HabitatViews", dict(split="train", size=1_000_000)),
}


def pair_of(name, root, resolution, seed, **extra):
    make, cls, kw = DATASETS[name]
    kw = {**kw, **extra, "resolution": resolution, "seed": seed}
    return getattr(JS, cls)(str(root), **kw), getattr(TS, cls)(str(root), **kw)


@pytest.mark.parametrize("name", list(DATASETS))
@pytest.mark.parametrize("frame,resolution", [((80, 60), (48, 32)), ((60, 80), (64, 48)),
                                              ((40, 30), (96, 72))],
                         ids=["down", "portrait", "up"])
def test_stereo_views_equal_gd3d(name, frame, resolution, tmp_path):
    DATASETS[name][0](str(tmp_path), *frame, np.random.default_rng(len(name)))
    jds, tds = pair_of(name, tmp_path, resolution, seed=3)
    assert len(tds) == len(jds) and tds.is_metric_scale == jds.is_metric_scale
    for idx in range(min(len(jds), 3)):
        assert_same(tds[idx], jds[idx], f"{name}[{idx}]")
    rng_j, rng_t = np.random.RandomState(5), np.random.RandomState(5)
    idxs = np.arange(len(jds))[:2]
    assert_same(TS.views_pretrain_batch(tds, idxs, rng_t, n_corres=24),
                JS.views_pretrain_batch(jds, idxs, rng_j, n_corres=24))


def test_unseeded_views_keep_the_seed_quirk(tmp_path):
    """seed 0 is falsy: an unseeded generator, as in gd3d; with the same
    generator both packages give the same views."""
    make_co3d(str(tmp_path), 80, 60, np.random.default_rng(0))
    jds, tds = pair_of("co3d", tmp_path, (48, 32), seed=0)
    jds._rng, tds._rng = np.random.default_rng(9), np.random.default_rng(9)
    assert_same(tds[4], jds[4])


def test_combinators_equal_gd3d(tmp_path):
    for d in ("s", "w"):
        (tmp_path / d).mkdir()
    make_scannetpp(str(tmp_path / "s"), 80, 60, np.random.default_rng(1))
    make_waymo(str(tmp_path / "w"), 80, 60, np.random.default_rng(2))
    (js, ts), (jw, tw) = (pair_of("scannetpp", tmp_path / "s", (48, 32), 4),
                          pair_of("waymo", tmp_path / "w", (48, 32), 4))
    for jc, tc in ((2 * js, 2 * ts), (js + jw, ts + tw), (7 @ jw, 7 @ tw)):
        assert type(tc).__name__ == type(jc).__name__ and len(tc) == len(jc)
        jc.set_epoch(3)
        tc.set_epoch(3)
        for i in range(len(jc)):
            assert_same(tc[i], jc[i], f"{type(jc).__name__}[{i}]")
    cat_j, cat_t = js + jw, ts + tw
    with pytest.raises(IndexError):
        cat_t[len(cat_t)]
    assert_same(TS.views_pretrain_batch(cat_t, [0, 4, 3], np.random.RandomState(1), 16),
                JS.views_pretrain_batch(cat_j, [0, 4, 3], np.random.RandomState(1), 16))


def test_float_depth_needs_its_npy_sibling(tmp_path):
    d = np.random.default_rng(0).random((6, 8)).astype(np.float32)
    np.save(tmp_path / "0000.exr.npy", d)
    np.testing.assert_array_equal(TS.read_depth_float(str(tmp_path / "0000.exr")), d)
    with pytest.raises(ValueError, match="missing.exr"):
        TS.read_depth_float(str(tmp_path / "missing.exr"))


def test_masks_convert_to_l_as_pil_does(tmp_path):
    rng = np.random.RandomState(0)
    for mode, arr in (("RGB", rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)),
                      ("L", rng.randint(0, 256, (9, 11)).astype(np.uint8))):
        p = tmp_path / f"{mode}.png"
        p.write_bytes(encode_png(arr))
        np.testing.assert_array_equal(TS._open_l(p), np.asarray(Image.open(p).convert("L")))


def test_co3d_fixture_tree_equals_gd3d(tmp_path):
    """chip_smoke.py's Co3D-v2 tree (the committed 192x144 JPEGs, 16-bit
    depth, masks): the views and the pretraining batch at 224^2 equal
    gd3d's, and the frames decode to PIL's pixels."""
    root = fixtures.write_co3d_tree(tmp_path)
    for k in range(fixtures.CO3D_JPEGS):
        path = fixtures.TESTDATA / "co3d" / f"frame_{k}.jpg"
        np.testing.assert_array_equal(TS._open_rgb(path),
                                      np.asarray(Image.open(path).convert("RGB")))
    jds, tds = JS.Co3dViews(str(root), split="train", resolution=(224, 224), seed=1), \
        TS.Co3dViews(str(root), split="train", resolution=(224, 224), seed=1)
    assert_same(TS.views_pretrain_batch(tds, [0, 17], np.random.RandomState(2), 256),
                JS.views_pretrain_batch(jds, [0, 17], np.random.RandomState(2), 256))


def write_co3d_jpegs():
    """The Co3D fixture frames: four 768x576 windows of testdata/dslr.jpg,
    Lanczos-resized to 192x144 and saved at quality 90 by PIL."""
    im = Image.open(fixtures.TESTDATA / "dslr.jpg").convert("RGB")
    (fixtures.TESTDATA / "co3d").mkdir(exist_ok=True)
    for k in range(fixtures.CO3D_JPEGS):
        x, y = 200 + 260 * k, 150 + 60 * k
        im.crop((x, y, x + 768, y + 576)).resize(fixtures.CO3D_SIZE, Image.LANCZOS).save(
            fixtures.TESTDATA / "co3d" / f"frame_{k}.jpg", quality=90)


if __name__ == "__main__":
    write_co3d_jpegs()
