"""The port's stereo and flow files, visualization and augmentors
(gd3d_torch/data/flowio.py) against gd3d's (gd3d/data/flowio.py, which
reads and writes through PIL, cv2 and numpy) and against cv2 itself, on
the CPU.

Everything is held equal, bit for bit: the decoded arrays of every file
either package writes, the INFERNO table (all 256 entries of
cv2.applyColorMap), adjust_hue, cv2.resize's INTER_LINEAR on uint8 and
2-channel float32 images and INTER_NEAREST on float32 ones at the
augmentors' random scales, both augmentors' outputs and RandomState draws, discover_pairs in
every layout and StereoFlowPairs' items, and the HDF5 disparity and flow
readers and write_flo5 against h5py's files (both file formats). The bytes
of the PNG and .flo5 files differ (the port writes filter 0 at zlib level
1, and its own HDF5 layout).
"""
import os

import cv2
import numpy as np
import pytest
from PIL import Image

import gd3d.data.flowio as J
import gd3d_torch.data.flowio as T


def test_pfm_and_flo_codecs_match_gd3d(tmp_path):
    rng = np.random.RandomState(0)
    disp = rng.rand(5, 4).astype(np.float32)
    disp[0, 0] = -1.0
    flow = rng.randn(7, 9, 2).astype(np.float32)
    for writer, reader in ((J, T), (T, J)):
        p = str(tmp_path / f"d_{writer.__name__}.pfm")
        writer.write_pfm(p, disp)
        np.testing.assert_array_equal(reader.read_pfm(p)[0], J.read_pfm(p)[0])
        np.testing.assert_array_equal(T.read_pfm_disp(p), J.read_pfm_disp(p))
        f3 = str(tmp_path / f"f_{writer.__name__}.pfm")
        writer.write_pfm(f3, np.concatenate([flow, np.zeros_like(flow[..., :1])], -1))
        np.testing.assert_array_equal(T.read_pfm_flow(f3), J.read_pfm_flow(f3))
        fl = str(tmp_path / f"f_{writer.__name__}.flo")
        writer.write_flo(fl, flow)
        np.testing.assert_array_equal(reader.read_flo(fl), flow)
    assert open(tmp_path / "f_gd3d.data.flowio.flo", "rb").read() == \
        open(tmp_path / "f_gd3d_torch.data.flowio.flo", "rb").read()


def test_kitti_codecs_match_gd3d(tmp_path):
    """Each package's files read back by both to gd3d's arrays, and the
    port's PNGs decode (cv2, PIL) to what gd3d's own files decode to."""
    rng = np.random.RandomState(1)
    disp = (rng.rand(6, 8) * 100).astype(np.float32)
    disp[1, 2] = np.inf
    flow = (rng.randn(6, 8, 2) * 10).astype(np.float32)
    flow[2, 3] = np.inf
    jd, td = str(tmp_path / "jd.png"), str(tmp_path / "td.png")
    jf, tf = str(tmp_path / "jf.png"), str(tmp_path / "tf.png")
    J.write_kitti_disp(jd, disp)
    T.write_kitti_disp(td, disp)
    J.write_kitti_flow(jf, flow)
    T.write_kitti_flow(tf, flow)
    np.testing.assert_array_equal(np.asarray(Image.open(td)), np.asarray(Image.open(jd)))
    flags = cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR
    np.testing.assert_array_equal(cv2.imread(tf, flags), cv2.imread(jf, flags))
    for path in (jd, td):
        np.testing.assert_array_equal(T.read_kitti_disp(path), J.read_kitti_disp(path))
        np.testing.assert_array_equal(T.read_gt(path, "stereo"), J.read_gt(path, "stereo"))
    for path in (jf, tf):
        np.testing.assert_array_equal(T.read_kitti_flow(path), J.read_kitti_flow(path))
        np.testing.assert_array_equal(T.read_gt(path, "flow"), J.read_gt(path, "flow"))
    np.testing.assert_array_equal(T.read_crestereo_disp(jd), J.read_crestereo_disp(jd))
    _hdf5_matches_gd3d(tmp_path, "latest", flow)


def _hdf5_matches_gd3d(tmp_path, libver, flow, chunks=True):
    """The HDF5 readers (NaN -> +inf) and read_gt's .h5 / .hdf5 / .flo5
    dispatch equal gd3d's on h5py's files; write_flo5's files read back
    equal through h5py, gd3d and the port."""
    import h5py

    disp = (np.random.RandomState(3).rand(*flow.shape[:2]) * 50).astype(np.float32)
    disp[0, :3] = np.nan
    flow = flow.copy()
    flow[1, 1] = np.nan
    kw = dict(compression="gzip", compression_opts=5) if chunks else {}
    for ext in (".h5", ".hdf5"):
        p = str(tmp_path / f"d_{libver}{ext}")
        with h5py.File(p, "w", libver=libver) as f:
            f.create_dataset("disparity", data=disp, **kw)
        np.testing.assert_array_equal(T.read_hdf5_disp(p), J.read_hdf5_disp(p))
        np.testing.assert_array_equal(T.read_gt(p, "stereo"), J.read_gt(p, "stereo"))
    for ext in (".h5", ".hdf5", ".flo5"):
        p = str(tmp_path / f"f_{libver}{ext}")
        with h5py.File(p, "w", libver=libver) as f:
            f.create_dataset("flow", data=flow, **kw)
        np.testing.assert_array_equal(T.read_hdf5_flow(p), J.read_hdf5_flow(p))
        np.testing.assert_array_equal(T.read_gt(p, "flow"), J.read_gt(p, "flow"))
    for writer in (T, J):
        p = str(tmp_path / f"w_{writer.__name__}.flo5")
        writer.write_flo5(p, flow)
        with h5py.File(p) as f:
            np.testing.assert_array_equal(np.asarray(f["flow"]), flow)
            assert f["flow"].compression == "gzip" and f["flow"].compression_opts == 5
        np.testing.assert_array_equal(T.read_hdf5_flow(p), J.read_hdf5_flow(p))


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("chunks", [False, True])
def test_hdf5_codecs_match_gd3d(tmp_path, libver, chunks):
    flow = (np.random.RandomState(4).randn(33, 47, 2) * 10).astype(np.float32)
    _hdf5_matches_gd3d(tmp_path, libver, flow, chunks)


def test_hdf5_refusals_name_the_file(tmp_path):
    """An lzf-compressed flow and a file that is no HDF5 at all."""
    import h5py

    p = str(tmp_path / "lzf.flo5")
    with h5py.File(p, "w") as f:
        f.create_dataset("flow", data=np.zeros((4, 5, 2), np.float32), compression="lzf")
    with pytest.raises(ValueError, match="lzf.flo5.*lzf filter"):
        T.read_gt(p, "flow")
    bad = tmp_path / "x.h5"
    bad.write_bytes(b"not hdf5")
    with pytest.raises(ValueError, match="x.h5"):
        T.read_hdf5_disp(str(bad))


def test_read_img_matches_gd3d(tmp_path):
    rng = np.random.RandomState(2)
    rgb = rng.randint(0, 256, (9, 11, 3), np.uint8)
    rgba = rng.randint(0, 256, (9, 11, 4), np.uint8)
    Image.fromarray(rgb).save(tmp_path / "a.png")
    Image.fromarray(rgba).save(tmp_path / "b.png")
    Image.fromarray(rgb).save(tmp_path / "c.jpg", quality=90)
    for name in ("a.png", "b.png", "c.jpg"):
        np.testing.assert_array_equal(T.read_img(str(tmp_path / name)),
                                      J.read_img(str(tmp_path / name)))
    np.testing.assert_array_equal(T.img_to_array(rgb), J.img_to_array(rgb))


def test_visualizations_match_gd3d():
    table = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_INFERNO)
    np.testing.assert_array_equal(T._INFERNO, table[:, 0])
    rng = np.random.RandomState(3)
    disp = (rng.rand(20, 30) * 50).astype(np.float32)
    np.testing.assert_array_equal(T.vis_disparity(disp), J.vis_disparity(disp))
    np.testing.assert_array_equal(T.vis_disparity(disp, 5.0, 40.0),
                                  J.vis_disparity(disp, 5.0, 40.0))
    flow = (rng.randn(20, 30, 2) * 8).astype(np.float32)
    flow[0, 0] = 1e10
    flow[1, 1, 0] = np.nan
    for kw in ({}, {"maxflow": 4.0}, {"maxmaxflow": 3.0, "saturate": True}):
        np.testing.assert_array_equal(T.flow_to_color(flow, **kw), J.flow_to_color(flow, **kw))


def test_color_ops_match_gd3d():
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (33, 70, 3)).astype(np.float32)
    for f in (-0.1, -0.02, 0.05, 0.159):
        np.testing.assert_array_equal(T.adjust_hue(img, f), J.adjust_hue(img, f))
    for name, v in (("adjust_brightness", 1.3), ("adjust_contrast", 0.8),
                    ("adjust_saturation", 1.2), ("adjust_gamma", 0.9)):
        np.testing.assert_array_equal(getattr(T, name)(img, v), getattr(J, name)(img, v))


@pytest.mark.parametrize("shape", [(120, 181, 3), (97, 64, 2), (50, 77)])
def test_resize_matches_cv2(shape):
    """uint8 images of any channel count; float32 INTER_LINEAR at 2
    channels (a dense flow: OpenCV computes other counts another way, and
    resize_cv refuses them) and INTER_NEAREST at any count."""
    rng = np.random.RandomState(5)
    u8 = rng.randint(0, 256, shape, np.uint8)
    f32 = (rng.randn(*shape) * 7).astype(np.float32)
    linear = (u8, f32) if shape[-1] == 2 else (u8,)
    if shape[-1] != 2:
        with pytest.raises(ValueError, match="not reproduced"):
            T.resize_cv(f32, 1.3, 0.9)
    scales = [(2.0 ** rng.uniform(-0.2, 0.5), 1.0) for _ in range(4)]
    scales += [(2.0 ** rng.uniform(-0.2, 0.5), 2.0 ** rng.uniform(-0.2, 0.5)) for _ in range(4)]
    scales += [(1.0, 1.0), (0.51, 0.73), (3.3, 2.1)]
    for fx, fy in scales:
        for img in linear:
            want = cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
            got = T.resize_cv(img, fx, fy)
            np.testing.assert_array_equal(got.reshape(want.shape), want, err_msg=f"{fx} {fy}")
        want = cv2.resize(f32, None, fx=fx, fy=fy, interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(T.resize_cv(f32, fx, fy, nearest=True).reshape(
            want.shape), want)


def _pair(rng, h, w):
    return (rng.randint(0, 256, (h, w, 3), np.uint8), rng.randint(0, 256, (h, w, 3), np.uint8))


@pytest.mark.parametrize("seed", range(6))
def test_augmentors_match_gd3d(seed):
    """The same outputs and the same RandomState afterwards; large frames
    (above lhth) for the stereo augmentor's other scale range, and sparse
    flow (+inf holes) for the flow augmentor's other resize."""
    rng = np.random.RandomState(100 + seed)
    h, w = (120, 180) if seed % 2 else (820, 900)
    img1, img2 = _pair(rng, h, w)
    disp = (rng.rand(h, w) * 10).astype(np.float32)
    got = T.StereoAugmentor((64, 96), rng=np.random.RandomState(seed))
    want = J.StereoAugmentor((64, 96), rng=np.random.RandomState(seed))
    for g, x in zip(got(img1, img2, disp), want(img1, img2, disp)):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)
    assert got.rng.randint(1 << 30) == want.rng.randint(1 << 30)

    img1, img2 = _pair(rng, 120, 180)
    flow = (rng.randn(120, 180, 2) * 4).astype(np.float32)
    if seed >= 3:
        flow[::3, ::2] = np.inf
    got = T.FlowAugmentor((64, 96), rng=np.random.RandomState(seed))
    want = J.FlowAugmentor((64, 96), rng=np.random.RandomState(seed))
    for dname in ("", "Spring"):
        for g, x in zip(got(img1, img2, flow, dname), want(img1, img2, flow, dname)):
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(g, x)
    assert got.rng.randint(1 << 30) == want.rng.randint(1 << 30)


def _png(path, arr):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


def write_layouts(root):
    """One small tree per layout, with frames lacking a partner or a gt."""
    img = np.zeros((8, 8, 3), np.uint8)
    d16 = np.full((8, 8), 256, np.uint16)
    # generic
    for sub, stems in (("left", "abc"), ("right", "ab"), ("gt", "a")):
        for s in stems:
            _png(root / "generic" / sub / f"{s}.png", img)
    # sceneflow
    for pas in ("frames_finalpass", "frames_cleanpass"):
        for side in ("left", "right"):
            _png(root / "sceneflow" / pas / "TRAIN" / "A" / "0000" / side / "0006.png", img)
    (root / "sceneflow" / "disparity" / "TRAIN" / "A" / "0000" / "left").mkdir(parents=True)
    J.write_pfm(str(root / "sceneflow" / "disparity" / "TRAIN" / "A" / "0000" / "left"
                    / "0006.pfm"), np.ones((8, 8), np.float32))
    # kitti15, both tasks and splits
    for split in ("training", "testing"):
        k = root / "kitti15" / split
        for stem in ("000000_10", "000000_11", "000001_10"):
            _png(k / "image_2" / f"{stem}.png", img)
        _png(k / "image_3" / "000000_10.png", img)
        _png(k / "disp_occ_0" / "000000_10.png", d16)
        _png(k / "flow_occ" / "000000_10.png", img)
    # sintel
    for render in ("clean", "final"):
        for k in (1, 2, 3):
            _png(root / "sintel" / "training" / render / "alley_1" / f"frame_{k:04d}.png", img)
    (root / "sintel" / "training" / "flow" / "alley_1").mkdir(parents=True)
    J.write_flo(str(root / "sintel" / "training" / "flow" / "alley_1" / "frame_0001.flo"),
                np.zeros((8, 8, 2), np.float32))
    # eth3d, middlebury
    for scene in ("s1", "s2"):
        _png(root / "eth3d" / "two_view_training" / scene / "im0.png", img)
        _png(root / "eth3d" / "two_view_training" / scene / "im1.png", img)
        _png(root / "middlebury" / scene / "im0.png", img)
        _png(root / "middlebury" / scene / "im1.png", img)
    J.write_pfm(str(root / "eth3d" / "two_view_training" / "s1" / "disp0GT.pfm"),
                np.ones((8, 8), np.float32))
    J.write_pfm(str(root / "middlebury" / "s2" / "disp0.pfm"), np.ones((8, 8), np.float32))


def test_discover_pairs_and_items_match_gd3d(tmp_path):
    write_layouts(tmp_path)
    n = 0
    for layout in ("generic", "sceneflow", "kitti15", "sintel", "eth3d", "middlebury"):
        for task in ("stereo", "flow"):
            for split in ("train", "test"):
                root = str(tmp_path / layout)
                got = T.discover_pairs(root, layout, task, split)
                assert got == J.discover_pairs(root, layout, task, split), (layout, task)
                n += len(got)
                ds, jds = (T.StereoFlowPairs(got, task, root=root),
                           J.StereoFlowPairs(got, task, root=root))
                for i in range(len(ds)):
                    try:
                        jitem = jds[i]
                    except (ValueError, IndexError) as e:  # a flow file as a disparity, or
                        with pytest.raises(type(e)):         # the reverse: both refuse it
                            ds[i]
                        continue
                    item = ds[i]
                    assert item.keys() == jitem.keys()
                    for k in item:
                        np.testing.assert_array_equal(item[k], jitem[k])
    assert n > 20
    with pytest.raises(ValueError, match="layout"):
        T.discover_pairs(str(tmp_path), "nope", "stereo")
    assert {T.StereoFlowPairs(T.discover_pairs(str(tmp_path / "middlebury"), "middlebury",
                                               "stereo"), "stereo",
                              root=str(tmp_path / "middlebury"))[i]["name"]
            for i in range(2)} == {"s1_im0", "s2_im0"}


@pytest.mark.parametrize("task", ["stereo", "flow"])
def test_training_items_match_gd3d(tmp_path, task):
    """StereoFlowPairs with a crop: the augmentor's items, as gd3d's."""
    rng = np.random.RandomState(9)
    root = tmp_path / "tree"
    for i in range(2):
        a, b = _pair(rng, 100, 150)
        _png(root / "left" / f"p{i}.png", a)
        _png(root / "right" / f"p{i}.png", b)
        gt = (rng.rand(100, 150) * 20 + 1 if task == "stereo"
              else rng.randn(100, 150, 2) * 5).astype(np.float32)
        os.makedirs(root / "gt", exist_ok=True)
        np.save(root / "gt" / f"p{i}.npy", gt)
    pairs = T.discover_pairs(str(root), "generic", task)
    got = T.StereoFlowPairs(pairs, task, crop_size=(64, 96), seed=3)
    want = J.StereoFlowPairs(pairs, task, crop_size=(64, 96), seed=3)
    for idx in (0, 1, 0):
        g, w = got[idx], want[idx]
        for k in ("img1", "img2", "gt"):
            np.testing.assert_array_equal(g[k], w[k])
