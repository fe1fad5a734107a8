"""The port's BlendedMVS, StaticThings3D and MegaDepth preprocessing
(gd3d_torch/data/preprocess_mvs.py) against gd3d's on the fabricated raw
trees of gd3d_torch/data/fixtures.py: the same trees (JPEG bytes at
quality 80, the .exr.npy depth siblings), the committed digests, the
readers' views; the PFM, .float3 and camera readers bit for bit; and
MegaDepth's HDF5 depth, read as h5py reads it, both as the port's writer
writes it and as h5py does; an .h5 in a filter the port does not decode
(lzf) is refused with a ValueError naming it."""
import numpy as np
import pytest

import gd3d.data.preprocess_mvs as J
import gd3d_torch.data.preprocess_mvs as T
from gd3d_torch.cli.preprocess import main as port_main
from gd3d_torch.data import fixtures
from tests.torch_datagen import (assert_trees_equal, assert_views_equal, committed,
                                 preprocess_both)


@pytest.fixture(scope="module", params=["blendedmvs", "staticthings3d", "megadepth"])
def trees(request, tmp_path_factory):
    return (request.param,) + preprocess_both(request.param, tmp_path_factory.mktemp("t"))


def test_tree_equals_gd3d_and_committed_digests(trees):
    dataset, gd3d_tree, port_tree = trees
    assert assert_trees_equal(gd3d_tree, port_tree) == committed()["preprocess"][dataset]


def test_views_equal_gd3d(trees):
    assert_views_equal(*trees)


def test_readers_equal_gd3d(tmp_path):
    fixtures.write_raw_blendedmvs(tmp_path / "b")
    seq = next((tmp_path / "b" / "raw").iterdir())
    pfm = str(seq / "rendered_depth_maps" / "00000001.pfm")
    np.testing.assert_array_equal(T.load_pfm(pfm), J.load_pfm(pfm))
    cam = str(seq / "cams" / "00000001_cam.txt")
    for g, w in zip(T.load_blendedmvs_cam(cam), J.load_blendedmvs_cam(cam)):
        np.testing.assert_array_equal(g, w)
    d = np.random.RandomState(0).rand(5, 7).astype(np.float32)
    fixtures._float3(tmp_path / "d.float3", d)
    np.testing.assert_array_equal(T.read_float3(str(tmp_path / "d.float3")), d)
    fixtures.write_raw_megadepth(tmp_path / "m")
    got, want = (m.load_megadepth_sfm(str(tmp_path / "m" / "raw"), "0001", "0") for m in (T, J))
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k])
        assert got[1][k][0] == want[1][k][0] and got[1][k][2] == want[1][k][2]
        np.testing.assert_array_equal(got[1][k][1], want[1][k][1])


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_megadepth_image_equals_gd3d_on_h5py_depth(tmp_path, libver):
    """process_megadepth_image on depth that h5py wrote (gzip-chunked, at
    both file formats) gives gd3d's files."""
    import h5py

    fixtures.write_raw_megadepth(tmp_path / "m")
    raw = tmp_path / "m" / "raw"
    poses, intrinsics = T.load_megadepth_sfm(str(raw), "0001", "0")
    in_dir = raw / "0001" / "dense0"
    for tag in ("im_a.jpg", "im_b.jpg"):
        h5 = in_dir / "depths" / (tag[:-4] + ".h5")
        depth = np.asarray(h5py.File(h5)["depth"])
        with h5py.File(h5, "w", libver=libver) as f:
            f.create_dataset("depth", data=depth, compression="gzip", chunks=(16, 32))
        outs = []
        for m, name in ((T, "port"), (J, "gd3d")):
            out = tmp_path / name / libver
            out.mkdir(parents=True, exist_ok=True)
            m.process_megadepth_image(str(in_dir), tag, intrinsics[tag], poses[tag], str(out))
            outs.append(out)
        assert assert_trees_equal(outs[1], outs[0])


def test_megadepth_refuses_its_h5_by_name(tmp_path):
    """An lzf-compressed depth .h5 (a filter data/hdf5.py does not decode)
    is refused, naming the file and the filter, before any output."""
    import h5py

    spec = fixtures.write_raw_tree("megadepth", tmp_path / "raw")
    h5 = tmp_path / "raw" / "raw" / "0001" / "dense0" / "depths" / "im_a.h5"
    assert h5.read_bytes().startswith(fixtures.HDF5_SIGNATURE)
    depth = np.asarray(h5py.File(h5)["depth"])
    with h5py.File(h5, "w") as f:
        f.create_dataset("depth", data=depth, compression="lzf")
    with pytest.raises(ValueError, match=str(h5)) as err:
        port_main(fixtures.preprocess_argv("megadepth", spec, tmp_path / "out"))
    assert "lzf" in str(err.value)
    assert not list((tmp_path / "out").rglob("*.npz"))
