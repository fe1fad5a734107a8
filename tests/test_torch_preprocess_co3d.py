"""The port's Co3D-v2 and WildRGB-D preprocessing (gd3d_torch/cli/
preprocess.py) against gd3d's (gd3d/cli/preprocess.py) on the fabricated
raw trees of gd3d_torch/data/fixtures.py: the same tree (files; JSON,
.npz and .npy contents; PNG pixels; JPEG bytes, hence PIL's pixels), the
committed digests that chip_smoke.py checks, and the views and pretraining
batch of the port's reader on its tree equal to gd3d's on gd3d's; plus the
camera conversion and the depth PNG codecs. Tolerance: none."""
import numpy as np
import pytest

import gd3d.cli.preprocess as J
import gd3d_torch.cli.preprocess as T
from tests.torch_datagen import (assert_trees_equal, assert_views_equal, committed,
                                 preprocess_both)


@pytest.fixture(scope="module", params=["co3d", "wildrgbd"])
def trees(request, tmp_path_factory):
    return (request.param,) + preprocess_both(request.param, tmp_path_factory.mktemp("t"))


def test_tree_equals_gd3d_and_committed_digests(trees):
    dataset, gd3d_tree, port_tree = trees
    assert assert_trees_equal(gd3d_tree, port_tree) == committed()["preprocess"][dataset]


def test_views_equal_gd3d(trees):
    assert_views_equal(*trees)


def test_ndc_to_opencv_camera_equals_gd3d():
    rng = np.random.RandomState(0)
    for _ in range(5):
        args = (rng.randn(3, 3), rng.randn(3), rng.rand(2) + 0.5, rng.randn(2) * 0.1,
                [int(rng.randint(50, 200)), int(rng.randint(50, 200))])
        for g, w in zip(T.ndc_to_opencv_camera(*args), J.ndc_to_opencv_camera(*args)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_depth_png_codecs_equal_gd3d(tmp_path):
    arr = np.abs(np.random.RandomState(3).randn(11, 13)).astype(np.float16)
    T.write_png(str(tmp_path / "d.png"), arr.view(np.uint16))
    got = T.read_co3d_depth_png(str(tmp_path / "d.png"))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, J.read_co3d_depth_png(str(tmp_path / "d.png")))
    np.testing.assert_array_equal(got, arr.astype(np.float32))
    scaled = np.random.RandomState(4).rand(7, 9).astype(np.float32) * 65535
    T.write_u16_png(str(tmp_path / "t.png"), scaled)
    J.write_u16_png(str(tmp_path / "g.png"), scaled)
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "g.png")))


def test_wildrgbd_set_lists_equal_gd3d(tmp_path):
    from gd3d_torch.data import fixtures

    fixtures.write_raw_wildrgbd(tmp_path)
    for split in ("train", "test"):
        assert T.wildrgbd_set_list(str(tmp_path / "mug"), split) == \
            J.wildrgbd_set_list(str(tmp_path / "mug"), split)
