"""The port's Waymo preprocessing (gd3d_torch/data/preprocess_waymo.py)
against gd3d's on the fabricated .tfrecord of gd3d_torch/data/fixtures.py
(a FRONT camera and a TOP lidar whose returns land on a wall): the same
tree (JPEG bytes at quality 80, the lidar depth maps), the committed
digests, the readers' views; the record framing, the Frame parse and the
point cloud bit for bit."""
import numpy as np
import pytest

import gd3d.data.preprocess_waymo as J
import gd3d_torch.data.preprocess_waymo as T
from gd3d_torch.data import fixtures
from tests.torch_datagen import (assert_trees_equal, assert_views_equal, committed,
                                 preprocess_both)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return ("waymo",) + preprocess_both("waymo", tmp_path_factory.mktemp("t"))


def test_tree_equals_gd3d_and_committed_digests(trees):
    dataset, gd3d_tree, port_tree = trees
    assert assert_trees_equal(gd3d_tree, port_tree) == committed()["preprocess"][dataset]
    depth = np.load(port_tree / "segment-fabricated.tfrecord" / "00000_1.exr.npy")
    assert (depth > 0).sum() > 20  # lidar returns on the wall


def test_views_equal_gd3d(trees):
    assert_views_equal(*trees)


def test_frames_and_point_cloud_equal_gd3d(tmp_path):
    spec = fixtures.write_raw_waymo(tmp_path)
    path = str(spec["raw"] / "segment-fabricated.tfrecord")
    recs = list(T.read_tfrecords(path, verify_crc=True))
    assert recs == list(J.read_tfrecords(path, verify_crc=True)) and len(recs) == 2
    for rec in recs:
        pts_t, cp_t = T.frame_point_cloud(T.WaymoFrame(rec))
        pts_j, cp_j = J.frame_point_cloud(J.WaymoFrame(rec))
        np.testing.assert_array_equal(pts_t, pts_j)
        np.testing.assert_array_equal(cp_t, cp_j)
    assert T.crc32c(b"\x00" * 32) == 0x8A9136AA
