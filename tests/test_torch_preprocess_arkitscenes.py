"""The port's ARKitScenes preprocessing (gd3d_torch/data/
preprocess_arkitscenes.py) against gd3d's on the fabricated raw scene of
gd3d_torch/data/fixtures.py (a device held sideways: sky RIGHT, so every
frame is turned upright): the same tree (JPEG bytes at quality 75, the
nearest-exact depth), the committed digests, the readers' views; the
trajectory reader, SQUAD and the sky detector equal gd3d's bit for bit."""
import numpy as np
import pytest

import gd3d.data.preprocess_arkitscenes as J
import gd3d_torch.data.preprocess_arkitscenes as T
from gd3d_torch.data import fixtures
from tests.torch_datagen import (assert_trees_equal, assert_views_equal, committed,
                                 preprocess_both)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return ("arkitscenes",) + preprocess_both("arkitscenes", tmp_path_factory.mktemp("t"))


def test_tree_equals_gd3d_and_committed_digests(trees):
    dataset, gd3d_tree, port_tree = trees
    assert assert_trees_equal(gd3d_tree, port_tree) == committed()["preprocess"][dataset]
    from gd3d_torch.data.jpeg import jpeg_size

    jpg = next((port_tree / "Training").rglob("*.jpg"))
    assert jpeg_size(str(jpg)) == (72, 96)  # the 96x72 frames, upright


def test_views_equal_gd3d(trees):
    assert_views_equal(*trees)


def test_trajectory_and_orientation_equal_gd3d(tmp_path):
    fixtures.write_raw_arkitscenes(tmp_path)
    traj = str(tmp_path / "Training" / "41069021" / "lowres_wide.traj")
    got, want = T.read_traj(traj), J.read_traj(traj)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    q = T.unflip_rotors(got[2])
    np.testing.assert_array_equal(q, J.unflip_rotors(want[2]))
    t_eval = np.linspace(got[0][0], got[0][-1], 7)
    np.testing.assert_array_equal(T.squad(q, got[0], t_eval), J.squad(q, want[0], t_eval))
    sky_t, rot_t = T.find_scene_orientation(got[3])
    sky_j, rot_j = J.find_scene_orientation(want[3])
    assert sky_t == sky_j == "RIGHT"
    np.testing.assert_array_equal(rot_t, rot_j)
