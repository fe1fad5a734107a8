"""The port's Habitat generator (gd3d_torch/data/preprocess_habitat.py)
against gd3d's: shaded, shadowed procedural scenes rendered by the port's
rasteriser and written as JPEG at quality 95 give gd3d's tree (JPEG bytes,
.exr.npy depth, camera JSON), the committed digests and the readers'
views; --habitat-sim errors with gd3d's recipe."""
import pytest

import gd3d.data.preprocess_habitat as J
from gd3d_torch.cli.preprocess import main as port_main
from tests.torch_datagen import (assert_trees_equal, assert_views_equal, committed,
                                 preprocess_both)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return ("habitat",) + preprocess_both("habitat", tmp_path_factory.mktemp("t"))


def test_tree_equals_gd3d_and_committed_digests(trees):
    dataset, gd3d_tree, port_tree = trees
    assert assert_trees_equal(gd3d_tree, port_tree) == committed()["preprocess"][dataset]


def test_views_equal_gd3d(trees):
    assert_views_equal(*trees)


def test_habitat_sim_errors_with_the_recipe(tmp_path):
    with pytest.raises(SystemExit) as e:
        port_main(["--dataset", "habitat", "--habitat-sim", "--output-dir", str(tmp_path)])
    assert str(e.value) == J.HABITAT_RECIPE
