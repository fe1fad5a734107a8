"""The port's scene-graph pair maker (gd3d_torch/data/scene_graph.py)
against gd3d's make_pair_indices: the same (i, j) sequence, element for
element, for every strategy, symmetrization and prefilter, and the same
errors. Both are pure stdlib; exact equality."""
import pytest

from gd3d.data.scene_graph import make_pair_indices as jmake
from gd3d_torch.data.scene_graph import make_pair_indices

GRAPHS = ["complete", "swin", "swin-1", "swin-2", "swin-3", "swin-2-noncyclic", "swin-x",
          "logwin", "logwin-2", "logwin-3", "logwin-2-noncyclic", "oneref", "oneref-0",
          "oneref-1"]


@pytest.mark.parametrize("scene_graph", GRAPHS)
@pytest.mark.parametrize("n,symmetrize", [(2, True), (3, False), (5, True), (8, False),
                                          (9, True)])
def test_pair_indices_match_gd3d(scene_graph, n, symmetrize):
    assert make_pair_indices(n, scene_graph, symmetrize=symmetrize) == jmake(
        n, scene_graph, symmetrize=symmetrize)


@pytest.mark.parametrize("prefilter", ["seq1", "seq2", "seq3", "cyc1", "cyc2", "cyc3"])
@pytest.mark.parametrize("scene_graph", ["complete", "swin-3", "logwin-3-noncyclic",
                                         "oneref-2"])
def test_prefilter_matches_gd3d(scene_graph, prefilter):
    for n in (4, 7):
        assert make_pair_indices(n, scene_graph, prefilter=prefilter) == jmake(
            n, scene_graph, prefilter=prefilter)


@pytest.mark.parametrize("args", [(4, "nope"), (4, "complete", "bogus9"), (5, "oneref-9")])
def test_errors_match_gd3d(args):
    with pytest.raises(ValueError) as want:
        jmake(*args)
    with pytest.raises(ValueError) as got:
        make_pair_indices(*args)
    assert str(got.value) == str(want.value)


def test_empty_graph_with_prefilter_returns_empty():
    assert make_pair_indices(1, "complete", prefilter="seq1") == [] == jmake(
        1, "complete", prefilter="seq1")
