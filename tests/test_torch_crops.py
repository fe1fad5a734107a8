"""The port's coarse-to-fine crop planning (gd3d_torch/crops.py) against
gd3d's crops.py on seeded correspondences: every function's output equal
element for element (both are the same numpy)."""
import numpy as np
import pytest

from gd3d import crops as J
from gd3d_torch import crops as T


def _rand_corres(rng, n, H1, W1, H2, W2):
    """Clustered correspondences: an affine map + noise, clipped inside."""
    p1 = rng.rand(n, 2) * (W1 * 0.8, H1 * 0.8) + (W1 * 0.1, H1 * 0.1)
    A = np.array([[0.7, 0.05], [-0.04, 0.65]])
    p2 = p1 @ A.T + (W2 * 0.15, H2 * 0.2) + rng.randn(n, 2) * 3
    p2 = np.clip(p2, 0, (W2 - 1, H2 - 1))
    return p1.astype(np.float32), p2.astype(np.float32)


@pytest.mark.parametrize("H,W,size,overlap", [(600, 900, 512, 0.5), (480, 640, 224, 0.3),
                                              (1168, 1752, 512, 0.5), (512, 384, 256, 0.0)])
def test_overlapping_grid_matches_gd3d(H, W, size, overlap):
    np.testing.assert_array_equal(T.overlapping_grid(H, W, size, overlap),
                                  J.overlapping_grid(H, W, size, overlap))


@pytest.mark.parametrize("forced", [None, (384, 512), (96, 128)])
def test_norm_windows_matches_gd3d(forced):
    rng = np.random.RandomState(1)
    lt = rng.rand(30, 2) * 300
    cells = np.c_[lt, lt + 50 + rng.rand(30, 2) * 450]
    np.testing.assert_array_equal(T.norm_windows(cells, 480, 640, forced),
                                  J.norm_windows(cells, 480, 640, forced))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_cells_and_greedy_cover_match_gd3d(seed):
    rng = np.random.RandomState(seed)
    p1, p2 = _rand_corres(rng, 300, 480, 640, 400, 600)
    grid = J.norm_windows(J.overlapping_grid(480, 640, 256, 0.5), 480, 640)
    want = J.score_cells(grid, 400, 600, p1, p2, 10, None)
    got = T.score_cells(grid, 400, 600, p1, p2, 10, None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for target, cap in ((0.9, 64), (0.5, 3), (1.0, 64)):
        assert T.greedy_cover(want[2], target, cap) == J.greedy_cover(want[2], target, cap)


@pytest.mark.parametrize("forced", [None, (192, 256), ((192, 256), (160, 224))])
@pytest.mark.parametrize("seed,n,shapes", [(0, 200, ((480, 640), (400, 600))),
                                           (3, 60, ((384, 512), (384, 512))),
                                           (5, 5, ((384, 512), (384, 512)))])
def test_select_crop_pairs_matches_gd3d(forced, seed, n, shapes):
    rng = np.random.RandomState(seed)
    (H1, W1), (H2, W2) = shapes
    p1, p2 = _rand_corres(rng, n, H1, W1, H2, W2)
    kw = dict(maxdim=256, forced_resolution=forced, max_pairs=8)
    got = T.select_crop_pairs((H1, W1, 3), (H2, W2, 3), p1, p2, **kw)
    want = J.select_crop_pairs((H1, W1, 3), (H2, W2, 3), p1, p2, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
