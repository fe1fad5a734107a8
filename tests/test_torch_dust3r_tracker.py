"""The port's DUSt3R/MASt3R point-matching tracker
(gd3d_torch/eval/dust3r_tracker.py) against gd3d's on the CPU, on the tiny
MASt3R config of tests/test_torch_models.py with one seeded gd3d init carried
into the port (gd3d_torch/convert.py::mast3r_state_dict):

- the pair forward's element 1 of the symmetrised batch (res1 pts3d and
  res2 pts3d_in_other_view) to 1e-4, so the port keeps gd3d's batch order;
- the tracks: the same shape, every position inside the frame, and the same
  pixel for all but the argmins whose two best distances lie within 1e-4 of
  each other (fp32 sums in another order may swap a near tie);
- the pair cache: one entry per (source, target) of the last call, cleared
  by the next call.
"""
import jax
import numpy as np
import pytest
import torch

from gd3d.eval.dust3r_tracker import Dust3rTracker as JDust3rTracker
from gd3d.models.croco import CrocoConfig as JCrocoConfig
from gd3d.models.mast3r import Mast3rConfig as JMast3rConfig
from gd3d.teachers.mast3r import Mast3rTeacher as JMast3rTeacher
from gd3d_torch.convert import mast3r_state_dict
from gd3d_torch.eval.dust3r_tracker import Dust3rTracker
from gd3d_torch.models.croco import CrocoConfig
from gd3d_torch.models.mast3r import Mast3rConfig
from gd3d_torch.teachers.mast3r import Mast3rTeacher

CROCO_KW = dict(patch_size=16, enc_embed_dim=32, enc_depth=2, enc_num_heads=2,
                dec_embed_dim=16, dec_depth=2, dec_num_heads=2)
MAST3R_KW = dict(local_feat_dim=6, dpt_feature_dim=32, dpt_last_dim=16)
H, W = 32, 64


@pytest.fixture(scope="module")
def trackers():
    jcfg = JMast3rConfig(croco=JCrocoConfig(**CROCO_KW), **MAST3R_KW)
    jteacher = JMast3rTeacher(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jteacher.init_params(jax.random.key(0), hw=(H, W)))
    cfg = Mast3rConfig(croco=CrocoConfig(**CROCO_KW), **MAST3R_KW)
    teacher = Mast3rTeacher(cfg)
    teacher.model.load_state_dict(mast3r_state_dict(params, cfg))
    teacher.eval()
    return JDust3rTracker(jteacher, params), Dust3rTracker(teacher)


def _frames(seed, T=3):
    return np.random.RandomState(seed).rand(T, H, W, 3).astype(np.float32)


def test_pair_points_match_gd3d(trackers):
    jtracker, tracker = trackers
    frames = _frames(0) * 2.0 - 1.0
    for src, tgt in ((0, 1), (2, 0), (1, 1)):
        want = jtracker._pair_pts(frames, src, tgt)
        got = tracker._pair_pts(torch.from_numpy(frames), src, tgt)
        for g, w in zip(got, want):
            assert g.shape == w.shape == (H, W, 3)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_tracks_match_gd3d(trackers, seed):
    jtracker, tracker = trackers
    frames = _frames(seed)
    rng = np.random.RandomState(10 + seed)
    q = np.column_stack([rng.randint(0, W, 12), rng.randint(0, H, 12),
                         rng.randint(0, 3, 12)]).astype(np.float32)
    want = jtracker.track(frames, q)
    got = tracker.track(frames, q)
    assert got.shape == want.shape == (12, 3, 2) and got.dtype == np.float32
    assert (got[..., 0] < W).all() and (got[..., 1] < H).all() and (got >= 0).all()
    differ = np.argwhere((got != want).any(-1))
    for n, t in differ:  # a near tie of the argmin, on gd3d's own distances
        pts1, pts2 = jtracker._cache[(int(round(q[n, 2])), int(t))]
        d = np.linalg.norm(pts2.reshape(-1, 3) - pts1[int(q[n, 1]), int(q[n, 0])], axis=-1)
        gi, wi = int(got[n, t, 1]) * W + int(got[n, t, 0]), int(want[n, t, 1]) * W + int(want[n, t, 0])
        assert abs(d[gi] - d[wi]) <= 1e-4 * max(1.0, d[wi]), (n, t, d[gi], d[wi])
    assert len(differ) <= 2  # of 36 positions; none differ at these seeds


def test_pair_cache_is_per_call(trackers):
    _, tracker = trackers
    q = np.array([[10, 12, 0], [30, 8, 1]], np.float32)
    tracker.track(_frames(3), q)
    assert sorted(tracker._cache) == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    tracker.track(_frames(4, T=2), q[:1])
    assert sorted(tracker._cache) == [(0, 0), (0, 1)]
