"""Keypoint pipeline of gd3d_torch against gd3d, on the CPU.

Keypoints and validity masks must be EXACTLY equal. The descriptors come
from a seed whose top-2 similarity margin, over every row in both matching
directions, exceeds 1e-5, so that fp32 sums taken in another order cannot
flip an argmax; the tests assert that margin.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gd3d.distill import keypoints as jk
from gd3d_torch.distill import keypoints as tk

H, W, D, S = 32, 48, 6, 8
SEED = 13  # margin 3.4e-5 (seed 0 has 1.7e-6)


def _descs(seed):
    rng = np.random.RandomState(seed)
    d1 = rng.randn(H, W, D).astype(np.float32)
    d2 = (d1.reshape(-1, D)[rng.permutation(H * W)].reshape(H, W, D)
          + 0.3 * rng.randn(H, W, D)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    conf1 = rng.uniform(1.0, 3.0, size=(H, W)).astype(np.float32)
    conf2 = rng.uniform(1.0, 3.0, size=(H, W)).astype(np.float32)
    return d1, d2, conf1, conf2


def _top2_margin(a, b):
    sim = a.reshape(-1, D).astype(np.float64) @ b.reshape(-1, D).astype(np.float64).T
    top = np.sort(sim, axis=1)[:, -2:]
    return float((top[:, 1] - top[:, 0]).min())


def test_seed_has_argmax_margin():
    d1, d2, _, _ = _descs(SEED)
    assert min(_top2_margin(d1, d2), _top2_margin(d2, d1)) > 1e-5


@pytest.mark.parametrize("block", [8192, 100])
def test_blockwise_argmax_dot(block):
    d1, d2, _, _ = _descs(SEED)
    q, db = d1.reshape(-1, D)[::7], d2.reshape(-1, D)
    got = tk.blockwise_argmax_dot(torch.from_numpy(q), torch.from_numpy(db), block)
    want = jk.blockwise_argmax_dot(jnp.asarray(q), jnp.asarray(db), block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_argmax_ties_break_to_lowest_index():
    q = np.ones((1, 2), np.float32)
    db = np.ones((300, 2), np.float32)
    for block in (8192, 64):
        assert int(tk.blockwise_argmax_dot(torch.from_numpy(q), torch.from_numpy(db),
                                           block)[0]) == 0


def test_reciprocal_nn_grid():
    d1, d2, _, _ = _descs(SEED)
    got = tk.reciprocal_nn_grid(torch.from_numpy(d1), torch.from_numpy(d2), H, W, S)
    want = jk.reciprocal_nn_grid(jnp.asarray(d1), jnp.asarray(d2), H, W, S)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[2].sum()) > 0


def test_merge_corres_static_duplicates():
    rng = np.random.RandomState(1)
    xy1 = rng.randint(0, 6, size=40).astype(np.int32)
    xy2 = rng.randint(0, 6, size=40).astype(np.int32)
    valid = rng.rand(40) > 0.3
    got = tk.merge_corres_static(torch.from_numpy(xy1).long(), torch.from_numpy(xy2).long(),
                                 torch.from_numpy(valid), 36)
    want = jk.merge_corres_static(jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(valid),
                                  36, 36)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_filter_and_match_keypoints():
    d1, d2, c1, c2 = _descs(SEED)
    feats_t = {"desc_1": d1, "desc_2": d2, "conf_1": c1, "conf_2": c2}
    got = tk.filter_and_match_keypoints(
        {k: torch.from_numpy(v) for k, v in feats_t.items()}, H, W, subsample=S)
    want = jk.filter_and_match_keypoints(
        {k: jnp.asarray(v) for k, v in feats_t.items()}, H, W, subsample=S)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[2].sum()) > 0
