"""The port's TSDF refinement (gd3d_torch/tsdf.py) against gd3d's on the
CPU, on gd3d's plane scene (tests/test_tsdf.py: 4 posed 8x8 views of the
world plane z = 3), with gd3d's jax.random candidate draws fed to the
port's `offset_draw` (a key per image, folded in per iteration, as gd3d
draws them).

Tolerance: the refined depths within 1e-5 of gd3d's (both keep one of the
same fp32 candidates, or the input depth, per pixel: measured equal bits),
the recomputed points 1e-5 of their largest value. Then gd3d's two property
cases on the port's own draws: a corrupted view is pulled back toward the
surface, consistent depths stay on it.
"""
import jax
import numpy as np
import pytest
import torch

from gd3d.tsdf import tsdf_refine as jtsdf_refine
from gd3d_torch import tsdf as T
from tests.test_global_align import H, W
from tests.test_torch_align import port_scene
from tests.test_tsdf import _gt_out, _plane_scene


def gd3d_draw(shape, seed, image, it, device):
    key = jax.random.key(seed + image)
    for j in range(it):
        key = jax.random.fold_in(key, j)
    return torch.from_numpy(np.array(jax.random.normal(key, shape))).to(device)


@pytest.mark.parametrize("thresh,nsamples,niter,seed,noise", [
    (0.4, 64, 1, 1, 0.15), (0.3, 32, 2, 0, 0.0), (0.2, 16, 3, 5, 0.3)])
def test_tsdf_refine_matches_gd3d(monkeypatch, thresh, nsamples, niter, seed, noise):
    monkeypatch.setattr(T, "offset_draw", gd3d_draw)
    scene, poses, depths = _plane_scene()
    out = _gt_out(poses, depths)
    noisy = np.asarray(out["depthmaps"]).copy()
    noisy[0] += (noise * np.random.RandomState(0).randn(H, W)).astype(np.float32)
    out["depthmaps"] = noisy
    want = jtsdf_refine(scene, out, thresh=thresh, nsamples=nsamples, niter=niter, seed=seed,
                        chunk=1000)
    got = T.tsdf_refine(port_scene(scene), out, thresh=thresh, nsamples=nsamples, niter=niter,
                        seed=seed, chunk=1000)
    assert got["depthmaps"].shape == (4, H, W) and got["pts3d"].shape == (4, H, W, 3)
    np.testing.assert_allclose(got["depthmaps"].numpy(), np.asarray(want["depthmaps"]),
                               rtol=0, atol=1e-5)
    pts, wpts = got["pts3d"].numpy(), np.asarray(want["pts3d"])
    assert np.abs(pts - wpts).max() <= 1e-5 * np.abs(wpts).max()


def test_tsdf_chunk_size_changes_nothing():
    scene, poses, depths = _plane_scene()
    ts = port_scene(scene)
    a = T.tsdf_refine(ts, _gt_out(poses, depths), thresh=0.3, nsamples=16, chunk=100)
    b = T.tsdf_refine(ts, _gt_out(poses, depths), thresh=0.3, nsamples=16, chunk=16384)
    assert torch.equal(a["depthmaps"], b["depthmaps"])


def test_tsdf_refine_pulls_corrupted_depths_back():
    """gd3d's first property case, on the port's own draws."""
    scene, poses, depths = _plane_scene()
    out = _gt_out(poses, depths)
    noisy = np.asarray(out["depthmaps"]).copy()
    noisy[0] = noisy[0] + 0.15 * np.random.RandomState(0).randn(H, W).astype(np.float32)
    out["depthmaps"] = noisy
    got = T.tsdf_refine(port_scene(scene), out, thresh=0.4, nsamples=256, seed=1,
                        chunk=4096)["depthmaps"].numpy()
    err_before = np.abs(noisy[0] - depths[0]).mean()
    err_after = np.abs(got[0] - depths[0]).mean()
    assert err_after < 0.6 * err_before, (err_before, err_after)


def test_tsdf_refine_keeps_consistent_depths():
    """gd3d's second property case, on the port's own draws."""
    scene, poses, depths = _plane_scene()
    got = T.tsdf_refine(port_scene(scene), _gt_out(poses, depths), thresh=0.3, nsamples=128,
                        seed=0, chunk=4096)["depthmaps"].numpy()
    assert np.abs(got - depths).mean() < 0.05, np.abs(got - depths).mean()


def test_offset_draws_are_standard_normal():
    x = T.offset_draw((100_000,), 0, 1, 0, "cpu")
    assert abs(float(x.mean())) < 0.02 and abs(float(x.std()) - 1) < 0.02
    assert not torch.equal(x, T.offset_draw((100_000,), 0, 1, 1, "cpu"))
    assert not torch.equal(x, T.offset_draw((100_000,), 0, 2, 0, "cpu"))
