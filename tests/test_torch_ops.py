"""gd3d_torch ops against their gd3d counterparts, fp32 on the CPU.

Inputs are built with numpy from a seed and fed to both packages.
Tolerance: 1e-5 (relative and absolute) for single ops, fp32 rounding of
the same formula evaluated in another order; exact where the op only
selects, gathers or counts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gd3d.models.student import resize_bilinear as jax_resize_bilinear
from gd3d.ops import basic as jb
from gd3d.ops import depth as jd
from gd3d.ops import geometry as jg
from gd3d.ops import interpolate as ji
from gd3d.ops import losses as jl
from gd3d.ops import masks as jm
from gd3d.ops import rope2d as jr
from gd3d_torch.models.student import resize_bilinear
from gd3d_torch.ops import basic as tb
from gd3d_torch.ops import depth as td
from gd3d_torch.ops import geometry as tg
from gd3d_torch.ops import interpolate as ti
from gd3d_torch.ops import losses as tl
from gd3d_torch.ops import masks as tm
from gd3d_torch.ops import rope2d as tr

TOL = dict(rtol=1e-5, atol=1e-5)


def close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **{**TOL, **kw})


def test_l2_normalize():
    x = np.random.RandomState(0).randn(4, 7, 5).astype(np.float32)
    x[0, 0] = 0.0  # the eps clamp
    for axis in (-1, 1):
        close(tb.l2_normalize(torch.from_numpy(x), axis=axis),
              jb.l2_normalize(jnp.asarray(x), axis=axis))


@pytest.mark.parametrize("k", [0, 1, 17, 63, 99])
def test_kth_smallest_with_ties(k):
    rng = np.random.RandomState(k)
    # few distinct values: many ties, mixed signs
    x = rng.randint(-3, 4, size=(10, 10)).astype(np.float32) * 0.5
    want = float(jb.kth_smallest(jnp.asarray(x), k))
    assert want == float(np.sort(x.reshape(-1))[k])
    assert float(tb.kth_smallest(torch.from_numpy(x), k)) == want


def test_rope2d_and_positions():
    rng = np.random.RandomState(1)
    tok = rng.randn(2, 3, 12, 16).astype(np.float32)
    pos_t = tr.grid_positions(3, 4, 2)
    pos_j = jr.grid_positions(3, 4, 2)
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    close(tr.rope2d(torch.from_numpy(tok), pos_t, 100.0),
          jr.rope2d_xla(jnp.asarray(tok), pos_j, 100.0))


def test_interpolate_features_border_and_inside():
    rng = np.random.RandomState(2)
    desc = rng.randn(2, 5, 6, 8).astype(np.float32)
    # in range, on patch centres, and outside the grid (border clamp)
    pts = rng.uniform(-20, 150, size=(2, 9, 2)).astype(np.float32)
    pts[:, 0] = [8.0, 8.0]
    close(ti.interpolate_features(torch.from_numpy(desc), torch.from_numpy(pts), 96, 128,
                                  normalize=False, patch_size=16, stride=16),
          ji.interpolate_features(jnp.asarray(desc), jnp.asarray(pts), 96, 128,
                                  normalize=False, patch_size=16, stride=16))


@pytest.mark.parametrize("src,dst", [((512, 512), (336, 512)), ((336, 512), (832, 1280)),
                                     ((64, 48), (40, 40))])
def test_resize_bilinear_antialiased(src, dst):
    """jax.image.resize antialiases when it downsamples; the port matches it
    with antialias=True (plain bilinear differs by up to 0.38 at 512->336).
    3e-5: the two libraries derive the tap weights by different fp32
    routines (scale-and-translate against the separable aa kernel)."""
    x = np.random.RandomState(3).rand(1, *src, 3).astype(np.float32)
    close(resize_bilinear(torch.from_numpy(x), dst),
          jax_resize_bilinear(jnp.asarray(x), dst), rtol=3e-5, atol=3e-5)


def test_patch_mask_and_masked_cost():
    rng = np.random.RandomState(4)
    H, W, ps = 64, 96, 16
    kp = rng.uniform(-5, 100, size=(30, 2)).astype(np.float32)
    valid = rng.rand(30) > 0.3
    m_t = tm.patch_mask_from_kps(torch.from_numpy(kp), H, W, ps, torch.from_numpy(valid))
    m_j = jm.patch_mask_from_kps(jnp.asarray(kp), H, W, ps, jnp.asarray(valid))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert 0 < int(m_t.sum()) < m_t.numel()
    cost = rng.rand(1, 24, 24).astype(np.float32)
    close(tm.masked_patch_cost(torch.from_numpy(cost), m_t),
          jm.masked_patch_cost(jnp.asarray(cost), m_j))
    # a zeroed row normalizes to all zeros (sum clamped at eps)
    out = tm.masked_patch_cost(torch.from_numpy(cost), m_t)
    assert float(out[0][~m_t].abs().max()) == 0.0


def test_losses():
    rng = np.random.RandomState(5)
    B, N, C = 2, 12, 8
    d1 = rng.randn(B, N, C).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = d1 + 0.1 * rng.randn(B, N, C).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    p1 = rng.rand(B, N, 3).astype(np.float32)
    p2 = p1 + 0.05 * rng.randn(B, N, 3).astype(np.float32)
    valid = rng.rand(B, N) > 0.2
    T = [torch.from_numpy(a) for a in (d1, d2, p1, p2, valid)]
    J = [jnp.asarray(a) for a in (d1, d2, p1, p2, valid)]
    close(tl.ap_loss_paired(*T), jl.ap_loss_paired(*J))
    score = np.tanh(rng.randn(B, N, N)).astype(np.float32)
    depth = rng.rand(B, N).astype(np.float32)
    close(tl.pairwise_logistic_ranking_loss(torch.from_numpy(score), torch.from_numpy(depth),
                                            0.05, T[4]),
          jl.pairwise_logistic_ranking_loss(jnp.asarray(score), jnp.asarray(depth), 0.05, J[4]))
    x = rng.randn(B, N).astype(np.float32)
    close(tl._masked_mean(torch.from_numpy(x), T[4]), jl._masked_mean(jnp.asarray(x), J[4]))
    empty = np.zeros((B, N), bool)
    assert float(tl._masked_mean(torch.from_numpy(x), torch.from_numpy(empty))) == 0.0


def test_point_cloud_to_depth_and_kp_depth():
    rng = np.random.RandomState(6)
    H, W = 24, 32
    pts = np.concatenate([rng.uniform(-1, 1, (500, 2)), rng.uniform(-0.5, 3, (500, 1))],
                         axis=1).astype(np.float32)
    pts[:3] = [[1e6, 0, 1e-9], [0, 0, -1], [0, 0, 0]]  # far off, behind, at zero
    K = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]], np.float32)
    d_t = tg.point_cloud_to_depth(torch.from_numpy(pts), torch.from_numpy(K), W, H)
    d_j = jg.point_cloud_to_depth(jnp.asarray(pts), jnp.asarray(K), W, H)
    close(d_t, d_j)
    assert 0 < int((d_t > 0).sum()) < H * W
    kp = rng.uniform(0, 31.9, size=(1, 40, 2)).astype(np.float32)
    close(tg.extract_kp_depth(d_t[0, 0], torch.from_numpy(kp), 3),
          jg.extract_kp_depth(d_j[0, 0], jnp.asarray(kp), 3))


def _sparse_depth(seed, H=40, W=56):
    rng = np.random.RandomState(seed)
    d = rng.uniform(0.5, 3.0, size=(H, W)).astype(np.float32)
    d[rng.rand(H, W) < 0.4] = 0.0  # holes
    return d


@pytest.mark.parametrize("name,args", [
    ("median_blur", (3,)),
    ("bilateral_blur", (3, 0.1, 1.0)),
    ("_dilate", (3,)),
    ("_erode", (3,)),
    ("_fill_holes", (5,)),
    ("_box_filter", (8,)),
])
def test_depth_filters(name, args):
    d = _sparse_depth(7)
    close(getattr(td, name)(torch.from_numpy(d), *args),
          getattr(jd, name)(jnp.asarray(d), *args))


def test_guided_and_joint_bilateral():
    a, b = _sparse_depth(8), _sparse_depth(9)
    close(td.guided_blur(torch.from_numpy(a), torch.from_numpy(b), 8, 1e-2),
          jd.guided_blur(jnp.asarray(a), jnp.asarray(b), 8, 1e-2), atol=1e-4)
    close(td.joint_bilateral_blur(torch.from_numpy(a), torch.from_numpy(b), 3, 0.05, 1.0),
          jd.joint_bilateral_blur(jnp.asarray(a), jnp.asarray(b), 3, 0.05, 1.0))


def test_post_process_depth():
    """The whole chain; 1e-4 since it composes ~30 filter ops."""
    d = _sparse_depth(10)
    close(td.post_process_depth(torch.from_numpy(d)),
          jd.post_process_depth(jnp.asarray(d)), rtol=1e-4, atol=1e-4)
