"""K5 (RoPE2D): the port's plain twin and autograd.Function against gd3d's
`rope2d_xla` and its Pallas kernel (interpret mode), on the same
numpy-seeded inputs, fp32 on the CPU.

Tolerance: rtol 1e-5, atol 1e-6 (fp32, the same formula; cos and sin of the
same fp32 angles); gradients alike, through autograd on the port's side and
jax.grad (custom_vjp, rotation by -theta) on gd3d's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gd3d.kernels.rope2d import rope2d_pallas
from gd3d.ops.rope2d import grid_positions as jgrid_positions
from gd3d.ops.rope2d import rope2d_xla
from gd3d_torch.kernels.rope2d import rope2d_fwd, rope2d_plain
from gd3d_torch.ops.rope2d import grid_positions, rope2d

TOL = dict(rtol=1e-5, atol=1e-6)


def _vggt_positions(B, h, w, special=5):
    """The aggregator's positions: the grid shifted by +1, zeros for the
    camera and register tokens in front (gd3d aggregator.py:166-169)."""
    pos = np.asarray(jgrid_positions(h, w, B)) + 1
    return np.concatenate([np.zeros((B, special, 2), pos.dtype), pos], 1).astype(np.int64)


def _tokens(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("B,H,h,w,D,special", [(2, 3, 4, 6, 16, 0), (1, 2, 3, 5, 32, 5)])
def test_forward_matches_gd3d(B, H, h, w, D, special):
    pos = _vggt_positions(B, h, w, special) if special else np.asarray(
        jgrid_positions(h, w, B)).astype(np.int64)
    tok = _tokens((B, H, pos.shape[1], D))
    want = np.asarray(rope2d_xla(jnp.asarray(tok), jnp.asarray(pos), 100.0))
    got = rope2d(torch.from_numpy(tok), torch.from_numpy(pos), 100.0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(rope2d_plain(torch.from_numpy(tok), torch.from_numpy(pos)).numpy(),
                               want, **TOL)


def test_forward_matches_pallas_interpret():
    # rope2d_pallas reads positions[0] only, as gd3d's grid positions are
    # the same for every batch row
    pos = _vggt_positions(1, 4, 5)
    tok = _tokens((1, 2, pos.shape[1], 32), seed=1)
    want = np.asarray(rope2d_pallas(jnp.asarray(tok), jnp.asarray(pos), 100.0, 1.0, True))
    got = rope2d_fwd(torch.from_numpy(tok), torch.from_numpy(pos), 100.0, 1.0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_strided_view_and_broadcast_positions():
    """q as the (B, N, H, D) view of a (B, N, 3, H, D) projection, handed
    over transposed, with batch-broadcast positions (stride 0), as the
    models call it."""
    B, H, D = 2, 2, 16
    pos_t = grid_positions(3, 4, B)  # expanded: stride 0 over the batch
    assert pos_t.stride(0) == 0
    qkv = torch.from_numpy(_tokens((B, 12, 3, H, D), seed=2))
    q = qkv[:, :, 0]
    got = rope2d(q.transpose(1, 2), pos_t, 100.0).transpose(1, 2)
    want = rope2d_xla(jnp.asarray(q.transpose(1, 2).contiguous().numpy()),
                      jnp.asarray(pos_t.numpy()), 100.0)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gradient_matches_gd3d(use_pallas):
    pos = _vggt_positions(1, 4, 4)
    tok = _tokens((1, 2, pos.shape[1], 16), seed=3)
    w = _tokens(tok.shape, seed=4)

    def jloss(x):
        if use_pallas:
            y = rope2d_pallas(x, jnp.asarray(pos), 100.0, 1.0, True)
        else:
            y = rope2d_xla(x, jnp.asarray(pos), 100.0)
        return jnp.sum(y * jnp.asarray(w)) + jnp.sum(y ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(tok)))
    t = torch.from_numpy(tok).requires_grad_(True)
    y = rope2d(t, torch.from_numpy(pos), 100.0)
    ((y * torch.from_numpy(w)).sum() + (y ** 2).sum()).backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5, atol=1e-5)


def test_backward_is_forward_with_negative_f0():
    pos = torch.from_numpy(_vggt_positions(1, 3, 3))
    g = torch.from_numpy(_tokens((1, 2, pos.shape[1], 16), seed=5))
    t = torch.zeros_like(g).requires_grad_(True)
    rope2d(t, pos).backward(g)
    np.testing.assert_allclose(t.grad.numpy(), rope2d_plain(g, pos, 100.0, -1.0).numpy(),
                               **TOL)
