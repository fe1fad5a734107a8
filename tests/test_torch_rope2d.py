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
from gd3d_torch.kernels.rope2d import (
    check_view, rope2d_fwd, rope2d_plain, rope2d_qk_fwd, vec_width)
from gd3d_torch.ops.rope2d import grid_positions, rope2d, rope2d_qk

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


def _grid(B, h, w):
    return np.asarray(jgrid_positions(h, w, B)).astype(np.int64)


# (Bq, Hq, Nq positions, Bk, Hk, Nk positions, D): self attention with shared
# positions, cross attention with other positions and lengths, VGGT
# positions with the 5 special tokens
QK_CASES = {
    "self": (lambda: _grid(2, 3, 4), lambda: None, 2, 3, 16),
    "cross": (lambda: _grid(1, 3, 5), lambda: _grid(1, 2, 4)[:, ::-1].copy(), 1, 2, 32),
    "vggt": (lambda: _vggt_positions(2, 3, 4), lambda: None, 2, 2, 16),
}


def _qk_inputs(case, seed):
    qpos_fn, kpos_fn, B, H, D = QK_CASES[case]
    qpos = qpos_fn()
    kpos = qpos if kpos_fn() is None else kpos_fn()
    q = _tokens((B, H, qpos.shape[1], D), seed=seed)
    k = _tokens((B, H, kpos.shape[1], D), seed=seed + 1)
    return q, qpos, k, kpos


@pytest.mark.parametrize("case", sorted(QK_CASES))
@pytest.mark.parametrize("use_pallas", [False, True])
def test_qk_forward_matches_gd3d(case, use_pallas):
    """rope2d_qk against gd3d's rope2d_xla or its Pallas kernel (interpret
    mode), each of q and k on its own positions."""
    q, qpos, k, kpos = _qk_inputs(case, seed=10)

    def jrope(x, pos):
        if use_pallas:  # rope2d_pallas reads positions[0]; these are equal over B
            assert (pos == pos[:1]).all()
            return np.asarray(rope2d_pallas(jnp.asarray(x), jnp.asarray(pos), 100.0, 1.0, True))
        return np.asarray(rope2d_xla(jnp.asarray(x), jnp.asarray(pos), 100.0))

    got_q, got_k = rope2d_qk(torch.from_numpy(q), torch.from_numpy(qpos),
                             torch.from_numpy(k), torch.from_numpy(kpos), 100.0)
    np.testing.assert_allclose(got_q.numpy(), jrope(q, qpos), **TOL)
    np.testing.assert_allclose(got_k.numpy(), jrope(k, kpos), **TOL)
    plain = rope2d_qk_fwd(torch.from_numpy(q), torch.from_numpy(qpos), torch.from_numpy(k),
                          torch.from_numpy(kpos))
    np.testing.assert_allclose(plain[0].numpy(), got_q.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(plain[1].numpy(), got_k.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("case", sorted(QK_CASES))
@pytest.mark.parametrize("use_pallas", [False, True])
def test_qk_gradient_matches_gd3d(case, use_pallas):
    """Gradients of q and k through RoPE2DQK against jax.grad through gd3d's
    rope2d_xla or rope2d_pallas (custom_vjp, rotation by -theta)."""
    q, qpos, k, kpos = _qk_inputs(case, seed=20)
    wq, wk = _tokens(q.shape, seed=30), _tokens(k.shape, seed=31)

    def jrope(x, pos):
        if use_pallas:
            return rope2d_pallas(x, jnp.asarray(pos), 100.0, 1.0, True)
        return rope2d_xla(x, jnp.asarray(pos), 100.0)

    def jloss(xq, xk):
        yq, yk = jrope(xq, qpos), jrope(xk, kpos)
        return (jnp.sum(yq * jnp.asarray(wq)) + jnp.sum(yq ** 2)
                + jnp.sum(yk * jnp.asarray(wk)) + jnp.sum(yk ** 2))

    want_q, want_k = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    tq = torch.from_numpy(q).requires_grad_(True)
    tk = torch.from_numpy(k).requires_grad_(True)
    yq, yk = rope2d_qk(tq, torch.from_numpy(qpos), tk, torch.from_numpy(kpos), 100.0)
    ((yq * torch.from_numpy(wq)).sum() + (yq ** 2).sum()
     + (yk * torch.from_numpy(wk)).sum() + (yk ** 2).sum()).backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(want_q), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(want_k), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("used", ["q", "k"])
def test_qk_gradient_of_one_side_only(used):
    """A loss that reads only q (or only k): the other side's gradient is
    None, and the used side's is the rotation by -theta."""
    q, qpos, k, kpos = _qk_inputs("cross", seed=40)
    g = _tokens(q.shape if used == "q" else k.shape, seed=41)
    tq = torch.from_numpy(q).requires_grad_(True)
    tk = torch.from_numpy(k).requires_grad_(True)
    yq, yk = rope2d_qk(tq, torch.from_numpy(qpos), tk, torch.from_numpy(kpos))
    ((yq if used == "q" else yk) * torch.from_numpy(g)).sum().backward()
    pos = qpos if used == "q" else kpos
    want = rope2d_xla(jnp.asarray(g), jnp.asarray(pos), 100.0, -1.0)
    got, unused = (tq, tk) if used == "q" else (tk, tq)
    np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **TOL)
    assert unused.grad is None


@pytest.mark.parametrize("D,dtype,vec", [(64, torch.float32, 4), (64, torch.bfloat16, 8),
                                         (16, torch.bfloat16, 4), (24, torch.float32, 2),
                                         (8, torch.bfloat16, 2), (4, torch.float32, 1),
                                         (4, torch.bfloat16, 1)])
def test_vec_width_and_aligned_views(D, dtype, vec):
    """The kernel's vector width from D, and the views it takes: every
    D % 4 == 0 stays accepted; the models' layouts are aligned, a view whose
    address or row step is off the vector raises."""
    assert vec_width(D, dtype) == vec
    qkv = torch.zeros((2, 5, 3, 3, D), dtype=dtype)
    for x in (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2].contiguous()):
        assert check_view(x.transpose(1, 2)) == vec
    assert check_view(torch.zeros((2, 3, 5, D), dtype=dtype)) == vec
    if vec > 1:
        flat = torch.zeros(2 * 5 * 3 * D + 1, dtype=dtype)
        with pytest.raises(ValueError, match="bytes"):
            check_view(flat[1:].view(2, 5, 3, D).transpose(1, 2))
        wide = torch.zeros((2, 5, 3 * D + 1), dtype=dtype)
        with pytest.raises(ValueError, match="bytes"):
            check_view(wide[..., :3 * D].reshape(2, 5, 3, D).transpose(1, 2))
