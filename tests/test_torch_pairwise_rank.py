"""K4 (fused pairwise depth ranking): the port's plain twin against gd3d's
Pallas kernel in interpret mode and its `_reference`, and the port's
Student.intra_depth_loss against gd3d's, on the same numpy-seeded inputs,
fp32 on the CPU.

Tolerance: sums rtol 2e-5 / atol 2e-4 and counts exact, as gd3d's own
kernel test holds its kernel to its oracle (fp32 sums of up to N^2 terms in
another order); the six gradients rtol 5e-4 / atol 5e-6, likewise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gd3d.core.config import StudentConfig as JStudentConfig
from gd3d.kernels.pairwise_rank import (
    _pairwise_rank_sums,
    _reference,
    pairwise_ranking_sums_fused,
)
from gd3d.models.student import Student as JStudent
from gd3d_torch.convert import student_state_dict
from gd3d_torch.core.config import StudentConfig
from gd3d_torch.kernels.pairwise_rank import (
    BWD_ROWS_PER_BLOCK,
    pairwise_rank_bwd_plain,
    pairwise_rank_fwd,
    pairwise_ranking_sums,
    scratch_floats,
    stream_chunks,
)
from gd3d_torch.models.student import Student

THR = 0.05


def _setup(seed=0, n=100, h=32):
    rng = np.random.RandomState(seed)
    return [
        (rng.randn(2, n, h) * 0.5).astype(np.float32),   # u
        (rng.randn(h) * 0.1).astype(np.float32),         # bias
        (1.0 + rng.randn(h) * 0.05).astype(np.float32),  # ln scale
        (rng.randn(h) * 0.05).astype(np.float32),        # ln bias
        (rng.randn(h) * 0.2).astype(np.float32),         # w_out
        (rng.randn(1) * 0.1).astype(np.float32),         # b_out
        (rng.rand(2, n) * 3).astype(np.float32),         # depths
        rng.rand(2, n) > 0.25,                           # valid
    ]


def _torch(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("n", [70, 100])  # not multiples of the 64-wide TPU tiles
def test_sums_match_gd3d_kernel_and_reference(n):
    args = _setup(n=n)
    s_k, c_k = pairwise_ranking_sums_fused(*map(jnp.asarray, args), THR, interpret=True)
    s_r, c_r = _reference(*map(jnp.asarray, args), THR, 1e-5)
    rows, cnts = pairwise_rank_fwd(*_torch(args), THR)
    assert rows.shape == (2, n)
    for s_want, c_want in ((s_k, c_k), (s_r, c_r)):
        np.testing.assert_array_equal(cnts.sum(1).numpy(), np.asarray(c_want))
        np.testing.assert_allclose(rows.sum(1).numpy(), np.asarray(s_want),
                                   rtol=2e-5, atol=2e-4)


def test_all_invalid_row_gives_zero():
    args = _setup(1, n=40)
    args[7][0, 3] = False  # one invalid keypoint: its row is all zero
    args[7][1] = False     # one view with no valid keypoint at all
    rows, cnts = pairwise_rank_fwd(*_torch(args), THR)
    assert float(rows[0, 3]) == 0.0 and float(cnts[0, 3]) == 0.0
    assert float(rows[1].abs().sum()) == 0.0 and float(cnts[1].sum()) == 0.0
    s_k, c_k = pairwise_ranking_sums_fused(*map(jnp.asarray, args), THR, interpret=True)
    assert float(c_k[1]) == 0.0 and float(s_k[1]) == 0.0


def test_six_gradients_match_gd3d_kernel():
    args = _setup(2, n=70)
    g_rows = np.random.RandomState(3).rand(2, 70).astype(np.float32)

    def jloss(u, bias, ln_s, ln_b, w_out, b_out):
        s, c = _pairwise_rank_sums(u, bias, ln_s, ln_b, w_out, b_out,
                                   jnp.asarray(args[6]), jnp.asarray(args[7]), THR, 1e-5, True)
        return jnp.sum(s) / jnp.sum(c) + 0.5 * s[0]

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, args[:6]))
    ins = [t.requires_grad_(True) for t in _torch(args[:6])]
    rows, cnts = pairwise_ranking_sums(*ins, *_torch(args[6:]), THR)
    s, c = rows.sum(1), cnts.sum(1)
    (s.sum() / c.sum() + 0.5 * s[0]).backward()
    for name, t, w in zip(("u", "bias", "ln_s", "ln_b", "w_out", "b_out"), ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=5e-4, atol=5e-6,
                                   err_msg=name)
    # the oracle the card compares K4's backward with: per-row upstream grads
    got = pairwise_rank_bwd_plain(*_torch(args[:6]), *_torch(args[6:]),
                                  torch.from_numpy(g_rows), THR)

    def jrow(u, bias, ln_s, ln_b, w_out, b_out):
        # per-row sums through the reference: the row grads weight each row
        diff = u[:, None, :, :] - u[:, :, None, :] + bias
        mu = jnp.mean(diff, -1, keepdims=True)
        var = jnp.mean((diff - mu) ** 2, -1, keepdims=True)
        y = (diff - mu) * jax.lax.rsqrt(var + 1e-5) * ln_s + ln_b
        score = jnp.tanh(jnp.sum(jax.nn.gelu(y, approximate=False) * w_out, -1) + b_out[0])
        d, v = jnp.asarray(args[6]), jnp.asarray(args[7])
        alpha = jnp.sign(d[:, None, :] - d[:, :, None])
        pv = (jnp.abs(d[:, None, :] - d[:, :, None]) > THR) & v[:, :, None] & v[:, None, :]
        rows = jnp.sum(jnp.log1p(jnp.exp(-alpha * score)) * pv, -1)
        return jnp.sum(rows * jnp.asarray(g_rows))

    want_rows = jax.grad(jrow, argnums=tuple(range(6)))(*map(jnp.asarray, args[:6]))
    for g, w in zip(got, want_rows):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4, atol=5e-6)


@pytest.mark.parametrize("n", [64, 96])
def test_student_intra_depth_loss_matches_gd3d(n):
    kw = dict(embed_dim=64, depth=2, num_heads=2, patch_size=8, pretrain_img_size=32,
              lora_start_block=0, use_adapters=False, adapter_bottleneck=8, target_res=32,
              depth_head_hidden=32)
    jst = JStudent(JStudentConfig(**kw))
    params = jax.tree_util.tree_map(np.asarray, jst.init(jax.random.key(0), img_size=32))
    st = Student(StudentConfig(**kw))
    st.load_state_dict(student_state_dict(params, st.cfg))
    rng = np.random.RandomState(4)
    feats = rng.randn(2, n, 64).astype(np.float32)
    depths = rng.rand(2, n).astype(np.float32)
    valid = rng.rand(2, n) > 0.3
    want = jst.intra_depth_loss(jax.tree_util.tree_map(jnp.asarray, params),
                                jnp.asarray(feats), jnp.asarray(depths), jnp.asarray(valid), THR)
    got = st.intra_depth_loss(torch.from_numpy(feats), torch.from_numpy(depths),
                              torch.from_numpy(valid), THR)
    np.testing.assert_allclose(float(got), float(want), rtol=3e-5, atol=1e-6)


def test_sums_match_gd3d_kernel_at_hidden_96_ragged_n():
    """h = 96 (three 32-wide parts a row) and an N that is no multiple of
    gd3d's 64-wide tiles nor of the port's tiles of 32."""
    args = _setup(5, n=77, h=96)
    s_k, c_k = pairwise_ranking_sums_fused(*map(jnp.asarray, args), THR, interpret=True)
    rows, cnts = pairwise_rank_fwd(*_torch(args), THR)
    np.testing.assert_array_equal(cnts.sum(1).numpy(), np.asarray(c_k))
    np.testing.assert_allclose(rows.sum(1).numpy(), np.asarray(s_k), rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("n,chunks", [(1, 1), (300, 7), (672, 4)])
def test_scratch_reckoning_for_the_chunked_partials(n, chunks):
    """The wrapper's plan for the CUDA kernels: into how many chunks the
    streamed keypoints are split, and the floats of scratch a call needs
    (the compacted view, then the per-chunk partials), every part rounded
    up to 16 bytes."""
    B, h = 2, 128
    assert stream_chunks(B, n) == chunks
    up4 = lambda x: -(-x // 4) * 4  # noqa: E731
    view = up4(B * n * h) + 3 * up4(B * n) + up4(B)  # rows, depths, grads, indices, count
    assert scratch_floats(B, n, h, chunks, False) == view + 2 * up4(B * n * chunks)
    blocks = B * -(-n // BWD_ROWS_PER_BLOCK) * chunks
    assert scratch_floats(B, n, h, chunks, True) == (
        view + 2 * up4(B * n * chunks * h) + up4(blocks * (4 * h + 1)))
    # more chunks never shrink it, and a chunk keeps at least 32 keypoints
    assert scratch_floats(B, n, h, chunks + 1, True) > scratch_floats(B, n, h, chunks, True)
    assert chunks == 1 or n / chunks >= 32
