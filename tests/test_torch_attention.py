"""K1/K2 attention: the port's plain twins and its autograd.Function against
gd3d, fp32 on the CPU.

Tolerance: 1e-5 for the forward, 2e-5 (absolute) with 1e-4 relative for
gradients, the same bound tests/test_attention_patch.py holds gd3d's own
kernel to: fp32 sums over up to 256 keys in another order.

The CUDA kernels themselves run only on a card:
tests/test_torch_kernels_cuda.py and chip_smoke.py check them there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gd3d.kernels.flash_bwd_fused import flash_attention_bwd_fused as jax_bwd_fused
from gd3d.ops.attention import _einsum_sdpa
from gd3d_torch.kernels import launch_counts
from gd3d_torch.kernels.flash_bwd_fused import (
    flash_attention_bwd_fused, flash_attention_bwd_plain)
from gd3d_torch.kernels.flash_fwd import (
    aligned_16, check_operands, check_views, flash_attention_fwd, flash_attention_fwd_plain)
from gd3d_torch.ops.attention import scaled_dot_attention

GRAD_TOL = dict(rtol=1e-4, atol=2e-5)


def _qkv(seed, B, N, H, D, M=None, std=1.0):
    rng = np.random.RandomState(seed)
    M = M or N
    return (rng.randn(B, N, H, D) * std).astype(np.float32), \
        (rng.randn(B, M, H, D) * std).astype(np.float32), \
        (rng.randn(B, M, H, D) * std).astype(np.float32)


@pytest.mark.parametrize("B,N,M,H", [(2, 67, 67, 2), (1, 33, 200, 3)])
def test_plain_forward_matches_gd3d_einsum(B, N, M, H):
    q, k, v = _qkv(0, B, N, H, 64, M)
    scale = 0.125
    o, lse = flash_attention_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), scale)
    want = _einsum_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    logits = jnp.einsum("bnhd,bmhd->bhnm", jnp.asarray(q), jnp.asarray(k)) * scale
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(logits, -1)),
                               rtol=1e-5, atol=1e-5)
    # on the CPU the K1 wrapper is the plain twin, and counts no launch
    before = launch_counts()["K1"]
    o2, _ = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), scale)
    assert torch.equal(o, o2) and launch_counts()["K1"] == before


def test_plain_backward_matches_gd3d_fused_kernel_interpret():
    """The shapes of tests/test_attention_patch.py: gd3d's one-pass Pallas
    backward in interpret mode, fed (l, m) where the port takes lse."""
    B, H, N, D = 1, 2, 256, 64
    scale = 0.125
    q, k, v = _qkv(3, B, N, H, D, std=0.5)
    do = (np.random.RandomState(4).randn(B, N, H, D) * 0.5).astype(np.float32)
    t = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))  # noqa: E731  (B, H, N, D)
    qt, kt, vt, dot = t(q), t(k), t(v), t(do)
    logits = jnp.einsum("bhnd,bhmd->bhnm", qt, kt) * scale
    m = logits.max(-1)
    l = jnp.exp(logits - m[..., None]).sum(-1)
    o = jnp.einsum("bhnm,bhmd->bhnd", jax.nn.softmax(logits, -1), vt)
    di = jnp.sum(o * dot, axis=-1)
    want = jax_bwd_fused(qt, kt, vt, None, l, m, dot, di, block_q_major=128, block_q=128,
                         block_k_major=128, block_k=128, sm_scale=scale, interpret=True)
    lse = torch.from_numpy(np.array(m + jnp.log(l)))
    got = flash_attention_bwd_fused(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), lse, torch.from_numpy(do),
                                    torch.from_numpy(np.array(di)), scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 2, 1, 3),
                                   **GRAD_TOL)


@pytest.mark.parametrize("N,H", [(200, 2), (673, 1)])
def test_function_grads_match_jax_grad(N, H):
    """FlashAttention through strided (B, N, 3, H, D) qkv views, as the
    models call it, against jax.grad of gd3d's einsum attention."""
    rng = np.random.RandomState(N)
    B, D = 1, 64
    qkv = (rng.randn(B, N, 3, H, D) * 0.5).astype(np.float32)
    w = rng.randn(B, N, H, D).astype(np.float32)

    def jloss(qkv):
        o = _einsum_sdpa(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], D ** -0.5)
        return jnp.sum(o * w)

    want = jax.grad(jloss)(jnp.asarray(qkv))
    t = torch.from_numpy(qkv).requires_grad_(True)
    o = scaled_dot_attention(t[:, :, 0], t[:, :, 1], t[:, :, 2])
    (o * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **GRAD_TOL)


def test_plain_twins_agree_with_each_other():
    """Backward twin == autograd through the forward twin (fp32)."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(5, 2, 40, 2, 64, 50))
    do = torch.from_numpy(np.random.RandomState(6).randn(2, 40, 2, 64).astype(np.float32))
    o, lse = flash_attention_fwd_plain(q, k, v, 0.1)
    o.backward(do)
    di = torch.einsum("bnhd,bnhd->bhn", o.detach(), do)
    got = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), lse.detach(), do,
                                    di, 0.1)
    for g, t in zip(got, (q, k, v)):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), **GRAD_TOL)


def test_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on a card: the wrappers raise rather
    than fall back to the plain twin."""
    q = torch.empty((1, 8, 1, 64), device="meta")
    with pytest.raises(ValueError):
        flash_attention_fwd(q, q, q, 0.125)
    lse = torch.empty((1, 1, 8), device="meta")
    with pytest.raises(ValueError):
        flash_attention_bwd_fused(q, q, q, lse, q, lse, 0.125)


def test_aligned_16_reads_the_views_the_models_pass():
    """The bf16 kernels' 16-byte copy rule: the q, k, v views of a
    (B, N, 3, H, 64) projection pass; a view whose address or row step is off
    16 bytes does not; a step along a dim of length 1 is never taken."""
    qkv = torch.zeros((2, 67, 3, 12, 64), dtype=torch.bfloat16)
    assert all(aligned_16(qkv[:, :, i]) for i in range(3))
    wide = torch.zeros((2, 67, 3 * 12 * 64 + 4), dtype=torch.bfloat16)
    assert not aligned_16(wide[..., :3 * 12 * 64].reshape(2, 67, 3, 12, 64)[:, :, 0])
    flat = torch.zeros((67 * 12 * 64 + 1,), dtype=torch.bfloat16)
    assert not aligned_16(flat[1:].view(1, 67, 12, 64))
    assert aligned_16(torch.zeros((1, 67, 12, 64)).as_strided((1, 67, 12, 64),
                                                               (3, 768, 64, 1)))


def _croco_views(B=2, N=67, H=4):
    """q, k, v as models/croco.py hands them to K1: q and k come back from
    RoPE as (B, H, N, D)-contiguous tensors viewed as (B, N, H, D), v is the
    strided view of the qkv projection."""
    qkv = torch.zeros((B, N, 3, H, 64))
    q, k = (torch.zeros((B, H, N, 64)).transpose(1, 2) for _ in range(2))
    return q, k, qkv[:, :, 2]


@pytest.mark.parametrize("layout", ["croco", "qkv"])
def test_check_views_accepts_the_fp32_layouts_the_models_pass(layout):
    """K1's fp32 head-dim-64 kernel copies 16 bytes at a time; both layouts
    models/croco.py passes (and the plain qkv views of the ViTs) fit."""
    if layout == "croco":
        q, k, v = _croco_views()
    else:
        qkv = torch.zeros((2, 67, 3, 4, 64))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    check_views(q, k, v, fp32_copies_16=True)
    assert all(aligned_16(t) for t in (q, k, v))
    with pytest.raises(ValueError, match="CUDA"):  # the layout fits; the device does not
        check_operands(q, k, v, fp32_copies_16=True)


@pytest.mark.parametrize("how", ["row_step", "address"])
def test_check_views_refuses_misaligned_fp32_views(how):
    """An fp32 head-dim-64 view whose address or row step is off 16 bytes
    raises (nothing is copied to make it fit); K2's fp32 kernel and the
    head-dim-128 kernel read 4 bytes at a time and take it."""
    if how == "row_step":
        wide = torch.zeros((1, 70, 3 * 2 * 64 + 2))  # row step 386 * 4 bytes
        bad = wide[..., :384].reshape(1, 70, 3, 2, 64)[:, :, 0]
    else:
        bad = torch.zeros((70 * 2 * 64 + 1,))[1:].view(1, 70, 2, 64)  # off by 4 bytes
    ok = torch.zeros((1, 70, 2, 64))
    assert not aligned_16(bad)
    with pytest.raises(ValueError, match="16 bytes"):
        check_views(ok, bad, ok, fp32_copies_16=True)
    check_views(ok, bad, ok, head_dims=(64,))  # K2 fp32: no 16-byte copies
    wide128 = torch.zeros((1, 70, 2 * 128 + 2))[..., :256].reshape(1, 70, 2, 128)
    check_views(wide128, wide128, wide128, fp32_copies_16=True)  # head dim 128
