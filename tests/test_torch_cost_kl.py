"""K3 masked-softmax KL: the port's plain twin and its gradient against
gd3d's Pallas kernel (interpret mode) and its jax.grad, fp32 on the CPU.

Tolerance: rtol 1e-5 / atol 1e-6 on the per-row KL (fp32 sums over M in
another order), 1e-5 on gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gd3d.kernels.cost_kl import masked_softmax_kl_rows as jax_kl_rows
from gd3d_torch.kernels.cost_kl import masked_softmax_kl_fwd, masked_softmax_kl_rows


def _data(B, N, M, seed):
    rng = np.random.RandomState(seed)
    teacher = rng.rand(B, N, M).astype(np.float32)
    mask = rng.rand(B, N) > 0.3
    # row-normalized like masked_patch_cost: masked-out rows are all zero
    teacher = np.where(mask[..., None], teacher, 0.0)
    teacher /= np.maximum(teacher.sum(-1, keepdims=True), 1e-8)
    cost = ((rng.rand(B, N, M) - 0.5) * 2).astype(np.float32)
    return teacher.astype(np.float32), cost, mask


@pytest.mark.parametrize("B,N,M", [(2, 40, 40), (1, 130, 96), (1, 672, 672)])
def test_forward_matches_pallas_interpret(B, N, M):
    teacher, cost, mask = _data(B, N, M, seed=N)
    want = jax_kl_rows(jnp.asarray(teacher), jnp.asarray(cost), jnp.asarray(mask),
                       1e-8, True)
    got = masked_softmax_kl_rows(torch.from_numpy(teacher), torch.from_numpy(cost),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_masked_row_is_uniform_against_eps():
    """A masked-out row: q = 1/M against a teacher row clamped to eps."""
    teacher, cost, mask = _data(1, 8, 16, seed=1)
    mask[0, 3] = False
    teacher[0, 3] = 0.0
    got = masked_softmax_kl_fwd(torch.from_numpy(teacher), torch.from_numpy(cost),
                                torch.from_numpy(mask))
    eps, M = 1e-8, 16
    np.testing.assert_allclose(float(got[0, 3]), M * eps * np.log(eps * M), rtol=1e-5)


@pytest.mark.parametrize("seed", [2, 3])
def test_gradient_matches_jax_grad(seed):
    teacher, cost, mask = _data(2, 24, 30, seed)
    wt = np.random.RandomState(seed + 10).rand(2, 24).astype(np.float32)

    def jloss(c):
        return jnp.sum(jax_kl_rows(jnp.asarray(teacher), c, jnp.asarray(mask), 1e-8,
                                   True) * wt)

    want = jax.grad(jloss)(jnp.asarray(cost))
    c = torch.from_numpy(cost).requires_grad_(True)
    (masked_softmax_kl_rows(torch.from_numpy(teacher), c, torch.from_numpy(mask))
     * torch.from_numpy(wt)).sum().backward()
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert float(c.grad[~torch.from_numpy(mask)].abs().max()) == 0.0
