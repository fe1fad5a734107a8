"""gd3d_torch's CUDA kernels against their plain twins, on the card.

Every test here carries the `cuda` marker and skips without an NVIDIA GPU:
the kernels have no CPU mode. The file imports neither JAX nor gd3d, and
the repo's conftest.py imports JAX, so on a GPU machine run it as

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

chip_smoke.py checks the same kernels at the main-path shapes.
Tolerance: max |err| <= tol * max(1, max |plain|), tol 1e-4 for fp32
(sums in another order) and 1e-2 for bf16 (one rounding of the output).
"""
import pytest
import torch

from gd3d_torch.kernels import launch_counts
from gd3d_torch.kernels.cost_kl import _reference_rows, masked_softmax_kl_rows
from gd3d_torch.kernels.flash_bwd_fused import (
    flash_attention_bwd_fused, flash_attention_bwd_plain)
from gd3d_torch.kernels.flash_fwd import flash_attention_fwd, flash_attention_fwd_plain
from gd3d_torch.ops.attention import scaled_dot_attention

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_close(got, want, dtype):
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype] * max(1.0, float(want.float().abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,M,H", [(2, 673, 673, 2), (1, 65, 130, 3), (1, 1, 64, 1)])
def test_flash_kernels_match_plain(dev, dtype, B, N, M, H):
    g = torch.Generator(device=dev).manual_seed(N)
    q = torch.randn((B, N, H, 64), generator=g, device=dev).to(dtype)
    kv = torch.randn((B, M, 2, H, 64), generator=g, device=dev).to(dtype)
    k, v = kv[:, :, 0], kv[:, :, 1]  # strided views, as the models pass them
    before = launch_counts()
    o, lse = flash_attention_fwd(q, k, v, 0.125)
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, 0.125)
    assert_close(o, o_ref, dtype)
    assert_close(lse, lse_ref, torch.float32)
    do = torch.randn((B, N, H, 64), generator=g, device=dev).to(dtype)
    di = torch.einsum("bnhd,bnhd->bhn", o_ref.float(), do.float()).contiguous()
    grads = flash_attention_bwd_fused(q, k, v, lse_ref, do, di, 0.125)
    for a, b in zip(grads, flash_attention_bwd_plain(q, k, v, lse_ref, do, di, 0.125)):
        assert_close(a, b, dtype)
    after = launch_counts()
    assert (after["K1"] - before["K1"], after["K2"] - before["K2"]) == (1, 1)


@pytest.mark.cuda
def test_attention_function_grads_match_plain_autograd(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn((2, 200, 3, 2, 64), generator=g, device=dev) * 0.5
    w = torch.randn((2, 200, 2, 64), generator=g, device=dev)
    grads = []
    for path in ("kernel", "plain"):
        t = qkv.clone().requires_grad_(True)
        q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
        if path == "kernel":
            o = scaled_dot_attention(q, k, v)
        else:
            o = flash_attention_fwd_plain(q, k, v, 64 ** -0.5)[0]
        (o * w).sum().backward()
        grads.append(t.grad)
    assert_close(grads[0], grads[1], torch.float32)


@pytest.mark.cuda
def test_cost_kl_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    mask = torch.rand((2, 96), generator=g, device=dev) > 0.3
    p = torch.rand((2, 96, 80), generator=g, device=dev) * mask[..., None]
    p = p / p.sum(-1, keepdim=True).clamp(min=1e-8)
    cost = torch.rand((2, 96, 80), generator=g, device=dev) * 2 - 1
    before = launch_counts()["K3"]
    got = masked_softmax_kl_rows(p, cost, mask)
    assert launch_counts()["K3"] == before + 1
    assert_close(got, _reference_rows(p, cost, mask, 1e-8), torch.float32)
