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
from gd3d_torch.kernels.pairwise_rank import (
    pairwise_rank_bwd_plain, pairwise_rank_fwd, pairwise_rank_sums_plain,
    pairwise_ranking_sums)
from gd3d_torch.kernels.rope2d import rope2d_plain
from gd3d_torch.ops.attention import scaled_dot_attention
from gd3d_torch.ops.rope2d import grid_positions, rope2d

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
@pytest.mark.parametrize("B,N,H", [(1, 2, 16), (2, 77, 3)])
def test_flash_fwd_head_dim_128_matches_plain(dev, B, N, H):
    """K1's D=128 variant (the VGGT camera trunk: N = 2 frames)."""
    g = torch.Generator(device=dev).manual_seed(N)
    qkv = torch.randn((B, N, 3, H, 128), generator=g, device=dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = launch_counts()["K1"]
    o, lse = flash_attention_fwd(q, k, v, 128 ** -0.5)
    assert launch_counts()["K1"] == before + 1
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, 128 ** -0.5)
    assert_close(o, o_ref, torch.float32)
    assert_close(lse, lse_ref, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope2d_fwd_bwd_match_plain(dev, dtype):
    """K5 on the transposed strided view of a qkv projection, with
    batch-broadcast positions, forward and backward (-f0)."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((2, 45, 3, 4, 64), generator=g, device=dev).to(dtype)[:, :, 0]
    pos = grid_positions(5, 9, 2, device=dev)
    t = x.transpose(1, 2).detach().requires_grad_(True)
    before = launch_counts()["K5"]
    y = rope2d(t, pos)
    assert_close(y, rope2d_plain(x.transpose(1, 2), pos), dtype)
    w = torch.randn(y.shape, generator=g, device=dev).to(dtype)
    (y * w).sum().backward()
    assert launch_counts()["K5"] == before + 2
    assert_close(t.grad, rope2d_plain(w, pos, 100.0, -1.0), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("N,h", [(70, 128), (300, 32)])
def test_pairwise_rank_matches_plain(dev, N, h):
    """K4: per-row sums and counts, and the six gradients through the
    autograd.Function; an all-invalid view gives 0; N is no tile multiple."""
    g = torch.Generator(device=dev).manual_seed(N)
    u = torch.randn((2, N, h), generator=g, device=dev) * 0.5
    head = [torch.randn(h, generator=g, device=dev) * 0.1,
            1 + torch.randn(h, generator=g, device=dev) * 0.05,
            torch.randn(h, generator=g, device=dev) * 0.05,
            torch.randn(h, generator=g, device=dev) * 0.2,
            torch.randn(1, generator=g, device=dev) * 0.1]
    depths = torch.rand((2, N), generator=g, device=dev) * 3
    valid = torch.rand((2, N), generator=g, device=dev) > 0.25
    valid[1] = False
    rows, cnts = pairwise_rank_fwd(u, *head, depths, valid, 0.05)
    want_rows, want_cnts = pairwise_rank_sums_plain(u, *head, depths, valid, 0.05)
    assert torch.equal(cnts, want_cnts) and float(cnts[1].sum()) == 0.0
    assert_close(rows, want_rows, torch.float32)
    g_rows = torch.rand((2, N), generator=g, device=dev)
    ins = [t.clone().requires_grad_(True) for t in (u, *head)]
    before = launch_counts()["K4b"]
    (pairwise_ranking_sums(*ins, depths, valid, 0.05)[0] * g_rows).sum().backward()
    assert launch_counts()["K4b"] == before + 1
    for t, want in zip(ins, pairwise_rank_bwd_plain(u, *head, depths, valid, g_rows, 0.05)):
        assert_close(t.grad, want, torch.float32)


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
