"""gd3d_torch's CUDA kernels against their plain twins, on the card.

Every test here carries the `cuda` marker and skips without an NVIDIA GPU:
the kernels have no CPU mode. The file imports neither JAX nor gd3d, and
the repo's conftest.py imports JAX, so on a GPU machine run it as

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

chip_smoke.py checks the same kernels at the main-path shapes.
Tolerance: max |err| <= tol * max(1, max |plain|). fp32: tol 1e-4 (sums in
another order). bf16: tol 1e-2. The plain twins compute in fp32 from the
bf16 operands and round only the output; the bf16 flash kernels (K1, K2)
run on the tensor cores and also round P (K1, and dV in K2) and dS (dK, dQ)
to bf16 before the next product, a relative error of at most 2^-9 per term,
which stays within a few ulps of bf16 (2^-8) of the largest output.
"""
import pytest
import torch

from gd3d_torch.kernels import build, launch_counts
from gd3d_torch.kernels.cost_kl import _reference_rows, masked_softmax_kl_rows
from gd3d_torch.kernels.flash_bwd_fused import (
    flash_attention_bwd_fused, flash_attention_bwd_plain)
from gd3d_torch.kernels.flash_fwd import flash_attention_fwd, flash_attention_fwd_plain
from gd3d_torch.kernels.pairwise_rank import (
    pairwise_rank_bwd, pairwise_rank_bwd_plain, pairwise_rank_fwd, pairwise_rank_sums_plain,
    pairwise_ranking_sums, scratch_floats, stream_chunks)
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


def _qkv_views(g, B, N, M, H, dtype, dev):
    """q from one projection, k and v from another: the (B, N, H, 64)
    strided views the models pass."""
    q = torch.randn((B, N, 3, H, 64), generator=g, device=dev).to(dtype)[:, :, 0]
    kv = torch.randn((B, M, 3, H, 64), generator=g, device=dev).to(dtype)
    return q, kv[:, :, 1], kv[:, :, 2]


# lengths that straddle the 64-row tiles, with M != N
LENGTHS = [(1, 1), (15, 63), (63, 65), (64, 64), (65, 15), (129, 673), (673, 129),
           (673, 673)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,M", LENGTHS)
def test_flash_kernels_match_plain(dev, dtype, N, M):
    g = torch.Generator(device=dev).manual_seed(N * 1000 + M)
    B, H = 2, 3
    q, k, v = _qkv_views(g, B, N, M, H, dtype, dev)
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
def test_flash_bwd_bf16_is_deterministic(dev):
    """K2 sums in a fixed order (no atomics): two calls give the same bits."""
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = _qkv_views(g, 2, 673, 673, 12, torch.bfloat16, dev)
    o, lse = flash_attention_fwd(q, k, v, 0.125)
    do = torch.randn(o.shape, generator=g, device=dev).to(torch.bfloat16)
    di = torch.einsum("bnhd,bnhd->bhn", o.float(), do.float()).contiguous()
    first = flash_attention_bwd_fused(q, k, v, lse, do, di, 0.125)
    second = flash_attention_bwd_fused(q, k, v, lse, do, di, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_flash_kernels_refuse_misaligned_bf16_views(dev):
    """The bf16 kernels copy 16-byte chunks: a view whose address or row
    step is off 16 bytes raises instead of being copied."""
    qkv = torch.randn((1, 70, 3 * 2 * 64 + 4), device=dev).to(torch.bfloat16)
    good = qkv[..., :384].reshape(1, 70, 3, 2, 64)
    q, k, v = good[:, :, 0], good[:, :, 1], good[:, :, 2]  # row step 388 * 2 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention_fwd(q, k, v, 0.125)
    flat = torch.randn((1 * 70 * 2 * 64 + 1,), device=dev).to(torch.bfloat16)
    shifted = flat[1:].view(1, 70, 2, 64)  # address off by 2 bytes
    ok = torch.randn((1, 70, 2, 64), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention_fwd(shifted, ok, ok, 0.125)
    lse = torch.zeros((1, 2, 70), device=dev)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention_bwd_fused(ok, shifted, ok, lse, ok, lse, 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("N,M", LENGTHS)
def test_flash_fwd_fp32_croco_layout_matches_plain(dev, N, M):
    """The fp32 head-dim-64 K1 on the CroCo teacher's layout: q and k are
    (B, H, N, D)-contiguous (as RoPE returns them) viewed as (B, N, H, D),
    v is the strided view of a qkv projection."""
    g = torch.Generator(device=dev).manual_seed(N * 1000 + M + 1)
    B, H = 2, 3
    q = torch.randn((B, H, N, 64), generator=g, device=dev).transpose(1, 2)
    k = torch.randn((B, H, M, 64), generator=g, device=dev).transpose(1, 2)
    v = torch.randn((B, M, 3, H, 64), generator=g, device=dev)[:, :, 2]
    before = launch_counts()["K1"]
    o, lse = flash_attention_fwd(q, k, v, 0.125)
    assert launch_counts()["K1"] == before + 1
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, 0.125)
    assert_close(o, o_ref, torch.float32)
    assert_close(lse, lse_ref, torch.float32)


@pytest.mark.cuda
def test_flash_fwd_refuses_misaligned_fp32_views(dev):
    """The fp32 head-dim-64 K1 copies 16-byte chunks too: a view whose row
    step or address is off 16 bytes raises instead of being copied."""
    wide = torch.randn((1, 70, 3 * 2 * 64 + 2), device=dev)
    good = wide[..., :384].reshape(1, 70, 3, 2, 64)  # row step 386 * 4 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention_fwd(good[:, :, 0], good[:, :, 1], good[:, :, 2], 0.125)
    shifted = torch.randn((70 * 2 * 64 + 1,), device=dev)[1:].view(1, 70, 2, 64)
    ok = torch.randn((1, 70, 2, 64), device=dev)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention_fwd(ok, shifted, ok, 0.125)


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


def _rank_inputs(g, N, h, dev, second_view="random"):
    u = torch.randn((2, N, h), generator=g, device=dev) * 0.5
    head = [torch.randn(h, generator=g, device=dev) * 0.1,
            1 + torch.randn(h, generator=g, device=dev) * 0.05,
            torch.randn(h, generator=g, device=dev) * 0.05,
            torch.randn(h, generator=g, device=dev) * 0.2,
            torch.randn(1, generator=g, device=dev) * 0.1]
    depths = torch.rand((2, N), generator=g, device=dev) * 3
    valid = torch.rand((2, N), generator=g, device=dev) > 0.25
    if second_view != "random":
        valid[1] = False
    if second_view == "one_valid":
        valid[1, N // 2] = True
    return u, head, depths, valid


# N and h that straddle the kernels' tiles of 32 streamed keypoints, the 4
# pairs a warp takes per step, the 4 or 8 owned rows a block and the chunks
@pytest.mark.cuda
@pytest.mark.parametrize("second_view", ["all_invalid", "one_valid"])
@pytest.mark.parametrize("N,h", [(1, 32), (7, 96), (33, 128), (70, 128), (70, 96),
                                 (300, 32), (300, 128)])
def test_pairwise_rank_matches_plain(dev, N, h, second_view):
    """K4: per-row sums and counts, and the six gradients through the
    autograd.Function; a view with no valid keypoint, or with one, gives 0
    (no pair); N is no tile multiple."""
    g = torch.Generator(device=dev).manual_seed(N)
    u, head, depths, valid = _rank_inputs(g, N, h, dev, second_view)
    before = launch_counts()["K4"]
    rows, cnts = pairwise_rank_fwd(u, *head, depths, valid, 0.05)
    assert launch_counts()["K4"] == before + 1
    want_rows, want_cnts = pairwise_rank_sums_plain(u, *head, depths, valid, 0.05)
    assert torch.equal(cnts, want_cnts) and float(cnts[1].sum()) == 0.0
    assert float(rows[1].abs().sum()) == 0.0
    assert_close(rows, want_rows, torch.float32)
    g_rows = torch.rand((2, N), generator=g, device=dev)
    ins = [t.clone().requires_grad_(True) for t in (u, *head)]
    before = launch_counts()["K4b"]
    (pairwise_ranking_sums(*ins, depths, valid, 0.05)[0] * g_rows).sum().backward()
    assert launch_counts()["K4b"] == before + 1
    assert float(ins[0].grad[1].abs().sum()) == 0.0
    for t, want in zip(ins, pairwise_rank_bwd_plain(u, *head, depths, valid, g_rows, 0.05)):
        assert_close(t.grad, want, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("N,h", [(70, 96), (672, 128)])
def test_pairwise_rank_is_deterministic(dev, N, h):
    """K4 and K4b sum their per-chunk and per-block partials in a fixed order
    (no atomics): two calls give the same bits."""
    g = torch.Generator(device=dev).manual_seed(N + 1)
    u, head, depths, valid = _rank_inputs(g, N, h, dev)
    g_rows = torch.rand((2, N), generator=g, device=dev)
    runs = [(*pairwise_rank_fwd(u, *head, depths, valid, 0.05),
             *pairwise_rank_bwd(u, *head, depths, valid, g_rows, 0.05)) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,h", [(1, 1, 32), (2, 300, 96), (2, 672, 128)])
def test_pairwise_rank_scratch_matches_the_kernels_layout(dev, B, N, h):
    """The wrapper's scratch reckoning is the C side's (PrScratch)."""
    chunks = stream_chunks(B, N)
    for backward in (False, True):
        assert build.library().gd3d_pairwise_rank_scratch(B, N, h, chunks, int(backward)) \
            == scratch_floats(B, N, h, chunks, backward)


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
