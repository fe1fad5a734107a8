"""gd3d_torch's CUDA kernels against their plain twins, on the card.

Every test here carries the `cuda` marker and skips without an NVIDIA GPU:
the kernels have no CPU mode. The file imports neither JAX nor gd3d, and
the repo's conftest.py imports JAX, so on a GPU machine run it as

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

chip_smoke.py checks the same kernels at the main-path shapes.
Tolerance: max |err| <= tol * max(1, max |plain|). fp32: tol 1e-4 (sums in
another order). bf16: tol 1e-2. The plain twins compute in fp32 from the
bf16 operands and round only the output; the bf16 flash kernels (K1, K2,
on TMA and wgmma) also round P (K1, and dV in K2) and dS (dK, dQ) to bf16
before the next product, a relative error of at most 2^-9 per term, which
stays within a few ulps of bf16 (2^-8) of the largest output; at every
kernel width (64, 128 and 256). The kernels read head dims below their
widths whose rows are 16-byte multiples direct, the wrappers zero-pad the
other head dims below the kernels' widths and copy views off 16 bytes;
the tests below that once held a refusal of such a view now hold the copied
route to the plain twin. The fp32
K2, and the fp32 K1 at 128 and 256, run on the tensor cores as three TF32
products for each fp32 product (split operands);
`test_flash_bwd_fp32_keeps_fp32_precision` holds K2 to TIGHT_K2, which
single-pass TF32 misses by more than 10x.
"""
import pytest
import torch

from gd3d_torch.kernels import (
    build, launch_counts, padded_launches, reset_launch_counts, wide_launches)
from gd3d_torch.kernels.cost_kl import (
    _reference_rows, masked_softmax_kl_fwd, masked_softmax_kl_rows)
from gd3d_torch.kernels.flash_bwd_fused import (
    flash_attention_bwd_fused, flash_attention_bwd_plain)
from gd3d_torch.kernels.flash_fwd import (
    CLUSTER_MAX_D, FWD_ROUTES, flash_attention_fwd, flash_attention_fwd_plain, fwd_route,
    kernel_width, runs_direct)
from gd3d_torch.kernels.pairwise_rank import (
    pairwise_rank_bwd, pairwise_rank_bwd_plain, pairwise_rank_fwd, pairwise_rank_sums_plain,
    pairwise_ranking_sums, scratch_floats, stream_chunks)
from gd3d_torch.kernels.rope2d import rope2d_fwd, rope2d_plain, rope2d_qk_fwd
from gd3d_torch.ops.attention import scaled_dot_attention
from gd3d_torch.ops.rope2d import grid_positions, rope2d, rope2d_qk

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# fp32 K2 on random rows at (2, 673, 3, 64): the split-precision kernel
# measured 8.3e-6 of the max on NVIDIA H100 80GB HBM3 (PERF.md), a 1-pass
# TF32 build 6.4e-4 (python3 -m gd3d_torch.kernels.sweep k2)
TIGHT_K2 = 2e-5


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


# lengths that straddle the 64-row and 128-row tiles, with M != N
LENGTHS = [(1, 1), (15, 63), (63, 65), (64, 64), (65, 15), (127, 129), (128, 255),
           (129, 128), (255, 257), (257, 127), (129, 673), (673, 129), (673, 673)]


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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_bf16_is_deterministic(dev, dtype):
    """K2 sums in a fixed order (no atomics), in both dtypes: two calls give
    the same bits."""
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = _qkv_views(g, 2, 673, 673, 12, dtype, dev)
    o, lse = flash_attention_fwd(q, k, v, 0.125)
    do = torch.randn(o.shape, generator=g, device=dev).to(dtype)
    di = torch.einsum("bnhd,bnhd->bhn", o.float(), do.float()).contiguous()
    first = flash_attention_bwd_fused(q, k, v, lse, do, di, 0.125)
    second = flash_attention_bwd_fused(q, k, v, lse, do, di, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_flash_bwd_fp32_keeps_fp32_precision(dev):
    """The fp32 K2 (TF32 parts, three products each) on random rows of Q, K,
    V and dO, held to TIGHT_K2: a lost lo part, or a reduction index
    permuted wrongly between the accumulator and the next product's B
    operand, shows here (rows that all match would hide the second)."""
    g = torch.Generator(device=dev).manual_seed(673)
    q, k, v = _qkv_views(g, 2, 673, 673, 3, torch.float32, dev)
    o, lse = flash_attention_fwd_plain(q, k, v, 0.125)
    do = torch.randn(o.shape, generator=g, device=dev)
    di = torch.einsum("bnhd,bnhd->bhn", o, do).contiguous()
    grads = flash_attention_bwd_fused(q, k, v, lse, do, di, 0.125)
    for name, a, b in zip(("dq", "dk", "dv"), grads,
                          flash_attention_bwd_plain(q, k, v, lse, do, di, 0.125)):
        err = float((a - b).abs().max())
        assert err <= TIGHT_K2 * max(1.0, float(b.abs().max())), (name, err)
    # PyTorch's TF32 switch does not reach the kernel
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        again = flash_attention_bwd_fused(q, k, v, lse, do, di, 0.125)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [673, 4161])
def test_flash_bwd_bf16_repeats_at_student_lengths(dev, N):
    """The bf16 K2 (TMA and wgmma, dQ in a second kernel) at the student's
    cost and main lengths, where the kernels take 64- and 128-row blocks:
    two calls give the same bits, and both equal the plain twin."""
    g = torch.Generator(device=dev).manual_seed(N)
    q, k, v = _qkv_views(g, 2, N, N, 12, torch.bfloat16, dev)
    o, lse = flash_attention_fwd(q, k, v, 0.125)
    do = torch.randn(o.shape, generator=g, device=dev).to(torch.bfloat16)
    di = torch.einsum("bnhd,bnhd->bhn", o.float(), do.float()).contiguous()
    first = flash_attention_bwd_fused(q, k, v, lse, do, di, 0.125)
    second = flash_attention_bwd_fused(q, k, v, lse, do, di, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for a, b in zip(first, flash_attention_bwd_plain(q, k, v, lse, do, di, 0.125)):
        assert_close(a, b, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 8, 16, 48, 96, 128, 192, 256])
def test_flash_kernels_at_other_head_dims_match_plain(dev, dtype, D):
    """K1 and K2 at head dims below the widths 64, 128 or 256 (read direct,
    or zero-padded by the wrapper at D = 1), and at the wide kernels' own
    widths 128 and 256, against the plain twins at the true head dim and the
    caller's scale; one launch each."""
    g = torch.Generator(device=dev).manual_seed(D)
    B, N, M, H = 2, 129, 200, 3
    q = torch.randn((B, N, 3, H, D), generator=g, device=dev).to(dtype)[:, :, 0]
    kv = torch.randn((B, M, 3, H, D), generator=g, device=dev).to(dtype)
    k, v = kv[:, :, 1], kv[:, :, 2]
    scale = D ** -0.5
    before = launch_counts()
    o, lse = flash_attention_fwd(q, k, v, scale)
    assert o.shape == q.shape and launch_counts()["K1"] == before["K1"] + 1
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, scale)
    assert_close(o, o_ref, dtype)
    assert_close(lse, lse_ref, torch.float32)
    do = torch.randn((B, N, H, D), generator=g, device=dev).to(dtype)
    di = torch.einsum("bnhd,bnhd->bhn", o_ref.float(), do.float()).contiguous()
    grads = flash_attention_bwd_fused(q, k, v, lse_ref, do, di, scale)
    assert launch_counts()["K2"] == before["K2"] + 1
    for a, b in zip(grads, flash_attention_bwd_plain(q, k, v, lse_ref, do, di, scale)):
        assert a.shape == b.shape
        assert_close(a, b, dtype)


# Head dims below their kernel width that run direct: in both dtypes 8, 16,
# 48, 96 and 192; in fp32 also head dims a multiple of 4 but not of 8, whose
# last 8-column k-step is half zeros: 4, 20 and 36 (width 64), 100 (width
# 128, whose K2 warp teams of 2 split D at column 64), 132 (width 256: in
# the teams of 4 of K1 and K2, the third warp holds 4 columns and the fourth
# none) and 196 (the fourth holds 4)
DIRECT_DIMS = [*((D, dt) for D in (8, 16, 48, 96, 192)
                 for dt in (torch.float32, torch.bfloat16)),
               *((D, torch.float32) for D in (4, 20, 36, 100, 132, 196))]


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", DIRECT_DIMS)
@pytest.mark.parametrize("B,N,H", [(4, 24, 2), (2, 673, 4), (2, 2049, 8)])
def test_flash_kernels_read_head_dims_below_their_width_direct(dev, dtype, D, B, N, H):
    """Head dims below their kernel width whose rows are 16-byte multiples
    run direct: the kernels read the strided q, k, v views of one qkv
    projection as they are (TMA and cp.async fill the columns past D with
    zeros; at D = 192 a whole 64-column panel of width 256) and write
    contiguous (B, N, H, D) outputs, one launch each and none on the pad
    route; O, the LSE, dQ, dK and dV match the plain twins, and K2 repeats
    its bits. (4, 24, 2): the --tiny stereo model's length; (2, 2049, 8):
    long enough for the two-consumer plans of the bf16 kernels and for many
    key tiles of every plan."""
    g = torch.Generator(device=dev).manual_seed(B * N + D)
    qkv = torch.randn((B, N, 3, H, D), generator=g, device=dev).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = D ** -0.5
    before, padded = launch_counts(), padded_launches()
    o, lse = flash_attention_fwd(q, k, v, scale)
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, scale)
    assert o.shape == (B, N, H, D) and o.is_contiguous()
    assert_close(o, o_ref, dtype)
    assert_close(lse, lse_ref, torch.float32)
    do = torch.randn((B, N, H, D), generator=g, device=dev).to(dtype)
    di = torch.einsum("bnhd,bnhd->bhn", o_ref.float(), do.float()).contiguous()
    args = (q, k, v, lse_ref, do, di, scale)
    grads = flash_attention_bwd_fused(*args)
    again = flash_attention_bwd_fused(*args)
    after = launch_counts()
    assert (after["K1"] - before["K1"], after["K2"] - before["K2"]) == (1, 2)
    assert padded_launches() == padded
    for a, b, c in zip(grads, flash_attention_bwd_plain(*args), again):
        assert a.shape == b.shape and a.is_contiguous()
        assert_close(a, b, dtype)
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(1, torch.float32), (6, torch.float32),
                                     (20, torch.bfloat16), (100, torch.bfloat16)])
def test_flash_kernels_count_the_pad_route(dev, D, dtype):
    """Head dims whose rows are no multiple of 16 bytes take the pad route,
    and K1 and K2 count those launches as padded."""
    g = torch.Generator(device=dev).manual_seed(700 + D)
    q, k, v = _wide_views(g, 2, 70, 90, 3, D, dev, dtype)
    padded = padded_launches()
    _check_k1_k2(q, k, v, g, dev)
    assert padded_launches() == {"K1": padded["K1"] + 1, "K2": padded["K2"] + 1}


# Head dims the wrapper runs at the kernel widths 128 and 256 (65..128 and
# 129..256 zero-padded; 72, 80 and 104 are common ViT-H, SigLIP and bigG
# head dims), and lengths off the kernels' 16-, 32- and 64-row tiles
WIDE_DIMS = [65, 72, 80, 96, 104, 128, 129, 160, 192, 256]
WIDE_LENGTHS = LENGTHS + [(64, 80), (100, 81), (81, 673)]


def _wide_views(g, B, N, M, H, D, dev, dtype=torch.bfloat16):
    """q from one projection, k and v from another, (B, N|M, H, D)."""
    q = torch.randn((B, N, 3, H, D), generator=g, device=dev).to(dtype)[:, :, 0]
    kv = torch.randn((B, M, 3, H, D), generator=g, device=dev).to(dtype)
    return q, kv[:, :, 1], kv[:, :, 2]


def _check_k1_k2(q, k, v, g, dev):
    """K1 and K2 (one launch each) against the plain twins at the caller's
    scale, to the tolerance of q's dtype; returns K2's operands."""
    dtype, scale = q.dtype, q.shape[-1] ** -0.5
    before = launch_counts()
    o, lse = flash_attention_fwd(q, k, v, scale)
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, scale)
    assert o.shape == q.shape
    assert_close(o, o_ref, dtype)
    assert_close(lse, lse_ref, torch.float32)
    do = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    di = torch.einsum("bnhd,bnhd->bhn", o_ref.float(), do.float()).contiguous()
    args = (q, k, v, lse_ref, do, di, scale)
    grads = flash_attention_bwd_fused(*args)
    after = launch_counts()
    assert (after["K1"] - before["K1"], after["K2"] - before["K2"]) == (1, 1)
    for a, b in zip(grads, flash_attention_bwd_plain(*args)):
        assert a.shape == b.shape
        assert_close(a, b, dtype)
    return args


def _misaligned_wide(g, D, dtype, dev):
    """(1, 70, 2, D) views off 16 bytes: a row step 8 bytes past a multiple
    of 16 (a slice of a wider projection) and an address one element in."""
    elt = torch.finfo(dtype).bits // 8
    wide = torch.randn((1, 70, 3 * 2 * D + 8 // elt), generator=g, device=dev).to(dtype)
    row_step = wide[..., :6 * D].reshape(1, 70, 3, 2, D)[:, :, 0]
    flat = torch.randn((70 * 2 * D + 1,), generator=g, device=dev).to(dtype)
    return row_step, flat[1:].view(1, 70, 2, D)


@pytest.mark.cuda
@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("N,M", WIDE_LENGTHS)
def test_bf16_flash_kernels_at_wide_head_dims_match_plain(dev, D, N, M):
    """The bf16 K1 and K2 on TMA and wgmma at kernel widths 128 and 256 (S
    and dP read D / 64 column panels; O, dQ, dK and dV span them in one
    product), over lengths that straddle the 64- and 128-row blocks and the
    64- and 128-key tiles, with M != N."""
    g = torch.Generator(device=dev).manual_seed(N * 1000 + M + D)
    _check_k1_k2(*_wide_views(g, 2, N, M, 3, D, dev), g, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("N,M", WIDE_LENGTHS)
def test_fp32_flash_kernels_at_wide_head_dims_match_plain(dev, D, N, M):
    """The fp32 K1 and K2 on split TF32 (mma.sync) at kernel widths 128 and
    256, over lengths that straddle their 64-row blocks and their 16- and
    32-row streamed tiles, with M != N: fp32 accuracy (tol 1e-4), LSE
    included."""
    g = torch.Generator(device=dev).manual_seed(N * 1000 + M + D + 7)
    _check_k1_k2(*_wide_views(g, 2, N, M, 3, D, dev, torch.float32), g, dev)


def _check_misaligned_wide(D, dtype, dev):
    g = torch.Generator(device=dev).manual_seed(300 + D)
    ok = torch.randn((1, 70, 2, D), generator=g, device=dev).to(dtype)
    for bad in _misaligned_wide(g, D, dtype, dev):
        for qkv in ((bad, ok, ok), (ok, bad, ok), (ok, ok, bad)):
            _check_k1_k2(*qkv, g, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [72, 128, 256])
def test_bf16_flash_kernels_copy_misaligned_wide_views(dev, D):
    """Views whose row step or address is off 16 bytes, which TMA cannot
    read: the wrappers copy them (padding does, below 128 and 256), and K1
    and K2 on them equal their plain twins."""
    _check_misaligned_wide(D, torch.bfloat16, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [72, 128, 256])
def test_fp32_flash_kernels_copy_misaligned_wide_views(dev, D):
    """The same for fp32, whose kernels at 128 and 256 copy 16 bytes at a
    time (cp.async): the wrappers copy such a view, and K1 and K2 on it
    equal their plain twins at fp32 accuracy."""
    _check_misaligned_wide(D, torch.float32, dev)


def _check_repeats_wide(D, N, dtype, dev):
    g = torch.Generator(device=dev).manual_seed(N + D)
    args = _check_k1_k2(*_wide_views(g, 2, N, N, 768 // D, D, dev, dtype), g, dev)
    first = flash_attention_bwd_fused(*args)
    second = flash_attention_bwd_fused(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("N", [673, 4161])
def test_bf16_flash_bwd_repeats_at_wide_head_dims(dev, D, N):
    """The bf16 K2 at widths 128 and 256 sums in a fixed order (no atomics;
    at 256 two warpgroups hold halves of dK and dV): two calls give the same
    bits, at the student's width 768 re-headed (H = 768 / D)."""
    _check_repeats_wide(D, N, torch.bfloat16, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("N", [673, 4161])
def test_fp32_flash_bwd_repeats_at_wide_head_dims(dev, D, N):
    """The fp32 K2 at widths 128 and 256 (split TF32; at 256 dV and dK in
    two sweeps) sums in a fixed order with no atomics: two calls give the
    same bits, at the student's width 768 re-headed."""
    _check_repeats_wide(D, N, torch.float32, dev)


def _misaligned(dtype, dev, g):
    """(1, 70, 2, 64) views the kernels cannot read as they are: one whose
    row step is off 16 bytes (a slice of a wider projection) and one whose
    address is."""
    wide = torch.randn((1, 70, 3 * 2 * 64 + 4), generator=g, device=dev).to(dtype)
    row_step = wide[..., :384].reshape(1, 70, 3, 2, 64)[:, :, 0]
    flat = torch.randn((70 * 2 * 64 + 1,), generator=g, device=dev).to(dtype)
    return row_step, flat[1:].view(1, 70, 2, 64)


@pytest.mark.cuda
def test_flash_bwd_refuses_misaligned_fp32_views(dev):
    """The fp32 K2 copies 16-byte chunks: the wrapper copies a view whose
    address or row step is off 16 bytes, and the result equals the plain
    twin's (this test once held the refusal; the wrapper now copies)."""
    g = torch.Generator(device=dev).manual_seed(130)
    ok = torch.randn((1, 70, 2, 64), generator=g, device=dev)
    for bad in _misaligned(torch.float32, dev, g):
        o, lse = flash_attention_fwd_plain(bad, ok, ok, 0.125)
        di = torch.einsum("bnhd,bnhd->bhn", o, ok).contiguous()
        for args in ((bad, ok, ok, lse, ok, di), (ok, bad, ok, lse, ok, di),
                     (ok, ok, bad, lse, ok, di), (ok, ok, ok, lse, bad, di)):
            for a, b in zip(flash_attention_bwd_fused(*args, 0.125),
                            flash_attention_bwd_plain(*args, 0.125)):
                assert_close(a, b, torch.float32)


@pytest.mark.cuda
def test_flash_kernels_refuse_misaligned_bf16_views(dev):
    """The bf16 kernels copy by TMA, which needs 16-byte addresses and steps:
    the wrappers copy a view that is off, and K1 and K2 on it equal their
    plain twins (this test once held the refusal; the wrappers now copy)."""
    g = torch.Generator(device=dev).manual_seed(147)
    ok = torch.randn((1, 70, 2, 64), generator=g, device=dev).to(torch.bfloat16)
    for bad in _misaligned(torch.bfloat16, dev, g):
        for qkv in ((bad, ok, ok), (ok, bad, ok), (ok, ok, bad)):
            o, lse = flash_attention_fwd(*qkv, 0.125)
            o_ref, lse_ref = flash_attention_fwd_plain(*qkv, 0.125)
            assert_close(o, o_ref, torch.bfloat16)
            assert_close(lse, lse_ref, torch.float32)
            di = torch.einsum("bnhd,bnhd->bhn", o_ref.float(), ok.float()).contiguous()
            for a, b in zip(flash_attention_bwd_fused(*qkv, lse_ref, ok, di, 0.125),
                            flash_attention_bwd_plain(*qkv, lse_ref, ok, di, 0.125)):
                assert_close(a, b, torch.bfloat16)


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
    """The fp32 head-dim-64 K1 copies 16-byte chunks too: the wrapper copies
    a view whose row step or address is off 16 bytes, and the result equals
    the plain twin's (this test once held the refusal; the wrapper now
    copies)."""
    g = torch.Generator(device=dev).manual_seed(185)
    ok = torch.randn((1, 70, 2, 64), generator=g, device=dev)
    for bad in _misaligned(torch.float32, dev, g):
        for qkv in ((bad, ok, ok), (ok, bad, ok), (ok, ok, bad)):
            for a, b in zip(flash_attention_fwd(*qkv, 0.125),
                            flash_attention_fwd_plain(*qkv, 0.125)):
                assert_close(a, b, torch.float32)


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


def _vggt_pos(B, h, w, dev):
    """The aggregator's positions: 5 special tokens at 0, the grid + 1."""
    pos = grid_positions(h, w, B, device=dev) + 1
    return torch.cat([torch.zeros((B, 5, 2), dtype=pos.dtype, device=dev), pos], 1)


def _rope_pair(case, g, dtype, dev):
    """q and k as each main path hands them to K5, (B, H, N, D) views:
    the transposes of (B, N, 3, H, D) projections (CroCo self attention),
    of q_norm/k_norm outputs (VGGT), or of separate projections (CroCo
    cross attention, with other positions and, here, another length)."""
    if case.startswith("vggt"):
        B, h, w = (2, 37, 37) if case == "vggt frame" else (1, 37, 37)
        pos = _vggt_pos(2, h, w, dev)
        if B == 1:  # global attention: both frames in one sequence
            pos = pos.reshape(1, -1, 2)
        N = pos.shape[1]
        q = torch.randn((B, N, 16, 64), generator=g, device=dev).to(dtype)
        k = torch.randn((B, N, 16, 64), generator=g, device=dev).to(dtype)
        return q.transpose(1, 2), pos, k.transpose(1, 2), pos
    if case == "croco encoder":
        qkv = torch.randn((2, 672, 3, 16, 64), generator=g, device=dev).to(dtype)
        pos = grid_positions(21, 32, 2, device=dev)  # stride 0 over the batch
        return qkv[:, :, 0].transpose(1, 2), pos, qkv[:, :, 1].transpose(1, 2), pos
    # CroCo decoder cross attention
    q = torch.randn((1, 672, 12, 64), generator=g, device=dev).to(dtype).transpose(1, 2)
    k = torch.randn((1, 600, 12, 64), generator=g, device=dev).to(dtype).transpose(1, 2)
    return q, grid_positions(21, 32, 1, device=dev), k, grid_positions(20, 30, 1, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["vggt frame", "vggt global", "croco encoder",
                                  "croco decoder cross"])
def test_rope2d_single_and_pair_match_plain(dev, case, dtype):
    """K5 on one tensor and on q and k in one launch, forward and backward
    (-f0), at the main paths' shapes and layouts."""
    g = torch.Generator(device=dev).manual_seed(len(case))
    q, qpos, k, kpos = _rope_pair(case, g, dtype, dev)
    for f0 in (1.0, -1.0):
        before = launch_counts()["K5"]
        assert_close(rope2d_fwd(q, qpos, 100.0, f0), rope2d_plain(q, qpos, 100.0, f0), dtype)
        yq, yk = rope2d_qk_fwd(q, qpos, k, kpos, 100.0, f0)
        assert launch_counts()["K5"] == before + 2
        assert yq.shape == q.shape and yk.shape == k.shape
        assert_close(yq, rope2d_plain(q, qpos, 100.0, f0), dtype)
        assert_close(yk, rope2d_plain(k, kpos, 100.0, f0), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("used", ["both", "q", "k"])
def test_rope2d_qk_backward_matches_plain(dev, used):
    """RoPE2DQK's backward: one launch for both gradients, one for the side
    whose gradient is not None, and none for the other."""
    g = torch.Generator(device=dev).manual_seed(11)
    q0, qpos, k0, kpos = _rope_pair("croco decoder cross", g, torch.float32, dev)
    q, k = (t.detach().requires_grad_(True) for t in (q0, k0))
    yq, yk = rope2d_qk(q, qpos, k, kpos)
    wq, wk = torch.randn(yq.shape, generator=g, device=dev), torch.randn(yk.shape, generator=g,
                                                                          device=dev)
    loss = {"both": (yq * wq).sum() + (yk * wk).sum(), "q": (yq * wq).sum(),
            "k": (yk * wk).sum()}[used]
    before = launch_counts()["K5"]
    loss.backward()
    assert launch_counts()["K5"] == before + 1
    if used != "k":
        assert_close(q.grad, rope2d_plain(wq, qpos, 100.0, -1.0), torch.float32)
    if used != "q":
        assert_close(k.grad, rope2d_plain(wk, kpos, 100.0, -1.0), torch.float32)
    assert (q.grad is None) == (used == "k") and (k.grad is None) == (used == "q")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope2d_refuses_misaligned_views(dev, dtype):
    """K5 reads 16-byte vectors at D = 64: the wrapper copies a view whose
    address or row step is off 16 bytes, for one tensor and for either side
    of a pair, and the result equals the plain twin's (this test once held
    the refusal; the wrapper now copies)."""
    pos = grid_positions(5, 14, 1, device=dev)
    ok = torch.randn((1, 70, 2, 64), device=dev).to(dtype).transpose(1, 2)
    shifted = torch.randn((70 * 2 * 64 + 1,), device=dev).to(dtype)[1:].view(1, 70, 2, 64)
    wide = torch.randn((1, 70, 2 * 64 + 2), device=dev).to(dtype)[..., :128]
    wide = wide.reshape(1, 70, 2, 64)  # row step 130 elements
    for bad in (shifted.transpose(1, 2), wide.transpose(1, 2)):
        before = launch_counts()["K5"]
        assert_close(rope2d_fwd(bad, pos), rope2d_plain(bad, pos), dtype)
        yq, yk = rope2d_qk_fwd(ok, pos, bad, pos)
        assert_close(yq, rope2d_plain(ok, pos), dtype)
        assert_close(yk, rope2d_plain(bad, pos), dtype)
        yq, yk = rope2d_qk_fwd(bad, pos, ok, pos)
        assert_close(yq, rope2d_plain(bad, pos), dtype)
        assert_close(yk, rope2d_plain(ok, pos), dtype)
        assert launch_counts()["K5"] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(4, torch.bfloat16), (8, torch.bfloat16),
                                     (16, torch.bfloat16), (24, torch.float32),
                                     (4, torch.float32)])
def test_rope2d_narrow_head_dims_match_plain(dev, D, dtype):
    """Head dims whose quarter does not fill 16 bytes take the narrower
    vector instantiations (8, 4 or 2 bytes) of the same kernel."""
    g = torch.Generator(device=dev).manual_seed(D)
    x = torch.randn((2, 45, 3, 5, D), generator=g, device=dev).to(dtype)[:, :, 1]
    pos = grid_positions(5, 9, 2, device=dev)
    assert_close(rope2d_fwd(x.transpose(1, 2), pos),
                 rope2d_plain(x.transpose(1, 2), pos), dtype)


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
                                 (300, 32), (300, 128), (70, 48), (33, 80), (7, 1),
                                 (300, 127), (70, 192), (33, 256), (70, 200), (7, 129)])
def test_pairwise_rank_matches_plain(dev, N, h, second_view):
    """K4: per-row sums and counts, and the six gradients through the
    autograd.Function; a view with no valid keypoint, or with one, gives 0
    (no pair); N is no tile multiple; h is no multiple of 32 in (70, 48) to
    (300, 127) (the kernels hold it padded with zero units); the last four
    are wider than 128 (the wide kernel, in chunks of 128 units)."""
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
@pytest.mark.parametrize("N,h", [(70, 96), (672, 128), (672, 256)])
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
@pytest.mark.parametrize("B,N,h", [(1, 1, 32), (2, 300, 96), (2, 672, 128), (2, 300, 200)])
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


def _kl_inputs(g, B, N, M, masked, dev):
    """A teacher map row-normalized under the mask, as masked_patch_cost
    gives it, and a cost volume whose row 0 is so spread that its softmax
    falls below eps (1e-8) at most entries."""
    mask = {"none": torch.ones((B, N), dtype=torch.bool, device=dev),
            "all": torch.zeros((B, N), dtype=torch.bool, device=dev),
            "some": torch.rand((B, N), generator=g, device=dev) > 0.3}[masked]
    p = torch.rand((B, N, M), generator=g, device=dev) * mask[..., None]
    p = p / p.sum(-1, keepdim=True).clamp(min=1e-8)
    cost = torch.rand((B, N, M), generator=g, device=dev) * 2 - 1
    cost[:, 0] *= 60.0
    return p, cost, mask


@pytest.mark.cuda
@pytest.mark.parametrize("masked", ["none", "all", "some"])
@pytest.mark.parametrize("B,N,M", [(2, 33, 37), (1, 672, 672), (1, 1369, 1369), (1, 70, 2000)])
def test_cost_kl_rows_match_plain(dev, B, N, M, masked):
    """K3 at the main paths' M (672 with 16-byte rows, 1369 whose rows start
    off 16 bytes), an odd small M, and an M beyond the registers (its rest
    read as scalars); every row masked out, none, some; a row whose
    softmax falls below eps."""
    g = torch.Generator(device=dev).manual_seed(M + len(masked))
    p, cost, mask = _kl_inputs(g, B, N, M, masked, dev)
    q0 = torch.softmax(torch.where(mask[..., None], cost, 0.0), -1)[0, 0]
    assert masked == "all" or not bool(mask[0, 0]) or float(q0.min()) < 1e-8
    before = launch_counts()["K3"]
    got = masked_softmax_kl_rows(p, cost, mask)
    assert launch_counts()["K3"] == before + 1
    assert_close(got, _reference_rows(p, cost, mask, 1e-8), torch.float32)


@pytest.mark.cuda
def test_cost_kl_refuses_maps_off_each_other_by_4_bytes(dev):
    """Maps whose addresses differ modulo 16 bytes: no float4 can hold the
    same index of both, so K3 copies the map that is off 16 bytes and
    launches once; the rows equal the plain twin's (this test once held the
    refusal; the wrapper now copies)."""
    g = torch.Generator(device=dev).manual_seed(9)
    p, cost, mask = _kl_inputs(g, 1, 50, 672, "some", dev)
    shifted_cost, shifted_p = (
        torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape).copy_(t) for t in (cost, p))
    assert (shifted_cost.data_ptr() - p.data_ptr()) % 16 != 0
    for teacher, student in ((p, shifted_cost), (shifted_p, cost)):
        before = launch_counts()["K3"]
        got = masked_softmax_kl_fwd(teacher, student, mask)
        assert launch_counts()["K3"] == before + 1
        assert_close(got, _reference_rows(teacher, student, mask, 1e-8), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [257, 260, 264, 300, 320, 384, 512, 576])
@pytest.mark.parametrize("N,M", [(1, 1), (65, 63), (129, 200), (673, 673)])
def test_flash_kernels_above_256_match_plain(dev, dtype, D, N, M):
    """K1 and K2 above head dim 256 (direct where a row is a 16-byte
    multiple, else zero-padded to a multiple of 8) against the plain twins
    at the true head dim, on strided views of qkv projections; one launch
    each, counted as a wide launch, K1's on the cluster kernels
    (flash_fwd_cluster_{sm90,tf32}.cu), K2's on the chunked kernels; K2
    repeats its bits."""
    g = torch.Generator(device=dev).manual_seed(D + N)
    B, H = 2, 2
    q = torch.randn((B, N, 3, H, D), generator=g, device=dev).to(dtype)[:, :, 0]
    kv = torch.randn((B, M, 3, H, D), generator=g, device=dev).to(dtype)
    k, v = kv[:, :, 1], kv[:, :, 2]
    scale = D ** -0.5
    reset_launch_counts()
    o, lse = flash_attention_fwd(q, k, v, scale)
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, scale)
    assert o.shape == q.shape
    assert_close(o, o_ref, dtype)
    assert_close(lse, lse_ref, torch.float32)
    do = torch.randn((B, N, H, D), generator=g, device=dev).to(dtype)
    di = torch.einsum("bnhd,bnhd->bhn", o_ref.float(), do.float()).contiguous()
    grads = flash_attention_bwd_fused(q, k, v, lse_ref, do, di, scale)
    again = flash_attention_bwd_fused(q, k, v, lse_ref, do, di, scale)
    counts = launch_counts()
    assert [counts[k] for k in ("K1", "K2", "K1 wide", "K2 wide")] == [1, 2, 1, 2]
    dname = str(dtype).removeprefix("torch.")
    assert fwd_route(D, dtype) == "cluster"
    assert wide_launches()["K1"] == {("cluster", dname): 1}
    for a, b, c in zip(grads, flash_attention_bwd_plain(q, k, v, lse_ref, do, di, scale), again):
        assert a.shape == b.shape and torch.equal(a, c)
        assert_close(a, b, dtype)


def _wide_qkv(g, B, N, M, H, D, dtype, dev):
    q = torch.randn((B, N, 3, H, D), generator=g, device=dev).to(dtype)[:, :, 0]
    kv = torch.randn((B, M, 3, H, D), generator=g, device=dev).to(dtype)
    return q, kv[:, :, 1], kv[:, :, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_above_256_at_length_4161_repeats_its_bits(dev, dtype):
    """K1 at (1, 4161, 3, 512), the student's length at twice its widest
    head dim, on the cluster kernels (66 key tiles a query tile of bf16, 131
    of fp32, each with its exchange of S) against the plain twin; a second
    run gives the same bits."""
    g = torch.Generator(device=dev).manual_seed(4161)
    q, k, v = _wide_qkv(g, 1, 4161, 4161, 3, 512, dtype, dev)
    scale = 512 ** -0.5
    reset_launch_counts()
    o, lse = flash_attention_fwd(q, k, v, scale)
    o2, lse2 = flash_attention_fwd(q, k, v, scale)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert wide_launches()["K1"] == {("cluster", str(dtype).removeprefix("torch.")): 2}
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, scale)
    assert_close(o, o_ref, dtype)
    assert_close(lse, lse_ref, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [768, 776, 2048, 2056])
def test_flash_fwd_at_the_clusters_reach_matches_plain(dev, dtype, D):
    """K1 at the cluster kernels' reach and past it, against the plain
    twin: bf16 reaches 768 (three CTAs) and runs 776 on the chunked forward;
    fp32 runs 776 and 2048 on four and eight CTAs and 2056 on the chunked
    forward. Each launch is counted under its kernel."""
    g = torch.Generator(device=dev).manual_seed(D)
    q, k, v = _wide_qkv(g, 2, 65, 129, 2, D, dtype, dev)
    scale = D ** -0.5
    reset_launch_counts()
    o, lse = flash_attention_fwd(q, k, v, scale)
    route = "cluster" if D <= CLUSTER_MAX_D[dtype] else "chunked"
    assert fwd_route(D, dtype) == route
    assert wide_launches()["K1"] == {(route, str(dtype).removeprefix("torch.")): 1}
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, scale)
    assert_close(o, o_ref, dtype)
    assert_close(lse, lse_ref, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_route_is_the_dispatch_s(dev, dtype):
    """For every head dim up to 2100, fwd_route names the kernel that the
    library's gd3d_flash_fwd_route, on which gd3d_flash_fwd dispatches,
    gives the head dim the wrapper launches at."""
    lib = build.library()
    for D in range(1, 2101):
        width = D if runs_direct(D, dtype) else kernel_width(D)
        got = lib.gd3d_flash_fwd_route(width, int(dtype == torch.bfloat16))
        assert got >= 0 and FWD_ROUTES[got] == fwd_route(D, dtype), D

