"""The kernels at their wide widths, on the CPU: K1 and K2 at head dims 72,
80, 96, 104, 128, 160, 192 and 256 through the wrappers' padding route, K4 /
K4b's plain twin at hidden widths 192 and 256, and which source each dtype
and head dim reaches.

The padding route (`fwd_padded`, `bwd_padded`) runs here through the plain
twins, exactly as it wraps the kernel launches on the card for the head
dims whose rows are no multiple of 16 bytes (65, 129; the others are read
direct: tests/test_torch_flash_direct_head_dims.py): q, k, v (and dO)
zero-padded along D to the kernel width (128 or 256), the caller's
scale, O, dQ, dK, dV cut back to D columns. It is held, on the same
numpy-seeded inputs, to gd3d: K1 to gd3d/ops/attention.py::
scaled_dot_attention (its einsum route off the TPU) and the log-sum-exp of
its logits, K2 to gd3d/kernels/flash_bwd_fused.py::flash_attention_bwd_fused
in interpret mode, as tests/test_torch_attention.py runs it. K4's plain twin
is held to gd3d's Pallas kernel pairwise_ranking_sums_fused in interpret
mode, its six gradients to jax.grad through that kernel. The wide CUDA
kernels themselves run on the card: tests/test_torch_kernels_cuda.py and
chip_smoke.py's kernels phase hold them to these plain twins.

Tolerance: 1e-5 of max(1, max |reference|) in fp32 (sums of up to 256
terms per output in another order; padded zero columns add exact zeros);
K4 as tests/test_torch_pairwise_rank.py (sums rtol 2e-5 / atol 2e-4,
counts exact, gradients rtol 5e-4 / atol 5e-6).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gd3d.kernels.flash_bwd_fused import flash_attention_bwd_fused as jax_bwd_fused
from gd3d.kernels.pairwise_rank import _pairwise_rank_sums, pairwise_ranking_sums_fused
from gd3d.ops.attention import scaled_dot_attention as jax_attention
from gd3d_torch.kernels.flash_bwd_fused import bwd_padded, flash_attention_bwd_plain
from gd3d_torch.kernels.flash_fwd import (
    HEAD_DIMS, aligned_16, check_views, fit_views, flash_attention_fwd_plain, fwd_padded,
    kernel_width)
from gd3d_torch.kernels.pairwise_rank import (
    pairwise_rank_bwd_plain, pairwise_rank_sums_plain, pairwise_ranking_sums)
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
THR = 0.05
CSRC = Path(__file__).resolve().parent.parent / "gd3d_torch" / "csrc"


def assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


def _inputs(seed, B, N, M, H, D, std=1.0):
    rng = np.random.RandomState(seed)
    q, k, v = ((rng.randn(B, L, H, D) * std).astype(np.float32) for L in (N, M, M))
    do = (rng.randn(B, N, H, D) * std).astype(np.float32)
    return q, k, v, do


class _Recorder:
    """A `run` for the padding routes that records the width it is given
    and answers with the plain twin."""

    def __init__(self, plain):
        self.plain, self.widths = plain, []

    def __call__(self, q, *rest):
        self.widths.append(q.shape[-1])
        return self.plain(q, *rest)


# 72, 80 and 104: head dims of common ViT-H, SigLIP and bigG backbones; 160
# one that pads to 256
PADDED_DIMS = [72, 80, 96, 104, 128, 160, 192, 256]


@pytest.mark.parametrize("D", PADDED_DIMS)
def test_padded_route_forward_matches_gd3d(D):
    B, N, M, H = 2, 37, 45, 2
    q, k, v, _ = _inputs(D, B, N, M, H, D)
    scale = D ** -0.5  # the caller's, not the padded width's
    run = _Recorder(flash_attention_fwd_plain)
    o, lse = fwd_padded(run, *map(torch.from_numpy, (q, k, v)), scale)
    assert run.widths == [128 if D <= 128 else 256]
    assert o.shape == (B, N, H, D) and lse.shape == (B, H, N)
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    assert_close(o.numpy(), np.asarray(want))
    logits = jnp.einsum("bnhd,bmhd->bhnm", jnp.asarray(q), jnp.asarray(k)) * scale
    assert_close(lse.numpy(), np.asarray(jax.nn.logsumexp(logits, -1)))


@pytest.mark.parametrize("D", PADDED_DIMS)
def test_padded_route_backward_matches_gd3d_fused_kernel_interpret(D):
    """gd3d's one-pass Pallas backward in interpret mode, fed the row max m
    and sum l where the port takes lse = m + log l, on (B, H, N, D)."""
    B, H, N = 1, 2, 128
    scale = D ** -0.5
    q, k, v, do = _inputs(200 + D, B, N, N, H, D, std=0.5)
    t = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    qt, kt, vt, dot = t(q), t(k), t(v), t(do)
    logits = jnp.einsum("bhnd,bhmd->bhnm", qt, kt) * scale
    m = logits.max(-1)
    l = jnp.exp(logits - m[..., None]).sum(-1)
    o = jnp.einsum("bhnm,bhmd->bhnd", jax.nn.softmax(logits, -1), vt)
    di = jnp.sum(o * dot, axis=-1)
    want = jax_bwd_fused(qt, kt, vt, None, l, m, dot, di, block_q_major=128, block_q=128,
                         block_k_major=128, block_k=128, sm_scale=scale, interpret=True)
    run = _Recorder(flash_attention_bwd_plain)
    got = bwd_padded(run, *map(torch.from_numpy, (q, k, v)),
                     torch.from_numpy(np.array(m + jnp.log(l))), torch.from_numpy(do),
                     torch.from_numpy(np.array(di)), scale)
    assert run.widths == [128 if D <= 128 else 256]
    for g, w in zip(got, want):
        assert g.shape == (B, N, H, D)
        assert_close(g.numpy(), np.asarray(w).transpose(0, 2, 1, 3))


@pytest.mark.parametrize("D,want", [(1, 64), (64, 64), (65, 128), (96, 128), (128, 128),
                                    (129, 256), (192, 256), (256, 256)])
def test_head_dims_up_to_128_keep_their_kernel_widths(D, want):
    """Head dims up to 64 still run at width 64 and 65..128 at 128 (K1's
    kernels of earlier PRs; K2 at 65..128 newly); only 129..256 take the
    new width 256, in both routes."""
    assert HEAD_DIMS == (64, 128, 256) and kernel_width(D) == want
    x, lse = torch.zeros((1, 3, 1, D)), torch.zeros((1, 1, 3))
    fwd = _Recorder(flash_attention_fwd_plain)
    fwd_padded(fwd, x, x, x, 0.1)
    bwd = _Recorder(flash_attention_bwd_plain)
    bwd_padded(bwd, x, x, x, lse, x, lse, 0.1)
    assert fwd.widths == bwd.widths == [want]


def _in_order(text: str, *parts: str) -> None:
    """Each of `parts` occurs in `text`, each after the one before."""
    pos = 0
    for part in parts:
        found = text.find(part, pos)
        assert found >= 0, (part, text[pos:pos + 200])
        pos = found + len(part)


def test_entry_points_send_each_head_dim_to_its_kernel():
    """Each entry point takes any head dim up to 256 whose rows are 16-byte
    multiples (bf16 a multiple of 8, fp32 of 4) and runs it at the least
    width that holds it. gd3d_flash_fwd: bf16 at every width (64, 128,
    256) -> the Hopper kernels on TMA and wgmma (flash_fwd_sm90.cu); fp32
    at 64 -> the register-tiled CUDA-core kernel, at 128 and 256 ->
    flash_fwd_tf32_kernel on split TF32. gd3d_flash_bwd: bf16 at every
    width -> the Hopper kernels (flash_bwd_sm90.cu); fp32 at 128 and 256 ->
    flash_bwd_tf32_wide.cu's kernel (both passes, warp teams summing their
    parts of S^T and dP^T), at 64 -> flash_bwd.cu's, all split TF32. The
    fp32 kernels at 128 and
    256 run every product as mma.sync on TF32 hi and lo parts (mma_split),
    and no CUDA-core attention kernel is left at those widths: fp32 K1 at
    64 is the only CUDA-core one. The Hopper launchers instantiate their
    wgmma kernels at 64, 128 and 256."""
    text = (CSRC / "flash_fwd.cu").read_text()
    fwd = text[text.index('extern "C" int gd3d_flash_fwd('):]
    _in_order(fwd, "D % (is_bf16 ? 8 : 4) != 0",
              "if (is_bf16)  // head dims 64, 128 and 256", "sm90::launch_fwd_bf16(",
              "if (D <= kD)  // fp32 at width 64: the CUDA cores", "launch_fwd_f32(",
              "else if (D <= 128)  // fp32 at widths 128 and 256: split TF32 on mma.sync",
              "launch_fwd_tf32<128>(", "else", "launch_fwd_tf32<256>(")
    fwd_tf32 = text[text.index("flash_fwd_tf32_kernel("):text.index("cudaError_t launch_fwd_tf32(")]
    _in_order(fwd_tf32, "tc::split_a", "tc::mma_split(s[", "tc::a_from_c_tf32(",
              "tc::mma_split(acc[")
    text = (CSRC / "flash_bwd.cu").read_text()
    bwd = text[text.index('extern "C" int gd3d_flash_bwd('):]
    _in_order(bwd, "D % (is_bf16 ? 8 : 4) != 0",
              "if (is_bf16)  // head dims 64, 128 and 256", "sm90::launch_bwd_bf16(",
              "if (D > kD)  // fp32 at widths 128 and 256: split TF32 on mma.sync",
              "launch_bwd_tf32_wide(", "launch_bwd_tf32(")
    wide = re.sub(r"//[^\n]*", "", (CSRC / "flash_bwd_tf32_wide.cu").read_text())
    _in_order(wide, "void dkv_block(", "tc::mma_split(x[", "tc::team_sum<kTeam>(",
              "tc::a_from_c_tf32(", "tc::mma_split(dv_acc[", "tc::mma_split(dk_acc[",
              "void dq_block(", "tc::mma_split(x[", "tc::team_sum<kTeam>(",
              "tc::a_from_c_tf32(", "tc::mma_split(dq_acc[",
              "flash_bwd_tf32_wide_kernel(", "dkv_block<D>(", "dq_block<D>(",
              "cudaError_t launch_bwd_tf32_wide(", "if (D <= 128)",
              "tf32_wide::launch<128>(", "tf32_wide::launch<256>(")
    assert "__nv_bfloat16" not in wide and "wgmma" not in wide and "is_bf16" not in wide
    mma = (CSRC / "mma.cuh").read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in mma
    assert "cvt.rna.tf32.f32" in mma and "GD3D_TF32_PASSES 3" in mma
    # every fp32 attention kernel but the one at 64 runs on mma.sync
    kernels = {name for f in ("flash_fwd.cu", "flash_bwd.cu", "flash_bwd_tf32_wide.cu")
               for name in re.findall(r"^(flash_\w+_kernel)\(", (CSRC / f).read_text(), re.M)}
    assert kernels == {"flash_fwd_f32_kernel", "flash_fwd_tf32_kernel",
                       "flash_bwd_dkv_tf32_kernel", "flash_bwd_dq_tf32_kernel",
                       "flash_bwd_tf32_wide_kernel"}
    assert not (CSRC / "flash_bwd_wide.cu").exists()
    common = (CSRC / "common.cuh").read_text()
    assert not re.search(r"\b(kParts|kHalf|kPad|load_tile_parts|parts_dot|axpy_row)\b", common)
    fwd90 = (CSRC / "flash_fwd_sm90.cu").read_text()
    _in_order(fwd90, "flash_fwd_sm90_kernel(", "wgmma_ss<kKeys>(", "wgmma_rs<kD, 1>(",
              "cudaError_t launch_fwd_bf16(", "if (D <= 64)", "launch_fwd_plan<64, 1, 128, 3>(",
              "if (D > 128)", "launch_fwd_plan<256, 1, 64, 2>(",
              "launch_fwd_plan<128, 2, 128, 2>(", "launch_fwd_plan<128, 1, 64, 2>(")
    bwd90 = (CSRC / "flash_bwd_sm90.cu").read_text()
    _in_order(bwd90, "flash_bwd_dkv_sm90_kernel(", "wgmma_rs<L::kCols, 1>(",
              "flash_bwd_dq_sm90_kernel(", "wgmma_rs<kD, 1>(",
              "cudaError_t launch_bwd_bf16(", "launch_bwd_plans<64>(",
              "launch_bwd_plans<128>(", "launch_bwd_plans<256>(")
    assert "wgmma.mma_async" in (CSRC / "sm90.cuh").read_text()


def _misaligned_fp32(D, how):
    """A (1, 70, 2, D) fp32 view off 16 bytes: its row step (a slice of a
    projection 2 floats wider) or its address (4 bytes in)."""
    if how == "row_step":
        wide = torch.zeros((1, 70, 3 * 2 * D + 2))
        return wide[..., :6 * D].reshape(1, 70, 3, 2, D)[:, :, 0]
    return torch.zeros((70 * 2 * D + 1,))[1:].view(1, 70, 2, D)


@pytest.mark.parametrize("how", ["row_step", "address"])
@pytest.mark.parametrize("D", [128, 256])
def test_check_views_refuses_misaligned_wide_fp32_views(D, how):
    """The fp32 K1 and K2 at 128 and 256 copy 16 bytes at a time (cp.async),
    so the wrappers' check refuses an fp32 view at those widths whose address
    or row step is off 16 bytes, as it refuses one at 64; an aligned view
    passes."""
    bad = _misaligned_fp32(D, how)
    ok = torch.zeros((1, 70, 2, D))
    assert not aligned_16(bad) and aligned_16(ok)
    for views in ((bad, ok, ok), (ok, bad, ok), (ok, ok, bad)):
        with pytest.raises(ValueError, match="16 bytes"):
            check_views(*views, fp32_copies_16=True)
    check_views(ok, ok, ok, fp32_copies_16=True)


@pytest.mark.parametrize("how", ["row_step", "address"])
@pytest.mark.parametrize("D", [128, 256])
def test_fit_views_copies_misaligned_wide_fp32_views(D, how):
    """fit_views hands the kernels a fresh contiguous copy of such a view
    (same values, 16-byte aligned), which the check then takes, and leaves
    an aligned view as it is."""
    bad = _misaligned_fp32(D, how)
    bad.copy_(torch.from_numpy(np.random.RandomState(D).randn(*bad.shape).astype(np.float32)))
    ok = torch.zeros((1, 70, 2, D))
    fitted, same = fit_views(bad, ok)
    assert same is ok and fitted.data_ptr() != bad.data_ptr()
    assert fitted.is_contiguous() and aligned_16(fitted) and torch.equal(fitted, bad)
    check_views(fitted, ok, ok, fp32_copies_16=True)


def _rank_setup(seed, n, h):
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


@pytest.mark.parametrize("h", [192, 256])
def test_pairwise_rank_plain_twin_matches_gd3d_kernel_at_wide_hidden(h):
    args = _rank_setup(h, 40, h)
    s_k, c_k = pairwise_ranking_sums_fused(*map(jnp.asarray, args), THR, interpret=True)
    rows, cnts = pairwise_rank_sums_plain(*map(torch.from_numpy, args), THR)
    np.testing.assert_allclose(rows.sum(1).numpy(), np.asarray(s_k), rtol=2e-5, atol=2e-4)
    np.testing.assert_array_equal(cnts.sum(1).numpy(), np.asarray(c_k))


@pytest.mark.parametrize("h", [192, 256])
def test_pairwise_rank_gradients_match_gd3d_kernel_at_wide_hidden(h):
    """The six gradients through the port's autograd route (the plain twin
    on the CPU) and through the backward twin the card holds K4b to, against
    jax.grad of gd3d's kernel in interpret mode."""
    args = _rank_setup(h + 1, 36, h)
    g_view = np.array([0.7, 1.3], np.float32)

    def jloss(*p):
        s, _ = _pairwise_rank_sums(*p, jnp.asarray(args[6]), jnp.asarray(args[7]), THR, 1e-5,
                                   True)
        return jnp.sum(s * jnp.asarray(g_view))

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, args[:6]))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in args[:6]]
    rows, _ = pairwise_ranking_sums(*ins, *map(torch.from_numpy, args[6:]), THR)
    (rows.sum(1) * torch.from_numpy(g_view)).sum().backward()
    g_rows = torch.from_numpy(np.repeat(g_view[:, None], 36, 1))
    twin = pairwise_rank_bwd_plain(*map(torch.from_numpy, args), g_rows, THR)
    for name, t, b, w in zip(("u", "bias", "ln_s", "ln_b", "w_out", "b_out"), ins, twin, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=5e-4, atol=5e-6,
                                   err_msg=name)
        np.testing.assert_allclose(b.numpy(), np.asarray(w), rtol=5e-4, atol=5e-6,
                                   err_msg=name)
