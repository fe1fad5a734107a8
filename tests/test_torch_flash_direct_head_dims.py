"""K1 and K2's routing rule, on the CPU: which head dims the kernels read
direct (the caller's D columns at the kernel width, no copy) and which take
the pad route, and the direct route held to gd3d.

The rule (kernels/flash_fwd.py::runs_direct, shared by both wrappers) is
chosen from (D, dtype) alone: a head dim whose row of D elements is a
multiple of 16 bytes runs direct (above 256 on the chunked kernels), any
other takes `fwd_padded` / `bwd_padded`. The routes (`fwd_routed`, `bwd_routed`) run here through the
plain twins, exactly as they wrap the kernel launches on the card, with a
recorder that sees the operands `run` is given. The direct route is held,
on numpy-seeded inputs, to gd3d/ops/attention.py::scaled_dot_attention
(its einsum route off the TPU, as gd3d's own tests run it), the log-sum-exp
of its logits, and jax.grad through it. The kernels themselves run on the
card: tests/test_torch_kernels_cuda.py and chip_smoke.py's kernels phase.

Tolerance: 1e-5 of max(1, max |reference|) in fp32, as
tests/test_torch_flash_head_dims.py (sums of up to 192 terms per output in
another order).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gd3d.ops.attention import scaled_dot_attention as jax_attention
from gd3d_torch.kernels import (
    build, launch_counts, padded_launches, reset_launch_counts, wide_launches, wrappers)
from gd3d_torch.kernels.flash_bwd_fused import bwd_routed, flash_attention_bwd_plain
from gd3d_torch.kernels.flash_fwd import (
    CLUSTER_MAX_D, FWD_ROUTES, check_views, flash_attention_fwd_plain, fwd_route, fwd_routed,
    kernel_width, runs_chunked, runs_direct)
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
F32, BF16 = torch.float32, torch.bfloat16

# (D, dtype) -> route: a row of D elements a multiple of 16 bytes (bf16 D a
# multiple of 8, fp32 a multiple of 4) runs direct (above 256 on the chunked
# kernels)
ROUTES = {
    (1, F32): "padded", (6, F32): "padded", (8, F32): "direct", (16, F32): "direct",
    (20, F32): "direct", (48, F32): "direct", (64, F32): "direct", (72, F32): "direct",
    (96, F32): "direct", (192, F32): "direct", (256, F32): "direct",
    (1, BF16): "padded", (6, BF16): "padded", (8, BF16): "direct", (16, BF16): "direct",
    (20, BF16): "padded", (48, BF16): "direct", (64, BF16): "direct", (72, BF16): "direct",
    (96, BF16): "direct", (192, BF16): "direct", (256, BF16): "direct",
    # above 256, the chunked kernels by the same rule (padded to a multiple of 8)
    (257, F32): "padded", (260, F32): "direct", (300, F32): "direct", (512, F32): "direct",
    (257, BF16): "padded", (260, BF16): "padded", (300, BF16): "padded", (512, BF16): "direct",
}


def assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


class _Recorder:
    """A `run` for the routes that records the head dim of every operand it
    is given and answers with the plain twin."""

    def __init__(self, plain):
        self.plain, self.dims = plain, []

    def __call__(self, *args):
        self.dims.append({t.shape[-1] for t in args if torch.is_tensor(t) and t.dim() == 4})
        return self.plain(*args)


def _inputs(seed, B, N, M, H, D):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, L, H, D).astype(np.float32) for L in (N, M, M))
    do = rng.randn(B, N, H, D).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D", [1, 6, 8, 16, 20, 48, 64, 72, 96, 192, 256, 257, 260, 300, 512])
def test_routing_rule_sends_each_head_dim_to_its_route(D, dtype):
    """runs_direct gives each (D, dtype) its route, and both wrappers' routes
    follow it: the direct route hands `run` the D-wide operands, the pad
    route the operands zero-padded to kernel_width(D); O, dQ, dK and dV come
    back D wide either way."""
    want = ROUTES[(D, dtype)]
    assert runs_direct(D, dtype) == (want == "direct")
    width = D if want == "direct" else kernel_width(D)
    x = torch.zeros((1, 3, 2, D), dtype=dtype)
    lse = torch.zeros((1, 2, 3))
    fwd = _Recorder(flash_attention_fwd_plain)
    o, _ = fwd_routed(fwd, x, x, x, 0.1)
    bwd = _Recorder(flash_attention_bwd_plain)
    grads = bwd_routed(bwd, x, x, x, lse, x, lse, 0.1)
    assert fwd.dims == bwd.dims == [{width}]
    assert o.shape == x.shape and all(g.shape == x.shape for g in grads)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
def test_routes_refuse_wider_than_the_kernels(dtype):
    """Head dims past 256 are refused no more: 264 (a 16-byte row in both
    dtypes) runs direct on the chunked kernels, at its own width (above 256
    the kernel width is the next multiple of 8), and nothing raises."""
    assert runs_direct(264, dtype) and runs_chunked(264) and kernel_width(264) == 264
    x = torch.zeros((1, 3, 1, 264), dtype=dtype)
    fwd = _Recorder(flash_attention_fwd_plain)
    o, _ = fwd_routed(fwd, x, x, x, 0.1)
    lse = torch.zeros((1, 1, 3))
    bwd = _Recorder(flash_attention_bwd_plain)
    grads = bwd_routed(bwd, x, x, x, lse, x, lse, 0.1)
    assert fwd.dims == bwd.dims == [{264}]
    assert o.shape == x.shape and all(g.shape == x.shape for g in grads)


@pytest.mark.parametrize("D", [8, 16, 96, 192])
def test_direct_route_forward_matches_gd3d(D):
    """The direct route at head dims below their kernel widths (64, 128,
    256): `run` gets q, k, v unpadded, and O and the LSE match gd3d's
    attention and the log-sum-exp of its logits at the caller's scale."""
    B, N, M, H = 2, 37, 45, 3
    q, k, v, _ = _inputs(300 + D, B, N, M, H, D)
    scale = D ** -0.5
    run = _Recorder(flash_attention_fwd_plain)
    o, lse = fwd_routed(run, *map(torch.from_numpy, (q, k, v)), scale)
    assert kernel_width(D) > D and run.dims == [{D}]
    assert o.shape == (B, N, H, D) and lse.shape == (B, H, N)
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    assert_close(o.numpy(), np.asarray(want))
    logits = jnp.einsum("bnhd,bmhd->bhnm", jnp.asarray(q), jnp.asarray(k)) * scale
    assert_close(lse.numpy(), np.asarray(jax.nn.logsumexp(logits, -1)))


@pytest.mark.parametrize("D", [8, 16, 96, 192])
def test_direct_route_gradients_match_gd3d(D):
    """The direct route of K2: `run` gets q, k, v and dO unpadded, and dQ, dK
    and dV match jax.grad through gd3d's attention."""
    B, N, M, H = 2, 41, 33, 2
    q, k, v, do = _inputs(400 + D, B, N, M, H, D)
    scale = D ** -0.5
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_fwd_plain(tq, tk, tv, scale)
    di = torch.einsum("bnhd,bnhd->bhn", o, tdo).contiguous()
    run = _Recorder(flash_attention_bwd_plain)
    grads = bwd_routed(run, tq, tk, tv, lse, tdo, di, scale)
    assert run.dims == [{D}]

    def loss(q, k, v):
        return jnp.sum(jax_attention(q, k, v, scale) * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, w, x in zip(grads, want, (q, k, v)):
        assert g.shape == x.shape
        assert_close(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D", [8, 16, 48, 72, 96, 192, 264, 320, 512])
def test_check_views_accepts_direct_head_dims_below_their_width(D, dtype):
    """The launch's layout check takes the direct head dims below their
    kernel widths, and above 256 those of the chunked kernels, as strided
    views of one qkv projection."""
    qkv = torch.zeros((2, 37, 3, 2, D), dtype=dtype)
    check_views(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], fp32_copies_16=True)


@pytest.mark.parametrize("D,dtype", [(1, F32), (6, F32), (10, F32), (1, BF16), (6, BF16),
                                     (20, BF16), (100, BF16), (258, F32), (300, BF16)],
                         ids=lambda x: str(x).removeprefix("torch."))
def test_check_views_refuses_head_dims_off_16_bytes(D, dtype):
    """A head dim whose row is no multiple of 16 bytes, below 256 or above,
    never reaches a kernel: the check refuses it (the wrappers send it down
    the pad route first)."""
    x = torch.zeros((1, 5, 2, D), dtype=dtype)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        check_views(x, x, x)


def test_padded_launches_are_counted_apart_and_reset():
    """K1 and K2 count their pad-route launches (`launches_padded`) beside
    their launches; reset_launch_counts zeroes both, as it does before a
    counted run."""
    fns = wrappers()
    for kern in ("K1", "K2"):
        fns[kern].launches_padded = 3
    assert padded_launches() == {"K1": 3, "K2": 3}
    reset_launch_counts()
    assert padded_launches() == {"K1": 0, "K2": 0}
    assert all(fns[k].launches == 0 for k in ("K1", "K2"))


def test_chunked_launches_are_read_with_the_launches_and_reset():
    """K1 and K2 count their launches above head dim 256 (`launches_wide`),
    K1 also by the kernel that ran and dtype (`launches_wide_by`);
    launch_counts reads them as "K1 wide" and "K2 wide", and K1's bf16 ones
    as "K1 wide bf16" and those on the chunked kernels as "K1 chunked",
    beside the kernels' launches; wide_launches reads K1's by kernel;
    reset_launch_counts zeroes them with the rest, so a counted run sees
    only its own."""
    fns = wrappers()
    for kern, n in (("K1", 3), ("K2", 5)):
        fns[kern].launches = fns[kern].launches_wide = n
    by = {("cluster", "bfloat16"): 1, ("cluster", "float32"): 1, ("chunked", "bfloat16"): 1}
    fns["K1"].launches_wide_by.update(by)
    counts = launch_counts()
    assert set(counts) == set(fns) | {"K1 wide", "K2 wide", "K1 wide bf16", "K1 chunked"}
    assert (counts["K1"], counts["K2"], counts["K1 wide"], counts["K2 wide"]) == (3, 5, 3, 5)
    assert (counts["K1 wide bf16"], counts["K1 chunked"]) == (2, 1)
    assert wide_launches() == {"K1": by}
    reset_launch_counts()
    assert all(n == 0 for n in launch_counts().values())
    assert wide_launches() == {"K1": {}}


# K1 above 256 by fwd_route: the head dim the kernel gets (D, or D padded to a
# multiple of 8 where its rows are off 16 bytes) and its kernel; the bf16
# clusters reach 768 (776 past it), the fp32 ones 2048 (2056 past it)
K1_ROUTES = {
    **{(D, dt): (264, "cluster") for D in (257, 258, 264) for dt in (F32, BF16)},
    (300, F32): (300, "cluster"), (300, BF16): (304, "cluster"),
    **{(D, dt): (D, "cluster") for D in (320, 384, 512, 576, 768) for dt in (F32, BF16)},
    (776, F32): (776, "cluster"), (776, BF16): (776, "chunked"),
    (2048, F32): (2048, "cluster"), (2048, BF16): (2048, "chunked"),
    (2056, F32): (2056, "chunked"), (2056, BF16): (2056, "chunked"),
}


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D", [257, 258, 264, 300, 320, 384, 512, 576, 768, 776, 2048, 2056])
def test_fwd_route_sends_wide_head_dims_to_the_cluster_kernels(D, dtype):
    """Above 256 K1 runs on the cluster kernels up to CLUSTER_MAX_D[dtype]
    (bf16 flash_fwd_cluster_sm90.cu up to 768, fp32
    flash_fwd_cluster_tf32.cu up to 2048) and on the chunked kernels past
    it, and K2 stays on the chunked kernels at every such D."""
    width, route = K1_ROUTES[(D, dtype)]
    assert (D if runs_direct(D, dtype) else kernel_width(D)) == width
    assert runs_chunked(width)
    assert fwd_route(D, dtype) == route
    assert (route == "cluster") == (width <= CLUSTER_MAX_D[dtype])


@pytest.mark.parametrize("D,dtype,route", [
    (1, F32, "f32"), (64, F32, "f32"), (72, F32, "tf32"), (256, F32, "tf32"),
    (8, BF16, "sm90"), (20, BF16, "sm90"), (256, BF16, "sm90")])
def test_fwd_route_keeps_head_dims_up_to_256_on_their_width(D, dtype, route):
    """Up to 256 the route is the width's kernel, as before the clusters."""
    assert fwd_route(D, dtype) == route and not runs_chunked(kernel_width(D))


def test_fwd_routes_are_the_dispatch_s_in_its_order():
    """FWD_ROUTES names the kernels in the order of csrc/flash_fwd.cu's
    FwdRoute, the numbers gd3d_flash_fwd_route returns and the wrapper
    counts its launches above 256 by."""
    src = (build.CSRC_DIR / "flash_fwd.cu").read_text()
    enum = re.search(r"enum FwdRoute : int \{([^}]*)\};", src).group(1)
    names = [re.fullmatch(r"kFwd(\w+)", n.strip()).group(1).lower() for n in enum.split(",")]
    assert names == list(FWD_ROUTES)
