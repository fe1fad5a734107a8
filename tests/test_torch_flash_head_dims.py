"""The kernels' widened inputs, on the CPU: K1 and K2 at head dims below 64
through the wrappers' zero-padding route, the intra-depth loss at
depth-head widths that are no multiple of 32, the copies that make a view
fit, and which source the bf16 head-dim-64 branch reaches.

The padding route (`fwd_padded`, `bwd_padded`) runs here through the plain
twins, exactly as it wraps the kernel launches on the card for the head
dims whose rows are no multiple of 16 bytes (the others are read direct:
tests/test_torch_flash_direct_head_dims.py): q, k, v (and dO) zero-padded
along D to 64, the caller's scale, O, dQ, dK, dV cut back to D columns.
It is held, on the same numpy-seeded inputs, to the unpadded
plain twin and to gd3d's attention on the CPU (gd3d/ops/attention.py::
scaled_dot_attention, its einsum route off the TPU, as gd3d's own tests run
it) with jax.grad for the gradients.

Tolerance: 1e-5 of max(1, max |reference|) in fp32, for outputs, the LSE,
gradients and the loss (sums of up to 96 terms per output in another
order; padded zero columns add exact zeros).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gd3d.core.config import StudentConfig as JStudentConfig
from gd3d.models.student import Student as JStudent
from gd3d.ops.attention import scaled_dot_attention as jax_attention
from gd3d_torch.convert import student_state_dict
from gd3d_torch.core.config import StudentConfig
from gd3d_torch.kernels.flash_bwd_fused import bwd_padded, flash_attention_bwd_plain
from gd3d_torch.kernels.flash_fwd import (
    CLUSTER_MAX_D, HEAD_DIMS, aligned_16, fit_views, flash_attention_fwd_plain, fwd_padded,
    kernel_width, pad_head_dim)
from gd3d_torch.kernels.pairwise_rank import padded_hidden, scratch_floats
from gd3d_torch.kernels.rope2d import fit_view
from gd3d_torch.models.student import Student
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
CSRC = Path(__file__).resolve().parent.parent / "gd3d_torch" / "csrc"


def assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


def _inputs(seed, B, N, M, H, D):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, L, H, D).astype(np.float32) for L in (N, M, M))
    do = rng.randn(B, N, H, D).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("D", [8, 16, 32, 48])
def test_padded_route_forward_matches_plain_and_gd3d(D):
    B, N, M, H = 2, 37, 45, 3
    q, k, v, _ = _inputs(D, B, N, M, H, D)
    scale = D ** -0.5  # the caller's, not the padded width's
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = fwd_padded(flash_attention_fwd_plain, tq, tk, tv, scale)
    assert o.shape == (B, N, H, D) and lse.shape == (B, H, N)
    o_ref, lse_ref = flash_attention_fwd_plain(tq, tk, tv, scale)
    assert_close(o.numpy(), o_ref.numpy())
    assert_close(lse.numpy(), lse_ref.numpy())
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    assert_close(o.numpy(), np.asarray(want))
    logits = jnp.einsum("bnhd,bmhd->bhnm", jnp.asarray(q), jnp.asarray(k)) * scale
    assert_close(lse.numpy(), np.asarray(jax.nn.logsumexp(logits, -1)))


@pytest.mark.parametrize("D", [8, 16, 32, 48])
def test_padded_route_gradients_match_plain_and_gd3d(D):
    B, N, M, H = 2, 41, 33, 2
    q, k, v, do = _inputs(100 + D, B, N, M, H, D)
    scale = D ** -0.5
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_fwd_plain(tq, tk, tv, scale)
    di = torch.einsum("bnhd,bnhd->bhn", o, tdo).contiguous()
    grads = bwd_padded(flash_attention_bwd_plain, tq, tk, tv, lse, tdo, di, scale)
    refs = flash_attention_bwd_plain(tq, tk, tv, lse, tdo, di, scale)

    def loss(q, k, v):
        return jnp.sum(jax_attention(q, k, v, scale) * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, r, w, x in zip(grads, refs, want, (q, k, v)):
        assert g.shape == x.shape
        assert_close(g.numpy(), r.numpy())
        assert_close(g.numpy(), np.asarray(w))


def test_padded_columns_come_out_zero():
    """What the route cuts off is exactly zero, so nothing of it leaks: O and
    the three gradients of the padded problem at D = 16, width 64."""
    q, k, v, do = map(torch.from_numpy, _inputs(7, 1, 20, 24, 2, 16))
    qp, kp, vp, dop = pad_head_dim(64, q, k, v, do)
    o, lse = flash_attention_fwd_plain(qp, kp, vp, 0.25)
    di = torch.einsum("bnhd,bnhd->bhn", o, dop).contiguous()
    for t in (o, *flash_attention_bwd_plain(qp, kp, vp, lse, dop, di, 0.25)):
        assert t.shape[-1] == 64 and torch.count_nonzero(t[..., 16:]) == 0


@pytest.mark.parametrize("D,widths,want", [(1, (64, 128), 64), (64, (64, 128), 64),
                                           (65, (64, 128), 128), (127, (64, 128), 128),
                                           (48, (64,), 64), (127, HEAD_DIMS, 128),
                                           (129, HEAD_DIMS, 256), (255, HEAD_DIMS, 256),
                                           (257, HEAD_DIMS, 264), (320, HEAD_DIMS, 320),
                                           (321, HEAD_DIMS, 328), (513, (64,), 520)])
def test_kernel_width(D, widths, want):
    assert kernel_width(D, widths) == want


def test_route_refuses_wider_than_the_kernels():
    """Head dims past 256 are refused no more: the pad route takes 320 as it
    is (a multiple of 8, the kernel width above 256) and pads 257 to 264,
    before any launch, and O, dQ, dK and dV come back D wide."""
    x = torch.zeros((1, 4, 1, 320))
    run = _Widths(flash_attention_fwd_plain)
    o, _ = fwd_padded(run, x, x, x, 0.1)
    assert run.widths == [320] and o.shape == x.shape
    lse = torch.zeros((1, 1, 4))
    y = torch.zeros((1, 4, 1, 257))
    run = _Widths(flash_attention_bwd_plain)
    grads = bwd_padded(run, y, y, y, lse, y, lse, 0.1)
    assert run.widths == [264] and all(g.shape == y.shape for g in grads)


class _Widths:
    """A `run` for the routes that records the head dim it is given and
    answers with the plain twin."""

    def __init__(self, plain):
        self.plain, self.widths = plain, []

    def __call__(self, *args):
        self.widths.append(args[0].shape[-1])
        return self.plain(*args)


# head dims above 256 (the chunked kernels' route); 257 and 300 are no
# multiple of their 64-column panels, 320, 384 and 512 are, and 257 is
# also off 16 bytes
WIDE_DIMS = [257, 300, 320, 384, 512]


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_wide_head_dims_forward_matches_gd3d(D):
    """Above 256, both routes (the pad route through `fwd_padded`, as the
    wrapper runs it for 257, and the unpadded twin, as the direct route
    reads the others) against gd3d's attention with force_xla and the
    log-sum-exp of its logits."""
    B, N, M, H = 1, 33, 29, 2
    q, k, v, _ = _inputs(500 + D, B, N, M, H, D)
    scale = D ** -0.5
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, force_xla=True)
    logits = jnp.einsum("bnhd,bmhd->bhnm", jnp.asarray(q), jnp.asarray(k)) * scale
    for o, lse in (fwd_padded(flash_attention_fwd_plain, tq, tk, tv, scale),
                   flash_attention_fwd_plain(tq, tk, tv, scale)):
        assert o.shape == (B, N, H, D)
        assert_close(o.numpy(), np.asarray(want))
        assert_close(lse.numpy(), np.asarray(jax.nn.logsumexp(logits, -1)))


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_wide_head_dims_gradients_match_gd3d(D):
    """Above 256, K2's routes against jax.vjp through gd3d's attention
    (force_xla) with the same cotangent."""
    B, N, M, H = 1, 31, 35, 2
    q, k, v, do = _inputs(600 + D, B, N, M, H, D)
    scale = D ** -0.5
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_fwd_plain(tq, tk, tv, scale)
    di = torch.einsum("bnhd,bnhd->bhn", o, tdo).contiguous()
    _, vjp = jax.vjp(lambda q, k, v: jax_attention(q, k, v, scale, force_xla=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    for grads in (bwd_padded(flash_attention_bwd_plain, tq, tk, tv, lse, tdo, di, scale),
                  flash_attention_bwd_plain(tq, tk, tv, lse, tdo, di, scale)):
        for g, w, x in zip(grads, want, (q, k, v)):
            assert g.shape == x.shape
            assert_close(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("how", ["address", "row_step", "last_dim", "expanded"])
def test_fit_views_copies_what_the_kernels_cannot_read(how):
    """A view off 16 bytes (address or row step), with a strided last dim or
    expanded along a dim (a step of 0, as the gradient of a sum is) comes
    back as an equal fresh contiguous tensor on 16 bytes; a view the kernels
    read as it is comes back as itself."""
    bad = {"address": torch.arange(70 * 2 * 64 + 1.0)[1:].view(1, 70, 2, 64),
           "row_step": torch.arange(70 * 386.0).view(1, 70, 386)[..., :384].reshape(
               1, 70, 3, 2, 64)[:, :, 0],
           "last_dim": torch.arange(70 * 2 * 128.0).view(1, 70, 2, 128)[..., ::2],
           "expanded": torch.arange(2 * 64.0).view(1, 1, 2, 64).expand(1, 70, 2, 64)}[how]
    ok = torch.zeros((1, 70, 2, 64))
    got_ok, got = fit_views(ok, bad)
    assert got_ok is ok
    assert got is not bad and got.is_contiguous() and aligned_16(got) and torch.equal(got, bad)


def test_rope_fit_view_copies_misaligned_tokens():
    tokens = torch.arange(70 * 2 * 64 + 1.0)[1:].view(1, 70, 2, 64).transpose(1, 2)
    got = fit_view(tokens)
    assert got is not tokens and torch.equal(got, tokens) and got.data_ptr() % 16 == 0
    fine = torch.zeros((1, 2, 70, 64))
    assert fit_view(fine) is fine


@pytest.mark.parametrize("h,want", [(1, 32), (32, 32), (48, 64), (80, 96), (128, 128),
                                    (129, 256), (192, 256), (256, 256), (300, 384)])
def test_padded_hidden_and_scratch(h, want):
    """K4 holds width h as h rounded up to 32, above 128 up to 128 (the wide
    kernel's chunks); its scratch is reckoned at that width, so widths that
    round alike need the same scratch."""
    assert padded_hidden(h) == want
    for backward in (False, True):
        assert scratch_floats(2, 70, h, 3, backward) == scratch_floats(2, 70, want, 3, backward)


def _tiny(hidden):
    return dict(embed_dim=64, depth=2, num_heads=2, patch_size=8, pretrain_img_size=32,
                lora_start_block=0, use_adapters=False, adapter_bottleneck=8, target_res=32,
                depth_head_hidden=hidden)


@pytest.mark.parametrize("hidden", [48, 80])
def test_intra_depth_loss_at_other_widths_matches_gd3d(hidden):
    """The port's Student.intra_depth_loss (K4's route: u per keypoint, the
    pair chain fused) at depth-head widths K4 now takes, against gd3d's jnp
    reference (gd3d/models/student.py pairwise_score_diff +
    gd3d/ops/losses.py pairwise_logistic_ranking_loss): the loss, and its
    gradients w.r.t. the keypoint features and the depth head's weights."""
    kw = _tiny(hidden)
    jst = JStudent(JStudentConfig(**kw))
    params = jax.tree_util.tree_map(np.asarray, jst.init(jax.random.key(hidden), img_size=32))
    st = Student(StudentConfig(**kw))
    st.load_state_dict(student_state_dict(params, st.cfg))
    rng = np.random.RandomState(hidden)
    n = 64
    feats = rng.randn(2, n, 64).astype(np.float32)
    depths = (rng.rand(2, n) * 3).astype(np.float32)
    valid = rng.rand(2, n) > 0.3
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    def jloss(p, f):
        return jst.intra_depth_loss(p, f, jnp.asarray(depths), jnp.asarray(valid), 0.05)

    want, (gp, gf) = jax.value_and_grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(feats))
    tf = torch.from_numpy(feats).requires_grad_(True)
    got = st.intra_depth_loss(tf, torch.from_numpy(depths), torch.from_numpy(valid), 0.05)
    got.backward()
    assert_close(float(got.detach()), float(want))
    assert_close(tf.grad.numpy(), np.asarray(gf))
    want_grads = student_state_dict(jax.tree_util.tree_map(np.asarray, gp), st.cfg)
    head = {name: p for name, p in st.named_parameters() if name.startswith("depth_diff_head")}
    assert head
    for name, p in head.items():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        assert_close(g, want_grads[name].numpy())


def _branch_sources(entry_file: str, branch: str, launcher: str):
    """The text of the source that defines `launcher`, which `branch` of the
    entry point in `entry_file` calls, with the csrc headers it includes."""
    entry = (CSRC / entry_file).read_text()
    body = entry[entry.index(branch):]
    assert re.match(rf"{re.escape(branch)}[^;]*\b{launcher}\(", body, re.S), branch
    defs = [f for f in CSRC.glob("*.cu")
            if re.search(rf"cudaError_t {launcher}\([^;]*\)\s*\{{", f.read_text())]
    assert len(defs) == 1, defs
    text = defs[0].read_text()
    for inc in re.findall(r'#include "([^"]+)"', text):
        text += (CSRC / inc).read_text()
    return text


@pytest.mark.parametrize("entry_file,branch,launcher", [
    ("flash_fwd.cu", "if (is_bf16)  // head dims 64, 128 and 256", "launch_fwd_bf16"),
    ("flash_bwd.cu", "if (is_bf16)  // head dims 64, 128 and 256", "launch_bwd_bf16"),
])
def test_bf16_head_dim_64_branch_reaches_the_hopper_kernels(entry_file, branch, launcher):
    """The bf16 branch of gd3d_flash_fwd and gd3d_flash_bwd (head dim 64,
    and 128 and 256 since those widths joined it) reaches kernels built on
    TMA (cp.async.bulk.tensor) and wgmma, and nothing of the Ampere route
    (mma.sync) is in their sources."""
    text = _branch_sources(entry_file, branch, launcher)
    assert "wgmma.mma_async" in text and "cp.async.bulk.tensor" in text
    assert "mma.sync" not in text


@pytest.mark.parametrize("branch,launcher,has,lacks", [
    ("if (is_bf16)  // above 256", "launch_fwd_cluster_bf16",
     ("wgmma.mma_async", "cp.async.bulk.tensor"), ("mma.sync",)),
    ("// fp32 above 256", "launch_fwd_cluster_tf32", ("mma.sync",), ("wgmma.mma_async",)),
])
def test_wide_branch_reaches_the_cluster_kernels(branch, launcher, has, lacks):
    """Above head dim 256 gd3d_flash_fwd sends bf16 to a source built on
    wgmma and TMA (cp.async.bulk.tensor) and fp32 to one on mma.sync (split
    TF32), and neither source reaches the chunked kernels (their code, the
    comments taken out)."""
    text = re.sub(r"//[^\n]*", "", _branch_sources("flash_fwd.cu", branch, launcher))
    assert all(x in text for x in has) and not any(x in text for x in lacks)
    assert "chunked" not in text


def test_chunked_forward_runs_only_past_the_clusters_reach():
    """gd3d_flash_fwd_route, which gd3d_flash_fwd dispatches on, names the
    cluster kernels above 256 up to their reach (cluster::kMaxDBf16 for
    bf16, cluster::kMaxD for fp32) and the chunked forward past it, and
    gd3d_flash_fwd launches the cluster launchers, both dtypes, on the one
    and the chunked forward on the other; the reaches (three and eight CTAs
    of four 64-column panels) are CLUSTER_MAX_D's, past 512, so no head dim
    up to 512 runs the chunked forward."""
    entry = (CSRC / "flash_fwd.cu").read_text()
    route = entry[entry.index('extern "C" int gd3d_flash_fwd_route'):]
    route = route[:route.index("\n}\n")]
    assert ("if (D > chunked::kChunk)\n    return D <= (is_bf16 ? cluster::kMaxDBf16 : "
            "cluster::kMaxD) ? kFwdCluster : kFwdChunked;") in route
    body = entry[entry.index('extern "C" int gd3d_flash_fwd('):]
    assert "const int route = gd3d_flash_fwd_route(D, is_bf16);" in body
    wide = body[body.index("if (route == kFwdCluster) {"):]
    head = wide[:wide.index("if (route == kFwdChunked)")]
    assert head.count("return static_cast<int>(cluster::launch_fwd_cluster_") == 2
    assert "launch_fwd_cluster_bf16(" in head and "launch_fwd_cluster_tf32(" in head
    assert "chunked::launch_fwd(" not in head
    chunked = wide[wide.index("if (route == kFwdChunked)"):]
    assert re.match(r"if \(route == kFwdChunked\)[^;]*chunked::launch_fwd\(", chunked, re.S)
    header = (CSRC / "flash_fwd_cluster.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (kMaxCtas|kMaxCtasBf16|kPanelCols) = (\d+);",
                             header))
    assert "constexpr int kMaxD = 4 * kPanelCols * kMaxCtas;" in header
    assert "constexpr int kMaxDBf16 = 4 * kPanelCols * kMaxCtasBf16;" in header
    panel = int(consts["kPanelCols"])
    assert 4 * panel * int(consts["kMaxCtas"]) == CLUSTER_MAX_D[torch.float32] > 512
    assert 4 * panel * int(consts["kMaxCtasBf16"]) == CLUSTER_MAX_D[torch.bfloat16] > 512
