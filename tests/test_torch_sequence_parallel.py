"""Sequence parallelism (gd3d_torch/parallel/sequence.py) against gd3d's
gd3d/parallel/sequence.py, on the CPU.

- ring_attention and allgather_kv_attention over a model group of 2 and of
  4 gloo ranks (tests/torch_parallel_worker.py), against gd3d's on a
  2-device mesh at gd3d's test shape (1, 64, 2, 8): the output and the
  gradients of sum(out * w) (jax.grad of gd3d's), rtol 1e-4, atol 1e-5; a
  second backward repeats its bits. On the CPU the K1 / K2 wrappers run
  their plain twins, the blocks the kernels would take on the card.
- The same through the loopback transport (n virtual ranks in one
  process, the route chip_smoke.py drives on the card), at n = 2, 3 and 4,
  and at shard lengths of 3 rows, off any tile.
- The VGGT teacher with the aggregator's global attention on the ring over
  a model group of 2 (a 1 x 2 mesh with 2 ranks, 2 x 2 with 4), against
  gd3d's plain single-device extract_features on 2 pairs, at gd3d's own
  bound for this comparison (tests/test_sequence_parallel_vggt.py: rtol
  2e-2, atol 2e-4). Measured on this CPU, at 2 and 4 ranks: at most
  1.3e-4 absolute (point_map_view_1, whose near-zero entries give 7.7e-3
  relative), 3e-7 on the cost volumes, 6.5e-5 on the confidences; the
  port's plain run (no ring) on the same ranks deviates from gd3d as much
  (1.3e-4 absolute), so the ring adds only fp32 reassociation.
- The same with the teacher also sliced tensor-parallel over that group
  (the train CLI's layout under --fsdp-teacher), at the TP teacher's bound
  (rtol 5e-4, atol 5e-5).
- n must divide N: a ValueError names both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from gd3d.core.mesh import make_mesh
from gd3d.parallel.sequence import allgather_kv_attention as jallgather
from gd3d.parallel.sequence import ring_attention as jring
from gd3d_torch.parallel.sequence import (
    LoopbackTransport, allgather_kv_attention, ring_attention)
from test_torch_tensor_parallel import VGGT_KW, vggt_reference
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)
FNS = {"ring": (ring_attention, jring), "allgather": (allgather_kv_attention, jallgather)}


def _qkvw(N=64, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(1, N, 2, 8).astype(np.float32) for _ in range(4))


def _gd3d(fn, qkv, w):
    mesh = make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])

    def loss(q, k, v):
        return (fn(q, k, v, mesh) * jnp.asarray(w)).sum()

    out, grads = jax.jit(lambda *a: (fn(*a, mesh), jax.grad(loss, argnums=(0, 1, 2))(*a)))(
        *(jnp.asarray(x) for x in qkv))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def gd3d_runs():
    """gd3d's results at N = 64 (the group runs) and N = 48 (loopback)."""
    return {(name, N): _gd3d(jfn, qkv, w) for name, (_, jfn) in FNS.items()
            for N, (*qkv, w) in ((64, _qkvw()), (48, _qkvw(N=48, seed=1)))}


@pytest.fixture(scope="module")
def vggt():
    return vggt_reference(B=2)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def runs(request, vggt, tmp_path_factory):
    world = request.param
    *qkv, w = _qkvw()
    state, rgb, _ = vggt
    jobs = {"ring": dict(job="ring", n_model=world, qkv=tuple(qkv), w=w),
            "vggt_sp": dict(job="teacher", kind="vggt", sp=True, n_model=2, teacher_kw=VGGT_KW,
                            teacher_state=state, images=(rgb,), temperature=0.9),
            "vggt_tp_sp": dict(job="teacher", kind="vggt", sp=True, tp=True, n_model=2,
                               teacher_kw=VGGT_KW, teacher_state=state, images=(rgb,),
                               temperature=0.9)}
    out = tmp_path_factory.mktemp(f"sp{world}")
    worker.spawn(world, jobs, out)
    return world, {name: worker.load(out, name, world) for name in jobs}


@pytest.mark.parametrize("name", list(FNS))
def test_group_attention_matches_gd3d(gd3d_runs, runs, name):
    want_o, want_g = gd3d_runs[name, 64]
    for res in runs[1]["ring"]:
        got = res[name]
        np.testing.assert_allclose(got["out"], want_o, **TOL)
        for g, wg, what in zip(got["grads"], want_g, "qkv"):
            np.testing.assert_allclose(g, wg, err_msg=f"d{what}", **TOL)
        assert got["repeat"]


@pytest.mark.parametrize("job,tol", [("vggt_sp", dict(rtol=2e-2, atol=2e-4)),
                                     ("vggt_tp_sp", dict(rtol=5e-4, atol=5e-5))])
def test_vggt_sequence_parallel_matches_plain(vggt, runs, job, tol):
    """The ring alone at gd3d's bound; the ring with the teacher sliced over
    the same model group (the train CLI's layout: the heads gathered for
    the ring) at the TP teacher's bound of test_torch_tensor_parallel.py."""
    want = vggt[2]
    for res in runs[1][job]:
        assert (res["sliced"] > 0) == (job == "vggt_tp_sp")
        per = 2 // res["n_data"]
        rows = slice(res["data_rank"] * per, (res["data_rank"] + 1) * per)
        for k, v in res["features"].items():
            np.testing.assert_allclose(v, want[k][rows], err_msg=k, **tol)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("name", list(FNS))
def test_loopback_matches_gd3d(gd3d_runs, name, n):
    """n virtual ranks in one process; N = 48 splits 2, 3 and 4 ways
    (gd3d's reference needs only the function, not the split)."""
    *qkv, w = _qkvw(N=48, seed=1)
    fn = FNS[name][0]
    want_o, want_g = gd3d_runs[name, 48]
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in qkv)
    out = fn(q, k, v, LoopbackTransport(n))
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (q, k, v))
    np.testing.assert_allclose(out.detach().numpy(), want_o, **TOL)
    for g, wg in zip(grads, want_g):
        np.testing.assert_allclose(g.numpy(), wg, **TOL)


def test_ragged_shards_and_indivisible_length():
    """Shards of 3 rows (12 tokens over 4 ranks) against one whole-sequence
    softmax, with their gradients; 12 tokens over 5 ranks raise."""
    *qkv, w = _qkvw(N=12, seed=2)
    q, k, v = (torch.from_numpy(x).double().requires_grad_(True) for x in qkv)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * 8 ** -0.5
    want = torch.einsum("bhnm,bmhd->bnhd", s.softmax(-1), v)
    wt = torch.from_numpy(w).double()
    want_g = torch.autograd.grad((want * wt).sum(), (q, k, v))
    for fn in (ring_attention, allgather_kv_attention):
        qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
        out = fn(qf, kf, vf, LoopbackTransport(4))
        grads = torch.autograd.grad((out * wt.float()).sum(), (qf, kf, vf))
        np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(), **TOL)
        for g, wg in zip(grads, want_g):
            np.testing.assert_allclose(g.numpy(), wg.numpy(), **TOL)
        with pytest.raises(ValueError, match="N=12 .* n=5"):
            fn(qf, kf, vf, LoopbackTransport(5))
