"""Sequence parallelism of attention over the token axis (counterpart of
gd3d/parallel/sequence.py): ring attention and the all-gather-KV variant.

The contract is gd3d's: GLOBAL (B, N, H, D) q, k and v in, the global
output out. Each of the n ranks takes its N / n query rows (rank i rows
i * N / n onwards) and its K/V block of the same rows; the output is
all-gathered along N. n must divide N.

Ring attention. Forward: each ring step runs K1 (kernels/flash_fwd.py) on
the local queries and the visiting K/V block, which gives (o_b, lse_b), and
merges it in fp32 into the running (o, lse):
lse = logsumexp(lse_a, lse_b), o = e^(lse_a - lse) o_a + e^(lse_b - lse) o_b,
which is gd3d's num / den / max merge. Then the blocks move one hop round
the ring, i -> (i + 1) % n (gd3d's ppermute). Backward
(`torch.autograd.Function`; gd3d differentiates its ring by autodiff):
di = rowsum(dO * O) of the merged O, and K2 (kernels/flash_bwd_fused.py)
on each visiting block with the global lse gives a partial dQ, summed
locally, and partial dK / dV, which travel with their block and reach its
owner after one more hop. The sums run in fp32 in a fixed order, with no
atomics, so a backward repeats its bits. The gradients of the global
inputs are all-gathered along N, as the output is.

The all-gather variant (the small-KV regime) all-gathers the K/V blocks and
runs one K1 call on them; its backward sums each rank's partial dK / dV in
rank order.

The compute is apart from the transport. A step takes the blocks that
visit it from a transport: `GroupTransport` moves them between the
processes of a model group (dist.batch_isend_irecv, sends and receives
posted together so that no two ranks wait on each other, and
dist.all_gather); `LoopbackTransport` holds all n ranks in one process,
so that one card can drive n virtual ranks through the very code that the
distributed path runs (chip_smoke.py does).

Shard lengths need not be a multiple of the kernels' 64-row tile (2748 / 4
= 687 at VGGT's 518^2 pair): K1 and K2 mask ragged lengths. The bf16 ring
merges bf16 block outputs in fp32, so it stays within the bf16 tolerance of
one whole-sequence K1.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from gd3d_torch.core.mesh import ModelGroup
from gd3d_torch.kernels.flash_bwd_fused import flash_attention_bwd_fused
from gd3d_torch.kernels.flash_fwd import flash_attention_fwd


class GroupTransport:
    """The ranks of a model group, one per process: this process holds the
    rank `ranks[0]` of the group."""

    def __init__(self, group: ModelGroup):
        self.n = group.size
        self.ranks = (group.rank,)
        self.group = group.group
        self.peers = group.ranks  # global ranks, in group order

    def shift(self, items: List[Tuple[torch.Tensor, ...]]) -> List[Tuple[torch.Tensor, ...]]:
        """Send this rank's tensors to rank + 1 and receive rank - 1's."""
        (mine,) = items
        r = self.ranks[0]
        dst, src = self.peers[(r + 1) % self.n], self.peers[(r - 1) % self.n]
        ops, got = [], []
        for tag, t in enumerate(mine):
            buf = torch.empty_like(t, memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, buf, src, self.group, tag))
            got.append(buf)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [tuple(got)]

    def gather(self, items: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every rank's tensor, in rank order."""
        (mine,) = items
        mine = mine.contiguous()
        parts = [torch.empty_like(mine) for _ in range(self.n)]
        dist.all_gather(parts, mine, group=self.group)
        return parts


class LoopbackTransport:
    """n virtual ranks in one process: the items of all n, in rank order."""

    def __init__(self, n: int):
        self.n = n
        self.ranks = tuple(range(n))

    def shift(self, items: List[Tuple[torch.Tensor, ...]]) -> List[Tuple[torch.Tensor, ...]]:
        return [items[(i - 1) % self.n] for i in range(self.n)]

    def gather(self, items: List[torch.Tensor]) -> List[torch.Tensor]:
        return list(items)


def _rows(t: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    L = t.shape[1] // n
    return t[:, rank * L:(rank + 1) * L]


def _merge(acc, block):
    """Two partial softmax results over disjoint key blocks, in fp32."""
    o_a, lse_a = acc
    o_b, lse_b = block
    lse = torch.logaddexp(lse_a, lse_b)
    w_a = torch.exp(lse_a - lse).transpose(1, 2)[..., None]  # (B, L, H, 1)
    w_b = torch.exp(lse_b - lse).transpose(1, 2)[..., None]
    return w_a * o_a + w_b * o_b.float(), lse


def ring_forward(qs, kvs, transport, scale: float):
    """The ring's forward for the ranks this process holds: qs[i] the
    local queries of transport.ranks[i], kvs[i] its (K, V) block. K1 on
    each visiting block, merged in fp32. Returns [(O in q's dtype, lse)]."""
    acc: List = [None] * len(qs)
    for step in range(transport.n):
        for i, q in enumerate(qs):
            o, lse = flash_attention_fwd(q, *kvs[i], scale)
            acc[i] = (o.float(), lse) if acc[i] is None else _merge(acc[i], (o, lse))
        if step < transport.n - 1:
            kvs = transport.shift(kvs)
    return [(o.to(q.dtype), lse) for (o, lse), q in zip(acc, qs)]


def ring_backward(qs, kvs, outs, lses, dos, transport, scale: float):
    """The ring's backward for the ranks this process holds: K2 on each
    visiting block with the global lse and di = rowsum(dO * O). Returns
    per rank (dQ, dK, dV) of its own rows, fp32."""
    dis = [torch.einsum("bnhd,bnhd->bhn", o.float(), do.float()).contiguous()
           for o, do in zip(outs, dos)]
    dq: List = [None] * len(qs)
    travel = [(k, v) for k, v in kvs]  # the block, then its dK and dV sums
    for step in range(transport.n):
        for i, q in enumerate(qs):
            k, v, *sums = travel[i]
            gq, gk, gv = flash_attention_bwd_fused(q, k, v, lses[i], dos[i], dis[i], scale)
            dq[i] = gq.float() if dq[i] is None else dq[i] + gq.float()
            dk, dv = (gk.float(), gv.float()) if not sums else (sums[0] + gk.float(),
                                                                 sums[1] + gv.float())
            travel[i] = (k, v, dk, dv)
        if step < transport.n - 1:
            travel = transport.shift(travel)
    sums = [(dk, dv) for _, _, dk, dv in travel]
    if transport.n > 1:  # each block's sums go home: one more hop
        sums = transport.shift(sums)
    return [(q_, k_, v_) for q_, (k_, v_) in zip(dq, sums)]


def allgather_forward(qs, kvs, transport, scale: float):
    """K and V all-gathered, then one K1 call per rank."""
    k_all = torch.cat(transport.gather([k for k, _ in kvs]), dim=1)
    v_all = torch.cat(transport.gather([v for _, v in kvs]), dim=1)
    return [flash_attention_fwd(q, k_all, v_all, scale) for q in qs], (k_all, v_all)


def allgather_backward(qs, kv_all, outs, lses, dos, transport, scale: float):
    """One K2 call per rank on the gathered K and V; the partial dK and dV
    of every rank summed in rank order, each rank keeping its rows."""
    n, ranks = transport.n, transport.ranks
    res, dks, dvs = [], [], []
    for q, o, lse, do in zip(qs, outs, lses, dos):
        di = torch.einsum("bnhd,bnhd->bhn", o.float(), do.float()).contiguous()
        gq, gk, gv = flash_attention_bwd_fused(q, *kv_all, lse, do, di, scale)
        res.append(gq.float())
        dks.append(gk.float())
        dvs.append(gv.float())
    dk = _sum_in_order(transport.gather(dks))
    dv = _sum_in_order(transport.gather(dvs))
    return [(gq, _rows(dk, r, n), _rows(dv, r, n)) for gq, r in zip(res, ranks)]


def _sum_in_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return total


class _SequenceParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, transport, scale, ring):
        n, ranks = transport.n, transport.ranks
        qs = [_rows(q, r, n) for r in ranks]
        kvs = [(_rows(k, r, n).contiguous(), _rows(v, r, n).contiguous()) for r in ranks]
        if ring:
            res, kv_all = ring_forward(qs, kvs, transport, scale), ()
        else:
            res, kv_all = allgather_forward(qs, kvs, transport, scale)
        outs = [o for o, _ in res]
        lses = [lse for _, lse in res]
        ctx.transport, ctx.scale, ctx.ring, ctx.m = transport, scale, ring, len(ranks)
        ctx.save_for_backward(q, k, v, *kv_all, *outs, *lses)
        return torch.cat(transport.gather(outs), dim=1)

    @staticmethod
    def backward(ctx, do):
        transport, m = ctx.transport, ctx.m
        n, ranks = transport.n, transport.ranks
        q, k, v, *rest = ctx.saved_tensors
        kv_all = () if ctx.ring else (rest.pop(0), rest.pop(0))
        outs, lses = rest[:m], rest[m:]
        qs = [_rows(q, r, n) for r in ranks]
        dos = [_rows(do, r, n) for r in ranks]
        if ctx.ring:
            kvs = [(_rows(k, r, n).contiguous(), _rows(v, r, n).contiguous()) for r in ranks]
            grads = ring_backward(qs, kvs, outs, lses, dos, transport, ctx.scale)
        else:
            grads = allgather_backward(qs, kv_all, outs, lses, dos, transport, ctx.scale)
        dq, dk, dv = (torch.cat(transport.gather([g[j] for g in grads]), dim=1).to(t.dtype)
                      for j, t in enumerate((q, k, v)))
        return dq, dk, dv, None, None, None


def _check(q, transport) -> None:
    N, n = q.shape[1], transport.n
    if N % n:
        raise ValueError(f"sequence parallelism splits the N={N} tokens over n={n} ranks; "
                         f"n must divide N")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, transport,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention of the global (B, N, H, D) q, k, v over the
    transport's n ranks; returns the global output (B, N, H, D)."""
    _check(q, transport)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _SequenceParallel.apply(q, k, v, transport, scale, True)


def allgather_kv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, transport,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Query-sharded attention with all-gathered K and V (gd3d's small-KV
    variant); the same contract as ring_attention."""
    _check(q, transport)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _SequenceParallel.apply(q, k, v, transport, scale, False)
