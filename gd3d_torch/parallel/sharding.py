"""Tensor parallelism of the transformer blocks over the model group
(counterpart of gd3d/parallel/sharding.py).

gd3d annotates each leaf with a PartitionSpec on its `model` mesh axis and
lets XLA insert the all-reduces: qkv, fc1, lora_b_* and CroCo's projq,
projk and projv column-parallel, proj and fc2 row-parallel, the rest
replicated. The port slices the parameters into plain local tensors and
puts Megatron's explicit pair of collectives into the blocks' forwards:

- f (`copy_to_model`): identity forward, all-reduce backward, at the input
  of a column-parallel product, so the gradient that leaves it is the sum
  of every rank's heads;
- g (`reduce_from_model`): all-reduce forward, identity backward, after a
  row-parallel product.

The flash kernels then see plain (B, N, H/n, D) views: no DTensor reaches
a kernel. `shard_module` slices, in place, every module whose class names a
TP_KIND (the blocks of the student ViT, CroCo's encoder and decoder with
its cross-attention, and VGGT's frame, global, DINOv2 and camera-trunk
blocks). Every rank must hold the same full weights before it slices (the
same seeded init, or the same converted state), so the slices of one model
group tile gd3d's weights.

Where the trouble lies:

- Fused qkv. gd3d shards the flat 3C output dim contiguously, and XLA keeps
  the math whatever the layout. Sliced that way, rank 0 would hold all of q
  and part of k; the port slices qkv by HEAD, rows t*C + h*D ... for t in
  (q, k, v) and the rank's heads h. lora_b_q and lora_b_v are sliced by the
  same heads; lora_a_* stays replicated, and its output passes through f
  before lora_b, so its gradient is the whole one on every rank.
- Row-parallel biases. proj.bias and fc2.bias are added once, after g's
  all-reduce, not on every rank.
- Head-mean exports. CroCo's cross-attention map and VGGT's cross-frame
  map average over all H heads: the blocks sum their local heads, all-reduce
  the sum over the model group (`model_sum`) and divide by the global H.
- Tensor and sequence parallelism on one group. The train CLI rides VGGT's
  ring on the model group, whose ranks hold different heads: the global
  blocks gather the heads (`gather_heads`) before the ring and keep their
  own after it (`split_heads`), as gd3d's partitioner reshards the heads
  for its ring's shard_map.

What stays replicated (whole on every rank): the patch embeds, position
embeddings and tokens, every LayerNorm, LayerScale and qk-norm, the
adapters, lora_a_*, the student's depth head and refine conv, MASt3R's DPT
heads and local-feature MLP, VGGT's DPT heads and track head, and any block
whose head count (or MLP width) the model size does not divide: gd3d keeps
such a LEAF replicated, the port keeps the whole module (`shard_module`
returns their names).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from gd3d_torch.core.mesh import ModelGroup
from gd3d_torch.models.promote import Linear as PromoteLinear


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model group, on a fresh tensor; bf16 and fp16 are
    summed in fp32 and rounded once."""
    out = x.detach().to(torch.promote_types(x.dtype, torch.float32)).contiguous().clone()
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, tp: Optional[ModelGroup]) -> torch.Tensor:
    """f at the input of a column-parallel product (the identity without
    tensor parallelism)."""
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: Optional[ModelGroup]) -> torch.Tensor:
    """g after a row-parallel product (the identity without tensor
    parallelism)."""
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


def model_sum(x: torch.Tensor, tp: Optional[ModelGroup]) -> torch.Tensor:
    """A sum over the model group with no gradient: the head sums of the
    exported attention maps."""
    return x if tp is None else _all_reduce(x, tp.group)


def _all_gather_heads(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(tp.size)]
    dist.all_gather(parts, x.contiguous(), group=tp.group)
    return torch.cat(parts, dim=2)


class _GatherHeads(torch.autograd.Function):
    """All-gather forward along the head dim, this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_gather_heads(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.tp.size, dim=2)[ctx.tp.rank], None


class _SplitHeads(torch.autograd.Function):
    """This rank's slice forward along the head dim, all-gather backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.chunk(tp.size, dim=2)[tp.rank]

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_heads(grad, ctx.tp), None


def gather_heads(x: torch.Tensor, tp: Optional[ModelGroup]) -> torch.Tensor:
    """(B, N, H/n, D) heads of every model rank -> (B, N, H, D), the same on
    each: what a sequence-parallel ring over the model group needs, since
    the model group holds the heads apart (gd3d's partitioner reshards the
    heads the same way before its ring)."""
    return x if tp is None else _GatherHeads.apply(x, tp)


def split_heads(x: torch.Tensor, tp: Optional[ModelGroup]) -> torch.Tensor:
    """(B, N, H, D) -> this rank's (B, N, H/n, D) (the inverse of
    gather_heads; its backward gathers the heads' gradients)."""
    return x if tp is None else _SplitHeads.apply(x, tp)


def row_parallel(linear: nn.Linear, x: torch.Tensor, tp: Optional[ModelGroup]) -> torch.Tensor:
    """A row-parallel Linear: this rank's columns of the weight on its
    slice of the features, g, then the bias once. It computes in the dtype
    the layer itself would (models/promote.py for the promoting Linear)."""
    if tp is None:
        return linear(x)
    w = linear.weight
    if isinstance(linear, PromoteLinear):
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    out = reduce_from_model(F.linear(x, w), tp)
    return out if linear.bias is None else out + linear.bias.to(out.dtype)


@dataclasses.dataclass
class TPSlice:
    """How a parameter was sliced: along `dim` of its `full` length, rank
    m of the model group keeping the entries `indices[m]`."""

    dim: int
    full: int
    indices: Tuple[torch.Tensor, ...]
    tp: ModelGroup


def tp_slice(p: torch.Tensor) -> Optional[TPSlice]:
    """The slicing of a parameter that `shard_module` sliced, else None."""
    return getattr(p, "tp_slice", None)


def _slice_param(linear: nn.Linear, name: str, dim: int, indices: List[torch.Tensor],
                 tp: ModelGroup) -> None:
    old = getattr(linear, name)
    idx = indices[tp.rank]
    new = nn.Parameter(old.detach().index_select(dim, idx.to(old.device)).clone(),
                       requires_grad=old.requires_grad)
    new.tp_slice = TPSlice(dim, old.shape[dim], tuple(indices), tp)
    setattr(linear, name, new)


def _columns(linear: nn.Linear, indices, tp) -> None:
    """Column-parallel: keep the rows (output features) `indices[rank]`."""
    _slice_param(linear, "weight", 0, indices, tp)
    if linear.bias is not None:
        _slice_param(linear, "bias", 0, indices, tp)
    linear.out_features = len(indices[tp.rank])


def _rows(linear: nn.Linear, indices, tp) -> None:
    """Row-parallel: keep the input features `indices[rank]`; the bias
    stays whole (added once, after the all-reduce)."""
    _slice_param(linear, "weight", 1, indices, tp)
    linear.in_features = len(indices[tp.rank])


def _head_ranges(H: int, D: int, n: int, offsets=(0,)) -> List[torch.Tensor]:
    """Per model rank, the feature indices of its H/n heads of width D,
    repeated at each offset (the q, k and v thirds of a fused qkv)."""
    per = H // n
    return [torch.cat([torch.arange(o + m * per * D, o + (m + 1) * per * D) for o in offsets])
            for m in range(n)]


def shard_module(root: nn.Module, tp: ModelGroup) -> List[str]:
    """Slice every tensor-parallel module under `root` to this rank's part,
    in place, and hand it `tp`. Returns the names of the modules kept whole
    (their head count or width not divisible by the model size)."""
    n = tp.size
    whole = []
    if n == 1:
        return whole
    for name, m in root.named_modules():
        kind = getattr(type(m), "TP_KIND", None)
        if kind is None:
            continue
        if kind == "mlp":
            hidden = m.fc1.out_features
            if hidden % n:
                whole.append(name)
                continue
            idx = [torch.arange(r * hidden // n, (r + 1) * hidden // n) for r in range(n)]
            _columns(m.fc1, idx, tp)
            _rows(m.fc2, idx, tp)
        else:
            H = m.num_heads
            if H % n:
                whole.append(name)
                continue
            C = m.proj.in_features
            D = C // H
            heads = _head_ranges(H, D, n)
            if kind == "attention":  # fused qkv, sliced by head in each third
                _columns(m.qkv, _head_ranges(H, D, n, (0, C, 2 * C)), tp)
                for lora in ("lora_b_q", "lora_b_v"):
                    if getattr(m, lora, None) is not None:
                        _columns(getattr(m, lora), heads, tp)
            elif kind == "cross_attention":
                for proj in (m.projq, m.projk, m.projv):
                    _columns(proj, heads, tp)
            else:
                raise ValueError(f"{name}: unknown TP_KIND {kind!r}")
            _rows(m.proj, heads, tp)
            m.num_heads = H // n
        m.tp = tp
    return whole


def gather_full(t: torch.Tensor, spec: Optional[TPSlice]) -> torch.Tensor:
    """The whole tensor from every model rank's slice `t` (a parameter,
    its gradient or an AdamW moment of it); `t` itself where the parameter
    is not sliced. Collective over the model group."""
    if spec is None:
        return t
    parts = [torch.empty_like(t) for _ in range(spec.tp.size)]
    dist.all_gather(parts, t.contiguous(), group=spec.tp.group)
    shape = list(t.shape)
    shape[spec.dim] = spec.full
    full = t.new_empty(shape)
    for idx, part in zip(spec.indices, parts):
        full.index_copy_(spec.dim, idx.to(t.device), part)
    return full


def local_part(full: torch.Tensor, spec: Optional[TPSlice]) -> torch.Tensor:
    """This rank's slice of a whole tensor (the inverse of gather_full)."""
    if spec is None:
        return full
    return full.index_select(spec.dim, spec.indices[spec.tp.rank].to(full.device))


def clip_grad_norm_(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """torch.nn.utils.clip_grad_norm_ on gd3d's global norm: the squares
    of the sliced parameters' gradients summed over the model group, those
    of the replicated ones counted once."""
    params = list(params)
    sliced = [p for p in params if tp_slice(p) is not None]
    if not sliced:
        return torch.nn.utils.clip_grad_norm_(params, max_norm)
    whole = [p for p in params if tp_slice(p) is None]
    sq = torch.stack([p.grad.detach().float().pow(2).sum() for p in sliced]).sum()
    dist.all_reduce(sq, group=tp_slice(sliced[0]).tp.group)
    if whole:
        sq = sq + torch.stack([p.grad.detach().float().pow(2).sum() for p in whole]).sum()
    total = sq.sqrt()
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for p in params:
        p.grad.detach().mul_(coef.to(p.grad.dtype))
    return total
