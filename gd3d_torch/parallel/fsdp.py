"""The frozen teacher's weights sharded over the data-parallel ranks
(counterpart of gd3d/parallel/fsdp.py), with FSDP2.

gd3d shards each large leaf of the teacher's tree over its `data` mesh axis
and lets XLA gather it where the computation meets it (ZeRO-3's inference
half: a frozen teacher has no gradient to reduce-scatter). The port applies
`torch.distributed.fsdp.fully_shard` per block: each transformer block (a
child of an nn.ModuleList), then each other module that owns a large
parameter itself, deepest first. A unit's forward gathers its full
parameters before it runs and frees them after, so the kernels see plain,
unsharded tensors. gd3d's rule of thumb decides what is sharded: a
parameter of at least MIN_FSDP_SIZE elements with a dim that the world size
divides goes on its largest such dim; every other parameter stays
replicated (FSDP2's ignored_params).

The teacher's trunk is cast to its run dtype before it is sharded (the
bf16 trunk of teacher_dtype "bfloat16", heads fp32): the gathered weights
are then what the teacher's per-call cast would give, and extract_features
finds nothing left to cast.

With `with_tp` on a data x model mesh (gd3d's with_tp, mesh.model > 1) the
tensor-parallel slicing comes first (parallel/sharding.py), and FSDP then
shards the TP-local parameters over the DATA group's sub-mesh: the 2D
(fsdp x tp) layout. shard_dim's rule applies to the local shapes; which dim
it picks changes no number, since FSDP gathers a unit's parameters before
it computes.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from gd3d_torch.core.mesh import DataParallel

# parameters below this stay replicated: gathering a LayerNorm vector costs
# more in latency than its bytes save (gd3d's MIN_FSDP_SIZE)
MIN_FSDP_SIZE = 2 ** 16


def shard_dim(p: torch.Tensor, world: int, min_size: int = MIN_FSDP_SIZE) -> Optional[int]:
    """The dim a parameter is sharded on: its largest dim that `world`
    divides, for a parameter of at least `min_size` elements; None keeps it
    replicated."""
    if p.numel() < min_size:
        return None
    for d in sorted(range(p.dim()), key=lambda d: -p.shape[d]):
        if p.shape[d] % world == 0 and p.shape[d] >= world:
            return d
    return None


def _units(model: nn.Module, world: int, min_size: int) -> List[nn.Module]:
    """The modules to wrap, deepest first: the blocks (children of a
    ModuleList) that hold a shardable parameter, then every other module
    that owns one directly and lies in no block."""
    def shardable(ps):
        return any(shard_dim(p, world, min_size) is not None for p in ps)

    blocks = [m for lst in model.modules() if isinstance(lst, nn.ModuleList)
              for m in lst if shardable(m.parameters())]
    in_block = {id(m) for b in blocks for m in b.modules()}
    owners = [(name, m) for name, m in model.named_modules()
              if id(m) not in in_block and shardable(m.parameters(recurse=False))]
    owners.sort(key=lambda nm: -nm[0].count("."))
    return blocks + [m for _, m in owners]


def shard_teacher(teacher: nn.Module, dp: DataParallel, device: torch.device,
                  trunk_dtype: Optional[torch.dtype] = None,
                  min_size: int = MIN_FSDP_SIZE, with_tp: bool = False) -> Tuple[int, int]:
    """Shard `teacher.model` over the data-parallel ranks of `dp`, in place,
    after slicing it over dp's model group with `with_tp`. With
    `trunk_dtype`, the teacher's TRUNK parameters (those its teacher_dtype
    casts) are cast to it first. Returns (bytes sharded, total bytes) of
    this rank's (TP-local) parameters, gd3d's sharded_fraction."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    model = teacher.model
    if with_tp and dp.model.size > 1:
        from gd3d_torch.parallel.sharding import shard_module

        whole = shard_module(model, dp.model)
        if whole:
            print(f"tensor parallel teacher: {len(whole)} modules kept whole "
                  f"(not divisible by {dp.model.size}): {whole[:4]}")
    if trunk_dtype is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.startswith(teacher.TRUNK):
                    p.data = p.data.to(trunk_dtype)
    world = dp.world
    sharded = sum(p.numel() * p.element_size() for p in model.parameters()
                  if shard_dim(p, world, min_size) is not None)
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    replicated = {p for p in model.parameters() if shard_dim(p, world, min_size) is None}
    mesh = (init_device_mesh(device.type, (world,)) if dp.group is None
            else DeviceMesh.from_group(dp.group, device.type))

    def placement(p):
        d = shard_dim(p, world, min_size)
        return None if d is None else Shard(d)

    for unit in _units(model, world, min_size):
        fully_shard(unit, mesh=mesh, reshard_after_forward=True,
                    shard_placement_fn=placement,
                    ignored_params={p for p in unit.parameters() if p in replicated})
    return sharded, total
