"""Hand-written CUDA kernels of the port and their launch counters.

Each wrapper adds one to its `launches` count where it launches its kernel,
and nowhere else, so a run can show that its main path went through the
kernels. The flash wrappers (K1, K2) and K5 also count by dtype and
length (`launches_by`), at the same place, and those that took the pad
route (`launches_padded`, K1 and K2: head dims whose rows are no multiple
of 16 bytes) and those above head dim 256 (`launches_wide`, read by
`launch_counts` as "K1 wide" and "K2 wide"); K1 also counts those by the
kernel that ran and dtype (`launches_wide_by`: the kernel as the
library's dispatch names it, gd3d_flash_fwd_route in flash_fwd.FWD_ROUTES'
words, "cluster" up to flash_fwd.CLUSTER_MAX_D, "chunked" past it; read by
`wide_launches`, its bf16 ones by `launch_counts` as "K1 wide bf16" and
those on the chunked kernels as "K1 chunked");
K5 counts its backward launches (-f0) apart as well (`launches_bwd`).
"""
from __future__ import annotations

from typing import Dict, Tuple


def wrappers() -> Dict[str, object]:
    """Kernel id -> wrapper function (holding the `launches` count). K4's
    backward (row pass, column pass and partial sums) is one wrapper of its
    own; K5's backward is K5 with -f0 and counts with its forward, and a
    launch that rotates q and k together (`rope2d_qk_fwd`) counts once."""
    from gd3d_torch.kernels.cost_kl import masked_softmax_kl_fwd
    from gd3d_torch.kernels.flash_bwd_fused import flash_attention_bwd_fused
    from gd3d_torch.kernels.flash_fwd import flash_attention_fwd
    from gd3d_torch.kernels.pairwise_rank import pairwise_rank_bwd, pairwise_rank_fwd
    from gd3d_torch.kernels.rope2d import rope2d_fwd

    return {
        "K1": flash_attention_fwd,
        "K2": flash_attention_bwd_fused,
        "K3": masked_softmax_kl_fwd,
        "K4": pairwise_rank_fwd,
        "K4b": pairwise_rank_bwd,
        "K5": rope2d_fwd,
    }


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_by"):
            fn.launches_by.clear()
        if hasattr(fn, "launches_bwd"):
            fn.launches_bwd = 0
        if hasattr(fn, "launches_padded"):
            fn.launches_padded = 0
        if hasattr(fn, "launches_wide"):
            fn.launches_wide = 0
        if hasattr(fn, "launches_wide_by"):
            fn.launches_wide_by.clear()


def launch_counts() -> Dict[str, int]:
    """Kernel id -> launches, and of K1's and K2's launches those above head
    dim 256 as "K1 wide" and "K2 wide", and of K1's those in bf16 as "K1
    wide bf16" and those on the chunked kernels (past the clusters' reach)
    as "K1 chunked"."""
    fns = wrappers()
    return {**{k: fn.launches for k, fn in fns.items()},
            **{f"{k} wide": fn.launches_wide for k, fn in fns.items()
               if hasattr(fn, "launches_wide")},
            **{f"{k} wide bf16": sum(n for (_, d), n in fn.launches_wide_by.items()
                                     if d == "bfloat16")
               for k, fn in fns.items() if hasattr(fn, "launches_wide_by")},
            **{f"{k} chunked": sum(n for (r, _), n in fn.launches_wide_by.items()
                                   if r == "chunked")
               for k, fn in fns.items() if hasattr(fn, "launches_wide_by")}}


def wide_launches() -> Dict[str, Dict[Tuple[str, str], int]]:
    """K1's launches above head dim 256 by the kernel that ran and dtype:
    {"K1": {(route, dtype): launches}}, route as the library's
    gd3d_flash_fwd_route reported it when it launched ("cluster" or
    "chunked")."""
    return {k: dict(fn.launches_wide_by) for k, fn in wrappers().items()
            if hasattr(fn, "launches_wide_by")}


def launch_counts_by() -> Dict[str, Dict[Tuple[str, int], int]]:
    """The flash kernels' and K5's launches split by operand dtype and
    sequence length N (the query count; q's for K5): kernel id ->
    {(dtype, N): launches}."""
    return {k: dict(fn.launches_by) for k, fn in wrappers().items()
            if hasattr(fn, "launches_by")}


def backward_launches() -> Dict[str, int]:
    """Of each kernel's launches, those of a backward where the kernel also
    runs forward (K5 with -f0): kernel id -> launches."""
    return {k: fn.launches_bwd for k, fn in wrappers().items() if hasattr(fn, "launches_bwd")}


def padded_launches() -> Dict[str, int]:
    """Of the flash kernels' launches, those on the pad route (operands
    zero-padded to the kernel width): kernel id -> launches."""
    return {k: fn.launches_padded for k, fn in wrappers().items()
            if hasattr(fn, "launches_padded")}

