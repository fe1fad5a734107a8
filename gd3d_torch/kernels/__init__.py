"""Hand-written CUDA kernels of the port and their launch counters.

Each wrapper adds one to its `launches` count where it launches its kernel,
and nowhere else, so a run can show that its main path went through the
kernels. The flash wrappers (K1, K2) and K5 also count by dtype and
length (`launches_by`), at the same place.
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


def launch_counts() -> Dict[str, int]:
    return {k: fn.launches for k, fn in wrappers().items()}


def launch_counts_by() -> Dict[str, Dict[Tuple[str, int], int]]:
    """The flash kernels' and K5's launches split by operand dtype and
    sequence length N (the query count; q's for K5): kernel id ->
    {(dtype, N): launches}."""
    return {k: dict(fn.launches_by) for k, fn in wrappers().items()
            if hasattr(fn, "launches_by")}
