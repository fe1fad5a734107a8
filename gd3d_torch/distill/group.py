"""K-step groups: the helpers build_mast3r_train_multistep and
build_vggt_train_multistep share (gd3d runs a group as one lax.scan over
the single step; here the K steps run in order)."""
from __future__ import annotations

from typing import Dict, List

import torch


def unstack(batches: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """A (K, ...) batch stack -> its K batches, in order (views, no copy)."""
    K = next(iter(batches.values())).shape[0]
    return [{k: v[i] for k, v in batches.items()} for i in range(K)]


def stack_metrics(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """K steps' metrics -> each metric stacked to (K,), on the device."""
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}
