"""Small numeric primitives (counterpart of gd3d/ops/basic.py)."""
from __future__ import annotations

import torch


def temp_sigmoid(x: torch.Tensor, temp: float = 1.0) -> torch.Tensor:
    """1 / (1 + exp(clamp(-x / temp, -50, 50)))."""
    exponent = torch.clamp(-x / temp, -50.0, 50.0)
    return 1.0 / (1.0 + torch.exp(exponent))


def l2_normalize(x: torch.Tensor, axis: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), as torch.nn.functional.normalize(p=2)."""
    norm = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """sorted(x.reshape(-1))[k], 0-based. torch.kthvalue counts from 1.

    gd3d computes this by bisection only to avoid a sort on the TPU; here
    it is one selection. Not differentiable: consumers threshold on it."""
    return torch.kthvalue(x.detach().reshape(-1), int(k) + 1).values
