"""flax.linen's default initialisers on a torch module, from a seeded
generator: what gd3d's `model.init` draws for the nets it trains from
scratch (the pretraining CLI's).

- Dense and Conv kernels: lecun_normal, a normal truncated at two standard
  deviations with std sqrt(1 / fan_in) / 0.8796..., fan_in the input
  features times the kernel's receptive field (for a ConvTranspose too,
  whose flax kernel is (kh, kw, in, out));
- biases 0, LayerNorm scales 1 and biases 0;
- named extra parameters (`mask_token`): N(0, 0.02).

torch's own nn.Linear default is a uniform about sqrt(3) narrower with
non-zero biases: a run from it would train another model.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

# flax's variance_scaling "truncated_normal": the std of a unit normal
# truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def flax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter of `module` in place, in the order of
    named_modules(). Raises on a parameterised module it does not know."""
    with torch.no_grad():
        for name, mod in module.named_modules():
            own = list(mod.named_parameters(recurse=False))
            if not own:
                continue
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                continue
            if isinstance(mod, nn.Linear):
                fan_in = mod.in_features
            elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
            else:
                for pname, p in own:
                    if pname != "mask_token":
                        raise ValueError(f"flax_init_: no flax initialiser for {name}.{pname} "
                                         f"({type(mod).__name__})")
                    p.normal_(0.0, 0.02, generator=generator)
                continue
            lecun_normal_(mod.weight, fan_in, generator)
            if mod.bias is not None:
                mod.bias.zero_()
