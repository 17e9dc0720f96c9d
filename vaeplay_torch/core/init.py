"""Parameter initializers matching the reference's init schemes.

Port of vaeplay_tpu/core/init.py, on torch's (out, in, kh, kw) conv and
(out, in) linear layouts, drawn from an explicit `torch.Generator`:

  * Kaiming-uniform fan-in / relu for convs, zero bias
    (reference tools/ops.py:216-229, `initialize_model`).
  * Kaiming-uniform with a=sqrt(5) for linear layers (same function).

Distribution-level parity (same family and bounds), not bitwise RNG parity
with the JAX package, is the contract: the two frameworks draw different
numbers from one seed.
"""

import math
from typing import Optional

import torch


def _fan_in(weight: torch.Tensor) -> int:
    """in * kh * kw for a conv weight, in for a linear weight (torch's
    _calculate_fan_in_and_fan_out)."""
    if weight.dim() < 2:
        return int(weight.shape[0])
    return int(weight.shape[1]) * int(math.prod(weight.shape[2:]))


@torch.no_grad()
def kaiming_uniform_(weight: torch.Tensor, a: float = 0.0,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torch.nn.init.kaiming_uniform_ (mode=fan_in) from `generator`:
    gain = sqrt(2 / (1 + a^2)); bound = gain * sqrt(3 / fan_in)."""
    gain = math.sqrt(2.0 / (1.0 + a * a))
    bound = gain * math.sqrt(3.0 / _fan_in(weight))
    return weight.uniform_(-bound, bound, generator=generator)


def conv_kaiming_(weight: torch.Tensor, generator: Optional[torch.Generator] = None):
    return kaiming_uniform_(weight, 0.0, generator)


def dense_kaiming_(weight: torch.Tensor, generator: Optional[torch.Generator] = None):
    return kaiming_uniform_(weight, math.sqrt(5.0), generator)


@torch.no_grad()
def zeros_(tensor: torch.Tensor) -> torch.Tensor:
    return tensor.zero_()
