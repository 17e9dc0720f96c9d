"""Mixed precision (bf16 compute, f32 state) -- the port of the policy of
vaeplay_tpu/utils/amp.py:

  * convolutions and GEMMs run in bfloat16 (`torch.autocast`);
  * master parameters, optimizer state, BatchNorm running buffers and every
    loss reduction stay float32: the parameters are never cast (autocast
    casts per op), so their gradients come back f32, and the steps cast the
    model's outputs to f32 before the losses (steps_vae.py:88 in the JAX
    package). No loss scaling: bf16 has f32's exponent range.

The JAX package's `merge_batch_stats` (amp.py:41-66) has no counterpart
here. flax folds the bf16 forward's statistics into a bf16 copy of the
running values, so the JAX package adds the delta back onto the f32 master
to keep increments below the bf16 ulp. torch's BatchNorm keeps its running
buffers in f32 and updates them in place from f32 batch statistics, even on
bf16 inputs, so nothing is requantized (tests/test_torch_train_vae.py holds
a sub-ulp increment).
"""

import torch


def resolve_dtype(name: str) -> torch.dtype:
    """The CLIs' --dtype string -> the compute dtype (f32/bf16 shorthands)."""
    if name in ("f32", "float32"):
        return torch.float32
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"unsupported --dtype {name!r}")


def autocast(device: torch.device, compute_dtype: torch.dtype) -> torch.autocast:
    """bf16 autocast on `device` for compute_dtype bfloat16; a disabled
    autocast (plain f32) for float32."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {compute_dtype} is neither float32 nor bfloat16")
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=compute_dtype == torch.bfloat16)
