"""Device resolution for the port's entry points.

Entry points run on the card: `--gpu N` selects `cuda:N`. The CPU is used
only when the caller asks for it (`--device cpu`, as the tests do); with no
CUDA device and no such request, resolution raises instead of falling back.
"""

from typing import Optional

import torch


def resolve_device(gpu: int = 0, device: Optional[str] = None) -> torch.device:
    """`device` "cpu" -> the CPU; otherwise `cuda:<gpu>`, which must exist."""
    if device is not None and device != "cpu":
        raise ValueError(f"device must be 'cpu' or unset (then --gpu picks the card), got {device!r}")
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    if not 0 <= gpu < torch.cuda.device_count():
        raise RuntimeError(f"--gpu {gpu}: only {torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", gpu)
