"""Bit-packed binary masks -- port of vaeplay_tpu/models/bc.py:pack_mask_bits
(:225-233) and vaeplay_tpu/train/steps_bc.py:unpack_mask_bits (:120-125).

A thresholded mask crosses from the device to the host as one bit a pixel,
packed along W, most significant bit first: the layout `np.unpackbits`
reads. Copying a (B, H, W) mask back so costs 1/32 of its f32 map. The BE
serving path (train/steps_be.py:make_be_eval_step_packed) packs on the
device; BC's contour bridge reuses both functions.
"""

import numpy as np
import torch

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_mask_bits(binary: torch.Tensor) -> torch.Tensor:
    """(B, H, W) {0, 1} (bool or any integer dtype) -> (B, H, ceil(W / 8))
    uint8 on the same device, in np.unpackbits order; W is zero-padded to a
    multiple of 8."""
    b, h, w = binary.shape
    bits = binary.to(torch.uint8)
    pad = (-w) % 8
    if pad:
        bits = torch.cat([bits, bits.new_zeros(b, h, pad)], dim=2)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=bits.device)
    return (bits.view(b, h, -1, 8) * weights).sum(dim=-1).to(torch.uint8)


def unpack_mask_bits(packed, width: int) -> np.ndarray:
    """(B, H, ceil(W / 8)) uint8 on the host -> (B, H, width) float32 {0, 1}."""
    bits = np.unpackbits(np.asarray(packed, np.uint8), axis=-1)
    return bits[:, :, :width].astype(np.float32)
