"""Image ops -- port of vaeplay_tpu/ops/image.py (the point sampler BP uses).

The JAX package gathers the four bilinear corners itself and gives the
sampler a scatter-free backward, both for the TPU. Here the forward is
torch's own `F.grid_sample` on a (B, 1, N, 2) grid; the grid is detached on
BP's path, and inference needs no backward.
"""

import torch
import torch.nn.functional as F


def grid_sample(feat: torch.Tensor, grid: torch.Tensor, align_corners: bool = False,
                mode: str = "bilinear") -> torch.Tensor:
    """Sample an NCHW map `feat` (B, C, H, W) at points `grid` (B, N, 2),
    normalized [-1, 1] (x, y) coordinates, with zero padding outside.
    Returns (B, N, C) in feat's dtype; the sampling runs in f32."""
    out = F.grid_sample(feat.float(), grid.float()[:, None], mode=mode,
                        padding_mode="zeros", align_corners=align_corners)
    return out[:, :, 0, :].transpose(1, 2).to(feat.dtype)


def point_sample_ng(feat: torch.Tensor, grid: torch.Tensor, align_corners: bool = False,
                    mode: str = "bilinear") -> torch.Tensor:
    """`grid_sample` at a non-differentiable (detached) grid, as BP's stage 2
    samples its ellipse points (reference networks_BP.py:256 detaches)."""
    return grid_sample(feat, grid.detach(), align_corners=align_corners, mode=mode)
