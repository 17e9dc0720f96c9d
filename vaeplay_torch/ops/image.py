"""Image ops -- port of vaeplay_tpu/ops/image.py (the point sampler BP uses,
the max pool of BE's backbone).

The JAX package gathers the four bilinear corners itself and gives the
sampler a scatter-free backward (a custom VJP), both for the TPU. Here the
forward is torch's own `F.grid_sample` on a (B, 1, N, 2) grid, and its own
backward gives the gradient with respect to the features; the grid is
detached on BP's path, so no gradient reaches it, as in the custom VJP.
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


def max_pool(x: torch.Tensor, window: int, stride: int = None, padding: int = 0) -> torch.Tensor:
    """NCHW max pool, torch MaxPool2d semantics: the symmetric padding is
    -inf, as the JAX package's reduce_window pads (image.py:197-204)."""
    return F.max_pool2d(x, window, stride=stride or window, padding=padding)
