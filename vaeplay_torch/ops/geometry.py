"""Geometry -- port of vaeplay_tpu/ops/geometry.py (the ellipse sampler BP uses)."""

import math

import torch


def sample_points_ellipse(ellipse_params: torch.Tensor, sample_count: int = 720,
                          sample_scale: float = 2.0) -> torch.Tensor:
    """Sample points and outward unit normals on batched ellipses
    (reference networks_BP.py:154-174, one broadcast over the batch).

    ellipse_params (B, >=4) = cx, cy, rx, ry[, step], already /VALUE_WEIGHT.
    Returns f32 (B, S, 6): [px, py, dpx, dpy, sample-index, radian], where
    (dpx, dpy) is the normalized tangent rotated by -pi/2 (the outward
    normal) and sample-index = 0..S-1. All index math runs in f32."""
    p = ellipse_params.float()
    b = p.shape[0]
    cx, cy, rx, ry = (p[:, i, None] for i in range(4))
    ds = torch.arange(sample_count, dtype=torch.float32, device=p.device)
    radians = ds / sample_scale * (math.pi / 180.0)
    cos_t, sin_t = torch.cos(radians), torch.sin(radians)
    px = cx + rx * cos_t
    py = cy + ry * sin_t
    # unit tangent (rx*-sin, ry*cos), then rotate by -pi/2 -> (dpy, -dpx)
    dpx = rx * -sin_t
    dpy = ry * cos_t
    norm = torch.sqrt(dpx**2 + dpy**2)
    dpx, dpy = dpx / norm, dpy / norm
    dpx, dpy = dpy, -dpx
    idx = ds.expand(b, sample_count)
    rad = radians.expand(b, sample_count)
    return torch.stack([px, py, dpx, dpy, idx, rad], dim=-1)
