"""Geometry -- port of vaeplay_tpu/ops/geometry.py: the circle helpers of the
VAE-GAN (reference tools/utils.py:13-64) and the ellipse sampler BP uses."""

import math
from typing import Dict

import numpy as np
import torch


def generate_circle_param(rng: np.random.Generator, n: int, min_radius: int) -> Dict[str, int]:
    """Random circle fully inside an n x n image (reference tools/utils.py:13-22)."""
    half_n = n // 2
    radius = int(rng.integers(low=min_radius, high=half_n - min_radius))
    center_x = radius + int(rng.integers(low=0, high=n - 2 * radius))
    center_y = radius + int(rng.integers(low=0, high=n - 2 * radius))
    return {"radius": radius, "x": center_x, "y": center_y}


def render_circle_batch(n: int, radius: torch.Tensor, center_x: torch.Tensor,
                        center_y: torch.Tensor) -> torch.Tensor:
    """Filled circles as f32 (B, 1, n, n) images of 0 and 1 on the device of
    `radius`: inside = dx^2 + dy^2 <= r^2 on an f32 pixel grid (reference
    tools/utils.py:24-42 and 66-71, value 255 -> 1.0)."""
    coords = torch.arange(n, dtype=torch.float32, device=radius.device)
    xv = coords[None, None, :] - center_x.float()[:, None, None]
    yv = coords[None, :, None] - center_y.float()[:, None, None]
    inside = (xv**2 + yv**2) <= (radius.float()[:, None, None] ** 2)
    return inside.float()[:, None]


def encode_circle_param(n: int, radius, center_x, center_y) -> Dict[str, torch.Tensor]:
    """log-radius and centers in [-1, 1] (reference tools/utils.py:44-53)."""
    half = n // 2
    return {"radius": torch.log(radius / n), "x": (center_x - half) / half,
            "y": (center_y - half) / half}


def decode_circle_param(n: int, c_radius, c_x, c_y) -> Dict[str, torch.Tensor]:
    """Inverse of encode_circle_param (reference tools/utils.py:55-64)."""
    half = n // 2
    return {"radius": torch.exp(c_radius) * n, "x": c_x * half + half, "y": c_y * half + half}


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
