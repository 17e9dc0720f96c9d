"""Batched affine warping on the device -- port of vaeplay_tpu/ops/warp.py.

The reference augments each sample on the host with PIL/torchvision
(BTransform, datasets/dataset.py:105-145). Here, as in the JAX package, one
joint random rotation and flip runs batched on the device, with the same
parameters for an image and its masks: one inverse-mapped gather per tensor.

The draws (an angle in +-30 degrees, a vertical and a horizontal flip bit per
sample) come from an explicit torch.Generator on the device, or are passed
in, so that a test can hand the JAX function's draws to this one.
"""

import math
from typing import Optional, Sequence, Tuple

import torch

Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # angles (B,), vflip (B,), hflip (B,)
MAX_DEG = 30.0  # rotations in +-30 degrees (dataset.py:118-144)
IMG_FILL, MASK_FILL = 1.0, 0.0  # white page outside the rotated image, no mask there


def _gather(imgs: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor, fill: float) -> torch.Tensor:
    """imgs (B, C, H, W) at integer source coords xi, yi (B, H, W); `fill`
    where they fall outside."""
    b, c, h, w = imgs.shape
    inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).view(b, 1, h * w).expand(b, c, h * w)
    vals = imgs.reshape(b, c, h * w).gather(2, idx).view(b, c, h, w)
    return torch.where(inb[:, None], vals, torch.full_like(vals, fill))


def affine_warp(imgs: torch.Tensor, inv_matrices: torch.Tensor, fill: float) -> torch.Tensor:
    """Warp each NCHW image by its inverse affine map (B, 2, 3) with nearest
    sampling: output pixel (x, y) reads source round(M @ [x, y, 1]), halves
    rounded to even (jnp.round's rule, which torch.round shares), `fill`
    outside. (The JAX package's bilinear mode has no caller and is not
    ported.)"""
    b, c, h, w = imgs.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=imgs.dtype, device=imgs.device),
                            torch.arange(w, dtype=imgs.dtype, device=imgs.device), indexing="ij")
    m = inv_matrices.to(imgs.dtype)[:, :, :, None, None]
    fx = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]
    fy = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    return _gather(imgs, torch.round(fx).long(), torch.round(fy).long(), fill)


def rotation_inv_matrix(angles_deg: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B,) angles in degrees (counter-clockwise positive) -> (B, 2, 3)
    inverse maps rotating about the centre ((w - 1) / 2, (h - 1) / 2)."""
    theta = -angles_deg * (math.pi / 180.0)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    c, s = torch.cos(theta), torch.sin(theta)
    m00, m01, m10, m11 = c, -s, s, c
    tx = cx - (m00 * cx + m01 * cy)
    ty = cy - (m10 * cx + m11 * cy)
    return torch.stack([torch.stack([m00, m01, tx], -1), torch.stack([m10, m11, ty], -1)], -2)


def draw_rot_flip(batch: int, generator: Optional[torch.Generator],
                  device: torch.device) -> Draws:
    """Angles uniform in [-MAX_DEG, MAX_DEG), then the vertical and the
    horizontal flip bits (p = 0.5), in that order from `generator`."""
    u = torch.rand(batch, generator=generator, device=device)
    vflip = torch.rand(batch, generator=generator, device=device) < 0.5
    hflip = torch.rand(batch, generator=generator, device=device) < 0.5
    return -MAX_DEG + 2.0 * MAX_DEG * u, vflip, hflip


def random_joint_rot_flip(imgs: torch.Tensor, masks: Sequence[torch.Tensor],
                          generator: Optional[torch.Generator] = None,
                          draws: Optional[Draws] = None):
    """BTransform's joint augmentation (dataset.py:118-144) on NCHW batches:
    one rotation per sample (IMG_FILL outside for the image, MASK_FILL for
    the masks), then the vertical and horizontal flips, all shared by the
    image and its masks. `draws` (angles, vflip, hflip) replaces the
    generator's."""
    b, _, h, w = imgs.shape
    angles, vflip, hflip = draws if draws is not None else draw_rot_flip(
        b, generator, imgs.device)
    inv = rotation_inv_matrix(angles.to(imgs.device, imgs.dtype), h, w)
    vflip, hflip = vflip.to(imgs.device)[:, None, None, None], hflip.to(imgs.device)[:, None, None, None]

    def warp(x: torch.Tensor, fill: float) -> torch.Tensor:
        x = affine_warp(x, inv, fill)
        x = torch.where(vflip, x.flip(2), x)
        return torch.where(hflip, x.flip(3), x)

    return warp(imgs, IMG_FILL), tuple(warp(m, MASK_FILL) for m in masks)
