"""Shared layer library -- port of vaeplay_tpu/core/layers.py (the parts BP,
BE, BC, BCP, BE_font and Style_GAN use).

NCHW activations and torch weight layouts, with the reference's state_dict
key names (reference models/blocks.py), so that
vaeplay_tpu/models/torch_convert.py reads a port state_dict unchanged:

  ConvBlock           blocks.py:5-34   `conv.0.weight` [`conv.0.bias` iff no
                                       norm], `conv.1` the BatchNorm2d
                                       (momentum 0.1, flax's 0.9; eps 1e-5) or
                                       the parameter-free InstanceNorm2d;
                                       relu / lrelu(0.02) / tanh / sigmoid
  DenseBlock          blocks.py:36-50  `fc.0.weight` [`fc.0.bias`]; lrelu slope 0.2
  SCSEBlock           blocks.py:52-65  `cSE.{1,3}` (the channel squeeze's two
                                       1x1 convs), `sSE.0` (the spatial one)
  SelfAttentionBlock  blocks.py:67-95  SAGAN; `q`, `k`, `v` are 1x1 ConvBlocks
                                       with the default ReLU, `gamma` starts at 0
  PointSelfAttentionBlock              SelfAttentionBlock over a point set
                                       held as (B, C, N), the reference's
                                       (B, C, N, 1) map (networks_BCP.py:80-84)
  add_coords/AddCoords blocks.py:97-112 [features, x along W, y along H]
  Up                  blocks.py:129-146 `conv.{0,1}`: two 3x3 BN ConvBlocks,
                                       then a bilinear 2x upsample

The JAX package's SmallChannelConv3x3S1 and its space_to_depth layout exist
only for the TPU's 128-lane channel axis; the same canonical 3x3 kernel is a
plain ConvBlock here (models/be.py's predictor, models/style_gan.py's head).
Its ConvTransposeBlock is a plain nn.ConvTranspose2d with a bias: the JAX
block flips the torch kernel it stores itself.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vaeplay_torch.core import init as vinit
from vaeplay_torch.ops.attention import RingRouting, spatial_self_attention


def apply_activation(x: torch.Tensor, activate: Optional[str], lrelu_slope: float) -> torch.Tensor:
    if activate is None:
        return x
    if activate == "relu":
        return F.relu(x)
    if activate == "lrelu":
        return F.leaky_relu(x, negative_slope=lrelu_slope)
    if activate == "tanh":
        return torch.tanh(x)
    if activate == "sigmoid":
        return torch.sigmoid(x)
    raise ValueError(f"unknown activation {activate!r}")


BN_MOMENTUM, BN_EPS = 0.1, 1e-5  # torch's BatchNorm2d defaults (blocks.py:5-34)


class ConvBlock(nn.Module):
    """conv(k, stride, pad=(k-1)//2) [+ batch/instance norm] [+ activation]
    (reference blocks.py:5-34): the conv has a bias only when there is no
    norm; LeakyReLU slope 0.02; InstanceNorm2d is torch's default (no affine,
    no running statistics)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int = 1,
                 bn: Optional[str] = None, activate: Optional[str] = "relu",
                 lrelu_slope: float = 0.02, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activate, self.lrelu_slope = activate, lrelu_slope
        layers = [nn.Conv2d(in_channels, features, kernel_size, stride,
                            padding=(kernel_size - 1) // 2, bias=bn is None)]
        if bn == "batch":
            layers.append(nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM))
        elif bn == "instance":
            layers.append(nn.InstanceNorm2d(features, eps=BN_EPS))
        elif bn is not None:
            raise ValueError(f"unknown norm {bn!r}")
        self.conv = nn.Sequential(*layers)
        vinit.conv_kaiming_(self.conv[0].weight, generator)
        if bn is None:
            vinit.zeros_(self.conv[0].bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_activation(self.conv(x), self.activate, self.lrelu_slope)


class DenseBlock(nn.Module):
    """linear [+ activation]; LeakyReLU slope 0.2 (reference blocks.py:36-50);
    `fc.0.bias` only when bias is True."""

    def __init__(self, in_features: int, features: int, activate: Optional[str] = "relu",
                 bias: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activate = activate
        self.fc = nn.Sequential(nn.Linear(in_features, features, bias=bias))
        vinit.dense_kaiming_(self.fc[0].weight, generator)
        if bias:
            vinit.zeros_(self.fc[0].bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_activation(self.fc(x), self.activate, lrelu_slope=0.2)


class SCSEBlock(nn.Module):
    """Concurrent spatial and channel squeeze-excite (reference
    blocks.py:52-65): x * cSE(x) + x * sSE(x), where cSE is a global average
    pool, a 1x1 conv to C / reduction, ReLU, a 1x1 conv back to C and a
    sigmoid, and sSE a 1x1 conv to one channel and a sigmoid."""

    def __init__(self, channels: int, reduction: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cSE = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                 nn.Conv2d(channels, channels // reduction, 1), nn.ReLU(),
                                 nn.Conv2d(channels // reduction, channels, 1), nn.Sigmoid())
        self.sSE = nn.Sequential(nn.Conv2d(channels, 1, 1), nn.Sigmoid())
        for conv in (self.cSE[1], self.cSE[3], self.sSE[0]):
            vinit.conv_kaiming_(conv.weight, generator)
            vinit.zeros_(conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.cSE(x) + x * self.sSE(x)


class SelfAttentionBlock(nn.Module):
    """SAGAN-style spatial self-attention over an NCHW map (reference
    blocks.py:67-95): out = gamma * attention(q, k, v) + x over the H*W
    positions, gamma a learned scalar initialised to 0. The attention runs
    through ops.attention.spatial_self_attention, which takes the CUDA
    kernel for a tensor on the card. q, k and v reach it as (B, H*W, C')
    transpose views of the NCHW maps, with no copy; on the card the result
    is the transpose view of a contiguous (B, C, H*W), so the reshape back to
    NCHW is free too. `ring` (ops.attention.RingRouting) routes the attention
    through the ring over a mesh axis where it is active."""

    def __init__(self, in_channels: int, generator: Optional[torch.Generator] = None,
                 ring: Optional[RingRouting] = None):
        super().__init__()
        self.ring = ring
        cq = max(in_channels // 8, 1)
        self.q = ConvBlock(in_channels, cq, 1, generator=generator)
        self.k = ConvBlock(in_channels, cq, 1, generator=generator)
        self.v = ConvBlock(in_channels, in_channels, 1, generator=generator)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape

        def positions(t):  # (B, C', H, W) -> (B, H*W, C') view, position stride 1
            return t.reshape(b, t.shape[1], h * w).transpose(1, 2)

        qkv = positions(self.q(x)), positions(self.k(x)), positions(self.v(x))
        out = spatial_self_attention(*qkv, ring=self.ring)
        out = out.transpose(1, 2).reshape(b, c, h, w)
        return self.gamma * out + x


class PointSelfAttentionBlock(SelfAttentionBlock):
    """SelfAttentionBlock over a point set x (B, C, N), channels first: the
    reference applies SelfAttentionBlock to the (B, C, N, 1) map
    (networks_BCP.py:80-84), the JAX package holds the same computation on
    (B, N, C) (core/layers.py:355-377). Channel-major, q, k and v come out
    of the 1x1 convolutions in the layout the kernel reads with no copy, and
    on the card the result is a contiguous (B, C, N) again. Attention runs over all N
    points, padding included, as in the JAX package: there is no key mask.
    `ring` as SelfAttentionBlock's (JAX core/layers.py:355-376)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x[..., None])[..., 0]


def add_coords(x: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """Append coordinate channels to an NCHW map (reference blocks.py:97-112):
    [features, x along W, y along H], raw 0..w-1 / 0..h-1 in x's dtype, or
    (c / size - 0.5) / 0.5 in [-1, 1) when normalized."""
    b, _, h, w = x.shape
    xx = torch.arange(w, dtype=x.dtype, device=x.device).view(1, 1, 1, w).expand(b, 1, h, w)
    yy = torch.arange(h, dtype=x.dtype, device=x.device).view(1, 1, h, 1).expand(b, 1, h, w)
    if normalize:
        xx, yy = (xx / w - 0.5) / 0.5, (yy / h - 0.5) / 0.5
    return torch.cat([x, xx, yy], dim=1)


class AddCoords(nn.Module):
    def __init__(self, if_normalize: bool = False):
        super().__init__()
        self.if_normalize = if_normalize

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return add_coords(x, normalize=self.if_normalize)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample with half-pixel centres (align_corners=False), as
    jax.image.resize "bilinear" gives for an exact 2x."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class Up(nn.Module):
    """[AddCoords] + 2 x (conv3x3 + BN + relu) + bilinear 2x (reference
    blocks.py:129-146); `conv.0` takes the two coordinate channels too."""

    def __init__(self, in_channels: int, features: int, if_add_coord: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.if_add_coord = if_add_coord
        c_in = in_channels + 2 if if_add_coord else in_channels
        self.conv = nn.Sequential(
            ConvBlock(c_in, features, 3, bn="batch", generator=generator),
            ConvBlock(features, features, 3, bn="batch", generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.if_add_coord:
            x = add_coords(x)
        return upsample2x_bilinear(self.conv(x))
