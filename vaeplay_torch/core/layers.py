"""Shared layer library -- port of vaeplay_tpu/core/layers.py (the part BP uses).

NCHW activations and torch weight layouts, with the reference's state_dict
key names (reference models/blocks.py), so that
vaeplay_tpu/models/torch_convert.py reads a port state_dict unchanged:

  ConvBlock           blocks.py:5-34   `conv.0.{weight,bias}`; bias iff no norm,
                                       relu / lrelu(0.02) / tanh / sigmoid
  DenseBlock          blocks.py:36-50  `fc.0.{weight,bias}`; lrelu slope 0.2
  SelfAttentionBlock  blocks.py:67-95  SAGAN; `q`, `k`, `v` are 1x1 ConvBlocks
                                       with the default ReLU, `gamma` starts at 0

BP uses no normalization, so ConvBlock has only the no-norm path here.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vaeplay_torch.core import init as vinit
from vaeplay_torch.ops.attention import spatial_self_attention


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


class ConvBlock(nn.Module):
    """conv(k, stride, pad=(k-1)//2) with bias [+ activation], LeakyReLU slope
    0.02 (reference blocks.py:5-34, no-norm path)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int = 1,
                 activate: Optional[str] = "relu", lrelu_slope: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activate, self.lrelu_slope = activate, lrelu_slope
        self.conv = nn.Sequential(nn.Conv2d(in_channels, features, kernel_size, stride,
                                            padding=(kernel_size - 1) // 2))
        vinit.conv_kaiming_(self.conv[0].weight, generator)
        vinit.zeros_(self.conv[0].bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_activation(self.conv(x), self.activate, self.lrelu_slope)


class DenseBlock(nn.Module):
    """linear [+ activation]; LeakyReLU slope 0.2 (reference blocks.py:36-50)."""

    def __init__(self, in_features: int, features: int, activate: Optional[str] = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activate = activate
        self.fc = nn.Sequential(nn.Linear(in_features, features))
        vinit.dense_kaiming_(self.fc[0].weight, generator)
        vinit.zeros_(self.fc[0].bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_activation(self.fc(x), self.activate, lrelu_slope=0.2)


class SelfAttentionBlock(nn.Module):
    """SAGAN-style spatial self-attention over an NCHW map (reference
    blocks.py:67-95): out = gamma * attention(q, k, v) + x over the H*W
    positions, gamma a learned scalar initialised to 0. The attention runs
    through ops.attention.spatial_self_attention, which takes the CUDA
    kernel for a tensor on the card."""

    def __init__(self, in_channels: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        cq = max(in_channels // 8, 1)
        self.q = ConvBlock(in_channels, cq, 1, generator=generator)
        self.k = ConvBlock(in_channels, cq, 1, generator=generator)
        self.v = ConvBlock(in_channels, in_channels, 1, generator=generator)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape

        def positions(t):  # (B, C', H, W) -> contiguous (B, H*W, C')
            return t.reshape(b, t.shape[1], h * w).transpose(1, 2).contiguous()

        out = spatial_self_attention(positions(self.q(x)), positions(self.k(x)),
                                     positions(self.v(x)))
        out = out.transpose(1, 2).reshape(b, c, h, w)
        return self.gamma * out + x
