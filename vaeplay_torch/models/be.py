"""BE -- bubble content (mask) and boundary (edge) segmentation.

Port of vaeplay_tpu/models/be.py (rebuild of reference models/networks_BE.py),
NCHW, with the reference's state_dict keys, so that
vaeplay_tpu/models/torch_convert.py:be_from_torch reads a port state_dict
unchanged:

  FeatureNet  networks_BE.py:13-37  `backbone` (ResNet50-FPN, level "0",
                                    stride 4, 256 channels), then
                                    `aux_convs.{0..5}`: 1x1 C->C/2 and 3x3
                                    C/2->C/2 BN ConvBlocks, 256 down to 32
  MaskNet     networks_BE.py:39-58  `conv1` Up(8, coords), `conv2` Up(4,
                                    coords), `predictor.{0,1,2}` 3x3 convs
                                    4->8->4->1 with bias, no norm, no activation
  EdgeNet     networks_BE.py:60-66  the same architecture
  ComposeNet  networks_BE.py:68-90  -> {"edges", "masks"} logits (B, 1, H, W)

The JAX package runs the predictor tail as SmallChannelConv3x3S1 in a
space-to-depth(4) layout for the TPU's lanes; the same canonical 3x3 kernels
are plain convolutions here.
"""

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from vaeplay_torch.core.layers import ConvBlock, Up
from vaeplay_torch.models.backbone import ResNetFPN

Generator = Optional[torch.Generator]


def aux_chain(target_out_channels: int, generator: Generator = None) -> nn.Sequential:
    """The FPN level's 1x1 C->C/2 and 3x3 C/2->C/2 BN ConvBlocks, from 256
    channels down to target_out_channels (networks_BE.py:20-26)."""
    c, convs = 256, []
    while c > target_out_channels:
        convs.append(ConvBlock(c, c // 2, 1, bn="batch", generator=generator))
        convs.append(ConvBlock(c // 2, c // 2, 3, bn="batch", generator=generator))
        c //= 2
    return nn.Sequential(*convs)


class FeatureNet(nn.Module):
    def __init__(self, target_out_channels: int = 32,
                 backbone_layers: Sequence[int] = (3, 4, 6, 3), backbone_width: int = 64,
                 generator: Generator = None):
        super().__init__()
        self.backbone = ResNetFPN(backbone_layers, backbone_width, generator=generator)
        self.aux_convs = aux_chain(target_out_channels, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.aux_convs(self.backbone(x, levels=("0",))["0"])


class MaskNet(nn.Module):
    def __init__(self, in_channel: int = 32, generator: Generator = None):
        super().__init__()
        c = in_channel
        self.conv1 = Up(c, c // 4, if_add_coord=True, generator=generator)
        self.conv2 = Up(c // 4, c // 8, if_add_coord=True, generator=generator)
        self.predictor = nn.Sequential(
            ConvBlock(c // 8, c // 4, 3, activate=None, generator=generator),
            ConvBlock(c // 4, c // 8, 3, activate=None, generator=generator),
            ConvBlock(c // 8, 1, 3, activate=None, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.predictor(self.conv2(self.conv1(x)))


class EdgeNet(MaskNet):
    pass


class ComposeNet(nn.Module):
    """NCHW images (B, 3, H, W), H and W multiples of 32 -> full-resolution
    logits. Weights are drawn from `generator` (Kaiming-uniform convs, zero
    biases, BatchNorms at ones and zeros, every FrozenBatchNorm2d at
    identity), as the JAX package initialises its ComposeNet."""

    def __init__(self, backbone_layers: Sequence[int] = (3, 4, 6, 3), backbone_width: int = 64,
                 generator: Generator = None):
        super().__init__()
        self.feature_net = FeatureNet(backbone_layers=backbone_layers,
                                      backbone_width=backbone_width, generator=generator)
        self.mask_net = MaskNet(generator=generator)
        self.edge_net = EdgeNet(generator=generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feature = self.feature_net(x)
        return {"edges": self.edge_net(feature), "masks": self.mask_net(feature)}
