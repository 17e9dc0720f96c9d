"""BE_GAN -- bubble mask and edge segmentation with an adversarial
feature-matching discriminator.

Port of vaeplay_tpu/models/be_gan.py (rebuild of reference
models/networks_BE_GAN.py), NCHW, with the reference's state_dict keys, so
that vaeplay_tpu/models/torch_convert.py's `be_gan_from_torch` (G) and
`be_gan_disc_from_torch` (D) read port weights unchanged:

  ComposeNet (G)  networks_BE_GAN.py:39-73   `backbone` (ResNet50-FPN, level
                                             "0"), `aux_convs.{0..3}` (256 ->
                                             128 -> 64, 1x1 then 3x3 BN
                                             ConvBlocks), `mask_net` and
                                             `edge_net` (models/be.py's MaskNet
                                             on 64 channels)
  MaskMapper      networks_BE_GAN.py:75-114  [image channel, mask] -> `convs.0`
                                             3x3 s2 2->16 and `convs.1` 3x3 s2
                                             16->32 (bias, lrelu), then
                                             `feat_modules.{i}.{0,1}` (3x3 s2
                                             and 3x3 s1 BN lrelu), each stage's
                                             flattened map scaled by i // 2 + 1
                                             into the feature list, and
                                             `pooler.0` (1x1 to max_channel, no
                                             activation) averaged over space
  Discriminator   networks_BE_GAN.py:116-140 `content_disc` and `boundary_disc`
                                             MaskMappers on image channel 0,
                                             then `predictor.{0,1,2}`
                                             DenseBlocks (lrelu 0.2, the last
                                             with no bias and no activation)
                                             over num_classes

The JAX package's MaskMapper stem, SmallChannelConv3x3S2 (vaeplay_tpu/core/
layers.py:145-188), is a space-to-depth rewrite of a 3x3 stride-2 pad-1
conv for the TPU's lanes; here it is that plain conv. The JAX model flattens
its stage maps NHWC, the port NCHW: the feature lists hold the same values
in another order, and their only consumer, a mean |fake - real|, does not
depend on the order.
"""

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from vaeplay_torch.core.layers import ConvBlock, DenseBlock
from vaeplay_torch.models.backbone import ResNetFPN
from vaeplay_torch.models.be import EdgeNet, MaskNet, aux_chain

Generator = Optional[torch.Generator]


class ComposeNet(nn.Module):
    """The generator: BE's ComposeNet with the aux chain cut at 64 channels
    and top-level keys. NCHW images (B, 3, H, W), H and W multiples of 32
    -> {"edges", "masks"} logits (B, 1, H, W). Weights are drawn from
    `generator` as models/be.py draws BE's."""

    def __init__(self, backbone_layers: Sequence[int] = (3, 4, 6, 3), backbone_width: int = 64,
                 target_out_channels: int = 64, generator: Generator = None):
        super().__init__()
        self.backbone = ResNetFPN(backbone_layers, backbone_width, generator=generator)
        self.aux_convs = aux_chain(target_out_channels, generator)
        self.mask_net = MaskNet(target_out_channels, generator=generator)
        self.edge_net = EdgeNet(target_out_channels, generator=generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = self.aux_convs(self.backbone(x, levels=("0",))["0"])
        return {"edges": self.edge_net(y), "masks": self.mask_net(y)}


class MaskMapper(nn.Module):
    """(image channel (B, 1, S, S), mask (B, 1, S, S)) -> (pooled (B,
    max_channel), the stages' features (B, F)). It has log2(in_size / 16) - 2
    stages and raises below 128 px, where that is none."""

    def __init__(self, in_size: int = 512, max_channel: int = 128, generator: Generator = None):
        super().__init__()
        repeat_num = int(math.log2(in_size // 16)) - 2
        if repeat_num < 1:
            raise ValueError(f"MaskMapper needs in_size >= 128 (got {in_size}): the reference's "
                             f"log2(in_size / 16) - 2 stages (networks_BE_GAN.py:79) are none")
        self.convs = nn.Sequential(
            ConvBlock(2, 16, 3, stride=2, activate="lrelu", generator=generator),
            ConvBlock(16, 32, 3, stride=2, activate="lrelu", generator=generator))
        c, out_c, stages = 32, min(64, max_channel), []
        for _ in range(repeat_num):
            stages.append(nn.Sequential(
                ConvBlock(c, out_c, 3, stride=2, bn="batch", activate="lrelu", generator=generator),
                ConvBlock(out_c, out_c, 3, bn="batch", activate="lrelu", generator=generator)))
            c, out_c = out_c, min(out_c * 2, max_channel)
        self.feat_modules = nn.ModuleList(stages)
        self.pooler = nn.Sequential(ConvBlock(c, max_channel, 1, activate=None,
                                              generator=generator))

    def forward(self, x: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        y = self.convs(torch.cat([x, m], dim=1))
        feats = []
        for idx, stage in enumerate(self.feat_modules):
            y = stage(y)
            feats.append(y.flatten(1) * (idx // 2 + 1))
        return self.pooler(y).mean(dim=(2, 3)), torch.cat(feats, dim=1)


class Discriminator(nn.Module):
    """(images (B, 3, S, S), content masks, boundary masks (B, 1, S, S)) ->
    (type logits (B, num_classes), features (B, F)); only the images'
    channel 0 is read (networks_BE_GAN.py:131)."""

    def __init__(self, in_size: int = 512, num_classes: int = 4, max_channel: int = 64,
                 generator: Generator = None):
        super().__init__()
        self.content_disc = MaskMapper(in_size, max_channel, generator)
        self.boundary_disc = MaskMapper(in_size, max_channel, generator)
        self.predictor = nn.Sequential(
            DenseBlock(max_channel * 2, max_channel * 2, activate="lrelu", generator=generator),
            DenseBlock(max_channel * 2, max_channel, activate="lrelu", generator=generator),
            DenseBlock(max_channel, num_classes, activate=None, bias=False, generator=generator))

    def forward(self, x: torch.Tensor, m1: torch.Tensor,
                m2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x0 = x[:, 0:1]
        p1, f1 = self.content_disc(x0, m1)
        p2, f2 = self.boundary_disc(x0, m2)
        return self.predictor(torch.cat([p1, p2], dim=1)), torch.cat([f1, f2], dim=1)
