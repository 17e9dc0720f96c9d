"""BE_font -- conditional kana-mask generation (ACGAN-style).

Port of vaeplay_tpu/models/be_font.py (rebuild of reference
models/networks_BE_font.py), NCHW, with the reference's state_dict keys, so
that vaeplay_tpu/models/torch_convert.py:be_font_from_torch and
be_font_disc_from_torch read a port state_dict unchanged:

  EmbedingBlock         networks_BE_font.py:21-46  `convs_first.{0,1}` (two
                        linears, no activation), `attention.{0,1,2}` (three
                        SelfAttentionBlocks over the single position of a
                        (B, C, 1, 1) map), `embeding.{0,1}` (lrelu 0.2)
  StyleEncodeBlock      networks_BE_font.py:48-69  `convs.{0..n+1}`: n + 1
                        stride-2 instance-norm convs, a 1x1, a spatial mean
  ParameterEmbedingNet  networks_BE_font.py:71-85  `label_encode_block` and
                        `style_encode_block`: EmbedingBlocks over the one-hot
                        class and the style vector (EmbedPair) or
                        StyleEncodeBlocks over the image (StylePair)
  MaskNet/EdgeNet       networks_BE_font.py:87-123 `predictor.{0,1,2}`
  ComposeNet            networks_BE_font.py:125-234 the U-Net: `down.*`, the
                        bottleneck [NCHW-flattened map, class embedding, style
                        embedding] through `relay_convs.{0,1}`, then `up.*`,
                        `skip.*`, `cat.*`, `mask_net`, `edge_net`
  Classifier            networks_BE_font.py:236-267 `conv_first`,
                        `backbone.{0..3}`, `embeding_block`, `cls_convs.{0,1,2}`
  Discriminator         networks_BE_font.py:269-278 sigmoid(adv) and the aux
                        logits

Both conditioning branches of ComposeNet are built in __init__, as the
reference builds them (the JAX package's `init_all` exists only because flax
creates parameters lazily). Every attention block runs over one position:
q, k (B, 1, 32) and v (B, 1, 256) reach the attention kernel like any other.
"""

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from vaeplay_torch.core.layers import ConvBlock, DenseBlock, SelfAttentionBlock, Up

LABEL_EMBED = 256
STYLE_EMBED = 256
NUM_CLASSES = 143
STYLE_DIM = 5
Generator = Optional[torch.Generator]
Conditioning = Dict[str, torch.Tensor]  # {"cls": (B, 143) one-hot, "cnt_style": (B, 5)}


class EmbedingBlock(nn.Module):
    def __init__(self, in_features: int, out_channels: int, generator: Generator = None):
        super().__init__()
        self.convs_first = nn.Sequential(
            DenseBlock(in_features, out_channels, activate=None, generator=generator),
            DenseBlock(out_channels, out_channels, activate=None, generator=generator))
        self.attention = nn.Sequential(*(SelfAttentionBlock(out_channels, generator=generator)
                                         for _ in range(3)))
        self.embeding = nn.Sequential(
            DenseBlock(out_channels, out_channels, activate="lrelu", generator=generator),
            DenseBlock(out_channels, out_channels, activate="lrelu", generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.attention(self.convs_first(x)[:, :, None, None])  # (B, C, 1, 1)
        return self.embeding(y.flatten(1))


class StyleEncodeBlock(nn.Module):
    def __init__(self, out_channels: int, in_size: int, generator: Generator = None):
        super().__init__()
        convs = [ConvBlock(3, 64, 3, stride=2, bn="instance", generator=generator)]
        c, out_c = 64, min(128, out_channels)
        for _ in range(int(math.log2(in_size)) - 3):
            convs.append(ConvBlock(c, out_c, 3, stride=2, bn="instance", generator=generator))
            c, out_c = out_c, min(out_c * 2, out_channels)
        convs.append(ConvBlock(c, out_channels, 1, bn="instance", generator=generator))
        self.convs = nn.Sequential(*convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(x).mean(dim=(2, 3))


class EmbedPair(nn.Module):
    """ParameterEmbedingNet in_type 'embed': the one-hot class and the style
    vector, each through an EmbedingBlock."""

    def __init__(self, generator: Generator = None):
        super().__init__()
        self.label_encode_block = EmbedingBlock(NUM_CLASSES, LABEL_EMBED, generator)
        self.style_encode_block = EmbedingBlock(STYLE_DIM, STYLE_EMBED, generator)

    def forward(self, y_cls: torch.Tensor, y_style: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.label_encode_block(y_cls), self.style_encode_block(y_style)


class StylePair(nn.Module):
    """ParameterEmbedingNet in_type 'image': two encoders of the image."""

    def __init__(self, in_size: int, generator: Generator = None):
        super().__init__()
        self.label_encode_block = StyleEncodeBlock(LABEL_EMBED, in_size, generator)
        self.style_encode_block = StyleEncodeBlock(STYLE_EMBED, in_size, generator)

    def forward(self, x_a: torch.Tensor, x_b: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.label_encode_block(x_a), self.style_encode_block(x_b)


class MaskNet(nn.Module):
    def __init__(self, in_channel: int = 64, generator: Generator = None):
        super().__init__()
        c = in_channel
        self.predictor = nn.Sequential(
            ConvBlock(c, c, 3, bn="instance", generator=generator),
            ConvBlock(c, c, 3, bn="instance", generator=generator),
            ConvBlock(c, 1, 3, activate=None, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.predictor(x)


class EdgeNet(MaskNet):
    pass


class ComposeNet(nn.Module):
    """The U-Net generator: (B, 3, S, S) images -> {"masks", "edges"}, each
    (B, 1, S, S) logits. With `y` the bottleneck is conditioned on the class
    and style embeddings (training); with y=None on the image's own style
    encodings (networks_BE_font.py:188-193)."""

    def __init__(self, in_size: int = 64, min_channel: int = 64, max_channel: int = 512,
                 generator: Generator = None):
        super().__init__()
        down = [ConvBlock(3, min_channel, 3, bn="instance", generator=generator)]
        chans = []
        c, out_c = min_channel, min(min_channel * 2, max_channel)
        for _ in range(int(math.log2(in_size // 4))):
            down.append(nn.Sequential(
                ConvBlock(c, out_c, 3, stride=2, bn="batch", generator=generator),
                ConvBlock(out_c, out_c, 3, bn="instance", generator=generator)))
            chans.append((c, out_c))
            c, out_c = out_c, min(out_c * 2, max_channel)
        self.down = nn.ModuleList(down)
        self.embeding_block = EmbedPair(generator)
        self.style_encoder = StylePair(in_size, generator)
        relay_in = c * 4 * 4
        self.relay_convs = nn.Sequential(
            DenseBlock(relay_in + LABEL_EMBED + STYLE_EMBED, relay_in, generator=generator),
            DenseBlock(relay_in, relay_in, generator=generator))
        # indexed like the reference's lists: 0 is the shallowest stage
        self.up = nn.ModuleList(Up(outc, inc, generator=generator) for inc, outc in chans)
        self.skip = nn.ModuleList(ConvBlock(inc, inc, 3, bn="instance", generator=generator)
                                  for inc, _ in chans)
        self.cat = nn.ModuleList(ConvBlock(2 * inc, inc, 3, bn="instance", generator=generator)
                                 for inc, _ in chans)
        self.mask_net = MaskNet(min_channel, generator)
        self.edge_net = EdgeNet(min_channel, generator)

    def forward(self, x: torch.Tensor, y: Optional[Conditioning] = None) -> Dict[str, torch.Tensor]:
        if y is not None:
            y_cls, y_style = self.embeding_block(y["cls"], y["cnt_style"])
        else:
            y_cls, y_style = self.style_encoder(x, x)
        feats = [self.down[0](x)]
        for block in self.down[1:]:
            feats.append(block(feats[-1]))
        h = feats[-1]
        flat = torch.cat([h.flatten(1), y_cls, y_style], dim=1)
        h = self.relay_convs(flat).view(h.shape)
        n = len(self.up)
        for i in range(n):
            idx = n - 1 - i
            h = self.cat[idx](torch.cat([self.up[idx](h), self.skip[idx](feats[-2 - i])], dim=1))
        return {"masks": self.mask_net(h), "edges": self.edge_net(h)}


class Classifier(nn.Module):
    """Five stride-2 lrelu convs to 1024 channels at S/32, the NCHW-flattened
    map concatenated with the class and style embeddings, three linears."""

    def __init__(self, in_size: int = 64, num_classes: int = 1, in_channels: int = 2,
                 generator: Generator = None):
        super().__init__()
        self.conv_first = ConvBlock(in_channels, 64, 3, stride=2, bn="instance", activate="lrelu",
                                    generator=generator)
        layers, c = [], 64
        for out_c, bn in ((128, "instance"), (256, "instance"), (512, "batch"), (1024, "batch")):
            layers.append(ConvBlock(c, out_c, 3, stride=2, bn=bn, activate="lrelu",
                                    generator=generator))
            c = out_c
        self.backbone = nn.Sequential(*layers)
        self.embeding_block = EmbedPair(generator)
        in_flat = 1024 * (in_size // 32) ** 2
        self.cls_convs = nn.Sequential(
            DenseBlock(in_flat + LABEL_EMBED + STYLE_EMBED, in_flat // 2, activate="lrelu",
                       generator=generator),
            DenseBlock(in_flat // 2, in_flat // 4, activate="lrelu", generator=generator),
            DenseBlock(in_flat // 4, num_classes, activate=None, generator=generator))

    def forward(self, x: torch.Tensor, y: Conditioning) -> torch.Tensor:
        h = self.backbone(self.conv_first(x)).flatten(1)
        y_cls, y_style = self.embeding_block(y["cls"], y["cnt_style"])
        return self.cls_convs(torch.cat([h, y_cls, y_style], dim=1))


class Discriminator(nn.Module):
    """(B, 2, S, S) [mask, edge] maps and the conditioning -> (sigmoid(adv)
    (B, 1), aux logits (B, num_classes)). The sigmoid runs in f32 whatever
    autocast does, so the step's BCE reads f32 probabilities."""

    def __init__(self, in_size: int = 64, num_classes: int = NUM_CLASSES,
                 generator: Generator = None):
        super().__init__()
        self.adv_convs = Classifier(in_size, 1, generator=generator)
        self.aux_convs = Classifier(in_size, num_classes, generator=generator)

    def forward(self, x: torch.Tensor, y: Conditioning) -> Tuple[torch.Tensor, torch.Tensor]:
        adv = self.adv_convs(x, y)
        return (torch.sigmoid(adv.to(torch.promote_types(adv.dtype, torch.float32))),
                self.aux_convs(x, y))
