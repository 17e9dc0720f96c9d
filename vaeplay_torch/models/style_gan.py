"""Style_GAN -- the bubble-style VAE-GAN (style transfer between bubble types).

Port of vaeplay_tpu/models/style_gan.py (rebuild of reference
models/network_Style_GAN.py), NCHW, with the reference's state_dict keys, so
that vaeplay_tpu/models/torch_convert.py's style_encoder_from_torch,
style_generator_from_torch and style_discriminator_from_torch read a port
state_dict unchanged:

  StyleEncoder   network_Style_GAN.py:12-43   `convs.{0..n+2}`: a 5x5 conv, n
                 stride-2 instance-norm levels to max_channels, two stride-2
                 convs to a 1 x 1 map; `fc_mu`, `fc_logvar`
  MyConv2d       network_Style_GAN.py:72-79   `conv_1`, `conv_2`: the
                 label-gated pair, out = conv_1(x) (1 - y) + conv_2(x) y
  StyleUp        network_Style_GAN.py:45-65   `up_convs.0` (ConvTranspose2d 4/2/1,
                 then instance norm and ReLU), `cat_convs.0` (a 3x3 ConvBlock
                 on [up, skip]), `cat_convs.{1,2}` (SCSEBlocks), then ReLU
  MLP            network_Style_GAN.py:182-199 `model.{0,1,2}`: z -> the
                 full-image plane, linears with no activation
  Generator      network_Style_GAN.py:81-180  `mlp`, `conv{1,2}`, `down{1..4}`,
                 `skip{1,2,3}`, `up{1,2,3}`, `final.{0..3}` (ConvTranspose2d,
                 three 3x3 ConvBlocks), tanh
  Discriminator  network_Style_GAN.py:201-229 `convs.{0..n}` on [x, x_content],
                 `adv_convs.{0,1}` -> sigmoid, `aux_convs.{0,1}` -> softmax
                 (the trainer's cross-entropy then reads these
                 probabilities: the reference's double softmax, kept)

The JAX Generator computes its full-resolution head in a space-to-depth
layout for the TPU's 128-lane channel axis; the same canonical 3x3 kernels
are plain ConvBlocks here. D's sigmoid and softmax run in f32 whatever
autocast does, so the step's losses read f32 probabilities.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vaeplay_torch.core import init as vinit
from vaeplay_torch.core.layers import BN_EPS, ConvBlock, DenseBlock, SCSEBlock

IMAGE_CHANNEL = 3
Generator_ = Optional[torch.Generator]
Split = Optional[Tuple[int, int]]


def _one_by_one(h: torch.Tensor, what: str) -> torch.Tensor:
    """The flatten of a (B, C, 1, 1) map; any other map raises (its NCHW and
    NHWC flattens would differ from the JAX model's)."""
    if h.shape[2:] != (1, 1):
        raise ValueError(f"{what}: the map before the flatten is {tuple(h.shape[2:])}, not 1 x 1")
    return h.flatten(1)


def conv_transpose(in_channels: int, features: int, generator: Generator_) -> nn.ConvTranspose2d:
    """ConvTranspose2d(k 4, stride 2, padding 1) with a bias: the JAX
    ConvTransposeBlock's kernel init (Kaiming over out * kh * kw), zero bias."""
    conv = nn.ConvTranspose2d(in_channels, features, 4, stride=2, padding=1)
    vinit.conv_kaiming_(conv.weight, generator)
    vinit.zeros_(conv.bias)
    return conv


class StyleEncoder(nn.Module):
    """(B, 3, S, S) images -> (mu, logvar), each (B, z_dim)."""

    def __init__(self, z_dim: int = 512, image_size: int = 256, max_channels: int = 1024,
                 generator: Generator_ = None):
        super().__init__()
        convs = [ConvBlock(IMAGE_CHANNEL, 64, 5, activate=None, generator=generator)]
        c = 64
        for _ in range(int(math.log2(image_size)) - 2):
            convs.append(ConvBlock(c, min(c * 2, max_channels), 3, stride=2, bn="instance",
                                   generator=generator))
            c = min(c * 2, max_channels)
        convs += [ConvBlock(c, c, 3, stride=2, generator=generator) for _ in range(2)]
        self.convs = nn.Sequential(*convs)
        self.fc_mu = DenseBlock(c, z_dim, activate=None, generator=generator)
        self.fc_logvar = DenseBlock(c, z_dim, activate=None, generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        y = _one_by_one(self.convs(x), "StyleEncoder")
        return self.fc_mu(y), self.fc_logvar(y)


class MyConv2d(nn.Module):
    """The label-gated conv pair: out = conv_1(x) (1 - y) + conv_2(x) y, y
    the (B,) label as a float. With split=(k0p, k1p), for a batch sorted
    label-0 first, conv_1 runs on the first k0p rows only and conv_2 on the
    last k1p, each zero-padded back to B before the same gate: exact, since
    every op of a ConvBlock is per-sample and the gate zeroes each branch
    outside its rows (the JAX package's MyConv2d, style_gan.py:55-101)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int = 1,
                 bn: Optional[str] = None, activate: Optional[str] = "relu",
                 generator: Generator_ = None):
        super().__init__()
        self.conv_1 = ConvBlock(in_channels, features, kernel_size, stride, bn, activate,
                                generator=generator)
        self.conv_2 = ConvBlock(in_channels, features, kernel_size, stride, bn, activate,
                                generator=generator)

    def forward(self, x: torch.Tensor, label: torch.Tensor, split: Split = None) -> torch.Tensor:
        lab = label.reshape(-1, 1, 1, 1)
        if split is None:
            a, b = self.conv_1(x), self.conv_2(x)
            return a * (1.0 - lab.to(a.dtype)) + b * lab.to(b.dtype)
        k0p, k1p = split
        n = x.shape[0]
        if k0p <= 0:
            b = self.conv_2(x[n - k1p:])
            return b * lab[n - k1p:].to(b.dtype)
        if k1p <= 0:
            a = self.conv_1(x[:k0p])
            return a * (1.0 - lab[:k0p].to(a.dtype))
        a = F.pad(self.conv_1(x[:k0p]), (0, 0, 0, 0, 0, 0, 0, n - k0p))
        b = F.pad(self.conv_2(x[n - k1p:]), (0, 0, 0, 0, 0, 0, n - k1p, 0))
        return a * (1.0 - lab.to(a.dtype)) + b * lab.to(b.dtype)


class StyleUp(nn.Module):
    """ConvTranspose2d 4/2/1, instance norm (eps 1e-5, no affine), ReLU; then
    [that, skip] through a 3x3 ConvBlock, two SCSEBlocks (reduction 4) and a
    ReLU."""

    def __init__(self, in_channels: int, skip_channels: int, features: int,
                 generator: Generator_ = None):
        super().__init__()
        self.up_convs = nn.Sequential(conv_transpose(in_channels, features, generator),
                                      nn.InstanceNorm2d(features, eps=BN_EPS), nn.ReLU())
        self.cat_convs = nn.Sequential(
            ConvBlock(features + skip_channels, features, 3, generator=generator),
            SCSEBlock(features, 4, generator), SCSEBlock(features, 4, generator))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return F.relu(self.cat_convs(torch.cat([self.up_convs(x), skip], dim=1)))


def mlp_widths(nf_in: int, nf_out: int, num_blocks: int = 3) -> Tuple[int, ...]:
    """The MLP's widths, nf_in first: the JAX package's rule exactly
    (style_gan.py:123-137), ratio int(2 ** (int(log2(nf_out / nf_in)) /
    (num_blocks - 1))); 512 -> 512 -> 5632 -> 65536 at 256 px, z 512."""
    ratio = int(2 ** (int(math.log2(nf_out / nf_in)) / (num_blocks - 1)))
    widths, out_dim = [nf_in, nf_in], nf_in
    for _ in range(num_blocks - 2):
        out_dim = min(out_dim * ratio, nf_out)
        widths.append(out_dim)
    return tuple(widths) + (nf_out,)


class MLP(nn.Module):
    def __init__(self, nf_in: int, nf_out: int, num_blocks: int = 3,
                 generator: Generator_ = None):
        super().__init__()
        w = mlp_widths(nf_in, nf_out, num_blocks)
        self.model = nn.Sequential(*(DenseBlock(w[i], w[i + 1], activate=None,
                                                generator=generator) for i in range(len(w) - 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.flatten(1))


class Generator(nn.Module):
    """(x_content (B, 3, S, S), style code (B, z_dim), labels (B,)) ->
    (B, 3, S, S) in [-1, 1]. The MLP's S * S outputs are the 4th input
    channel. split=(k0p, k1p): every MyConv2d in its label-bucketed form,
    for a batch sorted label-0 first; None: the reference's blended form."""

    def __init__(self, image_size: int = 256, z_dim: int = 512, generator: Generator_ = None):
        super().__init__()
        self.image_size = image_size
        g = generator
        self.mlp = MLP(z_dim, image_size * image_size, 3, g)
        self.conv1 = MyConv2d(IMAGE_CHANNEL + 1, 32, 3, activate=None, generator=g)
        self.conv2 = MyConv2d(32, 32, 3, activate=None, generator=g)
        self.down1 = MyConv2d(32, 64, 4, stride=2, bn="instance", generator=g)
        self.down2 = MyConv2d(64, 128, 4, stride=2, bn="instance", generator=g)
        self.down3 = MyConv2d(128, 256, 4, stride=2, bn="instance", generator=g)
        self.down4 = MyConv2d(256, 256, 4, stride=2, bn="instance", generator=g)
        self.skip1 = ConvBlock(256, 256, 3, bn="instance", generator=g)
        self.skip2 = ConvBlock(128, 128, 3, bn="instance", generator=g)
        self.skip3 = ConvBlock(64, 64, 3, bn="instance", generator=g)
        self.up1 = StyleUp(256, 256, 256, g)
        self.up2 = StyleUp(256, 128, 128, g)
        self.up3 = StyleUp(128, 64, 64, g)
        self.final = nn.Sequential(conv_transpose(64, 32, g), ConvBlock(32, 32, 3, generator=g),
                                   ConvBlock(32, 32, 3, generator=g),
                                   ConvBlock(32, IMAGE_CHANNEL, 3, activate=None, generator=g))

    def forward(self, x: torch.Tensor, style_code: torch.Tensor, labels: torch.Tensor,
                split: Split = None) -> torch.Tensor:
        s = self.image_size
        plane = self.mlp(style_code).reshape(-1, 1, s, s)
        h = torch.cat([x, plane], dim=1)  # under autocast: promoted to x's f32
        h = self.conv1(h, labels, split)
        h = self.conv2(h, labels, split)
        d1 = self.down1(h, labels, split)
        d2 = self.down2(d1, labels, split)
        d3 = self.down3(d2, labels, split)
        d4 = self.down4(d3, labels, split)
        up1 = self.up1(d4, self.skip1(d3))
        up2 = self.up2(up1, self.skip2(d2))
        up3 = self.up3(up2, self.skip3(d1))
        return torch.tanh(self.final(up3))


class Discriminator(nn.Module):
    """(x, x_content), each (B, 3, S, S) -> (sigmoid(adv) (B, 1),
    softmax(aux) (B, num_classes)), both f32 or wider."""

    def __init__(self, image_size: int = 256, num_classes: int = 2, max_channels: int = 256,
                 generator: Generator_ = None):
        super().__init__()
        convs = [ConvBlock(2 * IMAGE_CHANNEL, 64, 5, generator=generator)]
        c = 64
        for _ in range(int(math.log2(image_size)) - 2):
            convs.append(ConvBlock(c, min(c * 2, max_channels), 3, stride=2, bn="instance",
                                   generator=generator))
            c = min(c * 2, max_channels)
        self.convs = nn.Sequential(*convs)
        self.adv_convs = nn.Sequential(
            ConvBlock(c, c, 3, stride=2, activate="lrelu", generator=generator),
            ConvBlock(c, 1, 3, stride=2, activate=None, generator=generator))
        self.aux_convs = nn.Sequential(
            ConvBlock(c, c, 3, stride=2, activate="lrelu", generator=generator),
            ConvBlock(c, num_classes, 3, stride=2, activate=None, generator=generator))

    def forward(self, x: torch.Tensor, x_content: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.convs(torch.cat([x, x_content], dim=1))
        adv = _one_by_one(self.adv_convs(h), "Discriminator adv")
        aux = _one_by_one(self.aux_convs(h), "Discriminator aux")
        wide = torch.promote_types(adv.dtype, torch.float32)
        return torch.sigmoid(adv.to(wide)), torch.softmax(aux.to(wide), dim=-1)
