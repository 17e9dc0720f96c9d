"""Circle VAE-GAN -- port of vaeplay_tpu/models/vae_gan.py (the reference's
models/networks.py:10-262): a VAE/GAN (Larsen et al., "Autoencoding beyond
pixels") over synthetic circle images, with an auxiliary head regressing
the encoded circle parameters from z.

NCHW activations and torch weight layouts, with the reference's state_dict
keys, so that vaeplay_tpu/models/torch_convert.py:vaegan_from_torch reads a
port state_dict unchanged:

  EncoderBlock   networks.py:10-30   `conv` (5x5 s2, no bias), `bn`, relu
  DecoderBlock   networks.py:34-46   `conv` (5x5 s2 transpose), `bn`, relu
  Encoder        networks.py:49-81   `conv.{i}`, `fc.{0,1}`, `l_mu`, `l_var`
  Decoder        networks.py:84-115  `fc.{0,1}`, `conv.{i}`, `conv.{L}.0`
  DirectDecoder  networks.py:118-148 `head.{0-3}`, `r_fc.{0,1}`, `xy_fc.{0,1}`
  Discriminator  networks.py:151-198 `conv.0.0`, `conv.{i}`, `fc.{0,1,3}`
  VaeGan         networks.py:201-262

Every BatchNorm has torch momentum 0.9 (networks.py:16; flax's 0.1) and eps
1e-5. Its running variance is updated with the unbiased batch variance, as
in the reference; flax uses the biased one (ROADMAP queue 3).
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vaeplay_torch.core import init as vinit

BN_MOMENTUM, BN_EPS = 0.9, 1e-5  # networks.py:16


def _init(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """The reference's init_parameters (networks.py:214-226): every conv,
    transpose conv and linear weight from vaegan_uniform_, biases zero; the
    BatchNorms keep torch's ones and zeros."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            vinit.vaegan_uniform_(m.weight, generator)
            if m.bias is not None:
                vinit.zeros_(m.bias)


class EncoderBlock(nn.Module):
    """5x5 stride-2 conv without bias, BatchNorm, relu; `out=True` also
    returns the conv's pre-BN output (networks.py:18-25)."""

    def __init__(self, channel_in: int, channel_out: int):
        super().__init__()
        self.conv = nn.Conv2d(channel_in, channel_out, 5, stride=2, padding=2, bias=False)
        self.bn = nn.BatchNorm2d(channel_out, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor, out: bool = False):
        conv = self.conv(x)
        y = F.relu(self.bn(conv))
        return (y, conv) if out else y


class DecoderBlock(nn.Module):
    """5x5 stride-2 transpose conv (padding 2, output padding 1: doubles H and
    W) without bias, BatchNorm, relu."""

    def __init__(self, channel_in: int, channel_out: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(channel_in, channel_out, 5, stride=2, padding=2,
                                       output_padding=1, bias=False)
        self.bn = nn.BatchNorm2d(channel_out, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class Encoder(nn.Module):
    """iter_level EncoderBlocks from 64 channels up, doubling, to an 8x8
    map; its NCHW flatten through fc -> BN1d -> relu to 1024; mu, logvar."""

    def __init__(self, channel_in: int = 1, z_size: int = 128, iter_level: int = 3):
        super().__init__()
        size = 64
        blocks = [EncoderBlock(channel_in, size)]
        for _ in range(1, iter_level):
            blocks.append(EncoderBlock(size, size * 2))
            size *= 2
        self.conv = nn.Sequential(*blocks)
        self.fc = nn.Sequential(nn.Linear(8 * 8 * size, 1024, bias=False),
                                nn.BatchNorm1d(1024, eps=BN_EPS, momentum=BN_MOMENTUM),
                                nn.ReLU())
        self.l_mu = nn.Linear(1024, z_size)
        self.l_var = nn.Linear(1024, z_size)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.fc(self.conv(x).flatten(1))
        return self.l_mu(x), self.l_var(x)


class Decoder(nn.Module):
    """z -> fc -> BN1d -> relu -> (size, 8, 8), channel-major as the
    reference views it; iter_level DecoderBlocks halving the channels after
    the first; a 5x5 conv to channel_out and a sigmoid."""

    def __init__(self, z_size: int, size: int, channel_out: int = 1, iter_level: int = 3):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(z_size, 8 * 8 * size, bias=False),
                                nn.BatchNorm1d(8 * 8 * size, eps=BN_EPS, momentum=BN_MOMENTUM),
                                nn.ReLU())
        blocks = [DecoderBlock(size, size)]
        for _ in range(1, iter_level):
            blocks.append(DecoderBlock(size, size // 2))
            size //= 2
        blocks.append(nn.Sequential(nn.Conv2d(size, channel_out, 5, padding=2), nn.Sigmoid()))
        self.conv = nn.Sequential(*blocks)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.fc(z)
        return self.conv(x.view(x.shape[0], -1, 8, 8))


class DirectDecoder(nn.Module):
    """z -> (radius, x, y) circle params: a plain linear stack with no
    activations (networks.py:118-148), the r and xy heads concatenated."""

    def __init__(self, z_size: int):
        super().__init__()
        self.head = nn.Sequential(nn.Linear(z_size, 512), nn.Linear(512, 256),
                                  nn.Linear(256, 128), nn.Linear(128, 64))
        self.r_fc = nn.Sequential(nn.Linear(64, 32), nn.Linear(32, 1))
        self.xy_fc = nn.Sequential(nn.Linear(64, 32), nn.Linear(32, 2))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.head(z)
        return torch.cat([self.r_fc(x), self.xy_fc(x)], dim=-1)


class Discriminator(nn.Module):
    """A 5x5 conv (32 channels) and relu, then iter_level EncoderBlocks from
    64 channels, doubling, to an 8x8 map.

    mode "REC" stops at block recon_level and returns its pre-BN conv output,
    NCHW-flattened (networks.py:179-185); that block's BN still runs and
    updates its running statistics. mode "GAN" runs every block, then
    fc -> BN1d -> relu -> fc -> sigmoid (networks.py:188-195)."""

    def __init__(self, channel_in: int = 1, recon_level: int = 3, iter_level: int = 3):
        super().__init__()
        self.recon_level = recon_level
        layers = [nn.Sequential(nn.Conv2d(channel_in, 32, 5, padding=2), nn.ReLU())]
        size = 32
        for _ in range(iter_level):
            layers.append(EncoderBlock(size, size * 2))
            size *= 2
        self.conv = nn.ModuleList(layers)
        self.fc = nn.Sequential(nn.Linear(8 * 8 * size, 512, bias=False),
                                nn.BatchNorm1d(512, eps=BN_EPS, momentum=BN_MOMENTUM),
                                nn.ReLU(), nn.Linear(512, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor, mode: str = "REC") -> torch.Tensor:
        h = self.conv[0](x)
        for i in range(1, len(self.conv)):
            if i == self.recon_level and mode == "REC":
                return self.conv[i](h, out=True)[1].flatten(1)
            h = self.conv[i](h)
        return self.fc(h.flatten(1))


class VaeGan(nn.Module):
    """The full VAE-GAN (networks.py:201-262); iter_level = log2(img_size / 8).
    Weights are drawn from `generator` (vaegan_uniform_)."""

    def __init__(self, img_size: int = 128, z_size: int = 128, channel_in: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_size = z_size
        iter_level = int(math.log2(img_size // 8))
        self.encoder = Encoder(channel_in, z_size, iter_level)
        self.decoder = Decoder(z_size, 64 * 2 ** (iter_level - 1), channel_in, iter_level)
        self.discriminator = Discriminator(channel_in, iter_level, iter_level)
        self.param_encoder = DirectDecoder(z_size)
        _init(self, generator)

    def _randn(self, batch: int, generator: Optional[torch.Generator],
               device: torch.device) -> torch.Tensor:
        return torch.randn(batch, self.z_size, generator=generator, device=device,
                           dtype=self.encoder.l_mu.weight.dtype)

    def draw_noise(self, batch: int, generator: Optional[torch.Generator],
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(eps, z_p), each (batch, z_size) ~ N(0, 1) in the parameters'
        dtype, from `generator`: the reparameterization's draw, then the
        prior sample's."""
        return self._randn(batch, generator, device), self._randn(batch, generator, device)

    @staticmethod
    def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """z = mu + eps * exp(0.5 * logvar) (networks.py:228-231)."""
        return mu + eps * torch.exp(0.5 * logvar)

    def forward(self, x: torch.Tensor, noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """The training forward (networks.py:233-247): returns (x_tilde,
        disc_class, disc_layer, mus, log_variances, params), where the disc_*
        tensors cover the concatenated [x; x_tilde; x_p] batch of 3B.
        noise=(eps, z_p) injects both random draws; otherwise draw_noise
        takes them from `generator` on x's device."""
        eps, z_p = self.draw_noise(x.shape[0], generator, x.device) if noise is None else noise
        mus, log_variances = self.encoder(x)
        z = self.reparameterize(mus, log_variances, eps)
        x_tilde = self.decoder(z)
        params = self.param_encoder(z)
        x_p = self.decoder(z_p)
        cat = torch.cat([x, x_tilde, x_p], dim=0)
        disc_layer = self.discriminator(cat, "REC")
        disc_class = self.discriminator(cat, "GAN")
        return x_tilde, disc_class, disc_layer, mus, log_variances, params

    def generate(self, gen_size: int = 10,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Decode gen_size prior samples (networks.py:249-252); call in eval
        mode, as the JAX package runs it with train=False."""
        return self.decoder(self._randn(gen_size, generator, next(self.parameters()).device))

    def reconstruct(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(x_tilde, params) of x (networks.py:253-258); call in eval mode."""
        mus, log_variances = self.encoder(x)
        z = self.reparameterize(mus, log_variances, self._randn(x.shape[0], generator, x.device))
        return self.decoder(z), self.param_encoder(z)
