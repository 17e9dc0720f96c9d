"""ResNet50 + FPN backbone -- port of vaeplay_tpu/models/backbone.py, built in
the port (torchvision is not a dependency) with torchvision's
`resnet_fpn_backbone('resnet50')` semantics and state_dict vocabulary, so that
a torchvision checkpoint loads into it and vaeplay_tpu/models/backbone.py's
`convert_torchvision_state_dict` reads it:

  body.conv1, body.bn1                      7x7 s2 stem, then a 3x3 s2 max pool
  body.layer{1-4}.{b}.conv{1,2,3}, bn{1,2,3} Bottleneck, the stride on the 3x3
  body.layer{1-4}.0.downsample.{0,1}        the projection of each stage's block 0
  fpn.inner_blocks.{0-3}, fpn.layer_blocks.{0-3}  1x1 laterals, 3x3 outputs

Every norm of the body is a FrozenBatchNorm2d: four buffers, no parameters.
torchvision's trainable_layers=3 default freezes body.conv1 and body.layer1
(train/state.py:freeze_backbone_stem). The FPN returns levels "0".."3" (strides
4..32, 256 channels) and "pool" (LastLevelMaxPool, stride 64); `levels` picks
the ones a caller reads. BE, BC and BE_GAN read only "0", so the 3x3 outputs
of the other levels, which XLA dead-codes in the JAX package, are not
computed; their weights stay in the state_dict.
"""

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vaeplay_torch.core import init as vinit
from vaeplay_torch.ops.image import max_pool

LEVELS = ("0", "1", "2", "3", "pool")


class FrozenBatchNorm2d(nn.Module):
    """y = (x - running_mean) * weight / sqrt(running_var + eps) + bias over an
    NCHW map, with all four tensors buffers (torchvision FrozenBatchNorm2d,
    eps 1e-5); identity at init. The affine map is formed in the buffers'
    dtype and applied in x's, so a bf16 activation stays bf16 (the JAX step
    casts the constants to the compute dtype, steps_be.py:41-42)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        shape = (1, -1, 1, 1)
        return torch.addcmul(shift.to(x.dtype).view(shape), x, scale.to(x.dtype).view(shape))


def _conv(c_in: int, c_out: int, k: int, stride: int = 1, bias: bool = False,
          generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    """A Conv2d with the JAX package's Kaiming-uniform init, zero bias."""
    conv = nn.Conv2d(c_in, c_out, k, stride, padding=(k - 1) // 2, bias=bias)
    vinit.conv_kaiming_(conv.weight, generator)
    if bias:
        vinit.zeros_(conv.bias)
    return conv


class Bottleneck(nn.Module):
    """torchvision's resnet Bottleneck: 1x1 -> 3x3 (stride) -> 1x1 (x4), each
    with a FrozenBatchNorm2d, plus the skip (projected in block 0)."""

    def __init__(self, in_channels: int, width: int, stride: int = 1, downsample: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(in_channels, width, 1, generator=generator)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride, generator=generator)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = _conv(width, width * 4, 1, generator=generator)
        self.bn3 = FrozenBatchNorm2d(width * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                _conv(in_channels, width * 4, 1, stride, generator=generator),
                FrozenBatchNorm2d(width * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + identity)


class ResNet50(nn.Module):
    """C2..C5 (strides 4, 8, 16, 32). `layers` and `base_width` default to
    resnet50's (3, 4, 6, 3) x 64; slim variants such as (1, 1, 1, 1) x 16 keep
    the four-stage topology for small tests."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), base_width: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = base_width
        self.conv1 = _conv(3, w, 7, 2, generator=generator)
        self.bn1 = FrozenBatchNorm2d(w)
        c_in = w
        for li, (width, blocks, stride) in enumerate(
                zip((w, w * 2, w * 4, w * 8), layers, (1, 2, 2, 2)), start=1):
            stage = []
            for bi in range(blocks):
                stage.append(Bottleneck(c_in, width, stride if bi == 0 else 1, bi == 0,
                                        generator=generator))
                c_in = width * 4
            setattr(self, f"layer{li}", nn.Sequential(*stage))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = max_pool(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        feats = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
            feats.append(x)
        return feats


class FPN(nn.Module):
    """torchvision's FeaturePyramidNetwork over C2..C5: 1x1 laterals, the
    top-down sum with nearest 2x upsampling, 3x3 outputs, and LastLevelMaxPool
    (a 1x1 stride-2 max pool of level "3")."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            [_conv(c, out_channels, 1, bias=True, generator=generator) for c in in_channels])
        self.layer_blocks = nn.ModuleList(
            [_conv(out_channels, out_channels, 3, bias=True, generator=generator)
             for _ in in_channels])

    def forward(self, feats: Sequence[torch.Tensor],
                levels: Iterable[str] = LEVELS) -> Dict[str, torch.Tensor]:
        levels = tuple(levels)
        merged = self.inner_blocks[-1](feats[-1])
        outs = {}
        for i in range(len(feats) - 1, -1, -1):
            if i < len(feats) - 1:
                lateral = self.inner_blocks[i](feats[i])
                merged = lateral + F.interpolate(merged, size=lateral.shape[-2:], mode="nearest")
            if str(i) in levels or (i == 3 and "pool" in levels):
                outs[str(i)] = self.layer_blocks[i](merged)
        if "pool" in levels:
            outs["pool"] = max_pool(outs["3"], 1, stride=2)
        return {k: outs[k] for k in LEVELS if k in levels}


class ResNetFPN(nn.Module):
    """resnet_fpn_backbone('resnet50') equivalent, out_channels 256."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), base_width: int = 64,
                 out_channels: int = 256, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.body = ResNet50(layers, base_width, generator)
        self.fpn = FPN([base_width * 4 * 2 ** i for i in range(4)], out_channels, generator)

    def forward(self, x: torch.Tensor, levels: Iterable[str] = LEVELS) -> Dict[str, torch.Tensor]:
        return self.fpn(self.body(x), levels)


# ---------------------------------------------------------------------------
# torchvision-layout checkpoints


def load_backbone_state(path: str) -> Dict[str, np.ndarray]:
    """A backbone checkpoint file as {tensor name: numpy array}: a
    torchvision-style `.pth`/`.pt` (a raw state_dict, or one under "state_dict"
    or "model") or an `.npz` with the same names. The reference's
    pretrained=True (networks_BE.py:16), from a file the user supplies."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in obj.items()}


def _strip(k: str) -> str:
    for pre in ("backbone.body.", "backbone.fpn.", "body.", "fpn."):
        if k.startswith(pre):
            return k[len(pre):]
    return k


@torch.no_grad()
def load_torchvision_state(backbone: ResNetFPN, state: Dict[str, np.ndarray]) -> None:
    """Copy a torchvision resnet50 state_dict (raw `conv1.weight`,
    `layer1.0.conv1.weight`, ... or `backbone.body.*` / `backbone.fpn.*` keys
    of a detection checkpoint) into `backbone` in place, as the JAX package's
    convert_torchvision_state_dict (backbone.py:230-303) does: the body when
    the file has a stem (its width and every block of the model must be
    there), the FPN's convs where present (`inner_blocks.N.weight` or
    torchvision's newer `inner_blocks.N.0.weight`)."""
    sd = {_strip(k): np.asarray(v) for k, v in state.items()}
    body = backbone.body

    def put(t: torch.Tensor, name: str) -> None:
        v = torch.from_numpy(np.ascontiguousarray(sd[name]))
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"backbone_ckpt {name}: shape {tuple(v.shape)}, the model's "
                             f"{tuple(t.shape)}")
        t.copy_(v)

    def put_bn(bn: FrozenBatchNorm2d, prefix: str) -> None:
        for name in ("weight", "bias", "running_mean", "running_var"):
            put(getattr(bn, name), f"{prefix}.{name}")

    if "conv1.weight" in sd:
        want, have = body.conv1.out_channels, sd["conv1.weight"].shape[0]
        if want != have:
            raise ValueError(f"backbone_ckpt stem width {have} != model stem width {want}: "
                             "slim base_width configs cannot load this checkpoint")
        put(body.conv1.weight, "conv1.weight")
        put_bn(body.bn1, "bn1")
        for li in range(1, 5):
            stage = getattr(body, f"layer{li}")
            missing = [bi for bi in range(len(stage)) if f"layer{li}.{bi}.conv1.weight" not in sd]
            if missing:
                raise ValueError(
                    f"backbone_ckpt has no layer{li} blocks {missing}: the model expects "
                    f"{len(stage)} blocks in layer{li} but the checkpoint is a different "
                    "resnet variant (slim backbone_layers configs cannot load full resnet50 "
                    "checkpoints and vice versa)")
            for bi, block in enumerate(stage):
                src = f"layer{li}.{bi}"
                for ci in (1, 2, 3):
                    put(getattr(block, f"conv{ci}").weight, f"{src}.conv{ci}.weight")
                    put_bn(getattr(block, f"bn{ci}"), f"{src}.bn{ci}")
                if block.downsample is not None and f"{src}.downsample.0.weight" in sd:
                    put(block.downsample[0].weight, f"{src}.downsample.0.weight")
                    put_bn(block.downsample[1], f"{src}.downsample.1")
    for blocks, name in ((backbone.fpn.inner_blocks, "inner_blocks"),
                         (backbone.fpn.layer_blocks, "layer_blocks")):
        for i, conv in enumerate(blocks):
            src = f"{name}.{i}" if f"{name}.{i}.weight" in sd else f"{name}.{i}.0"
            if f"{src}.weight" in sd:
                put(conv.weight, f"{src}.weight")
                put(conv.bias, f"{src}.bias")


def transplant_backbone(path: str, model: nn.Module) -> int:
    """Load `path` into every ResNetFPN inside `model` (BE's
    feature_net.backbone); returns how many. Raises when there is none."""
    state = load_backbone_state(path)
    backbones = [m for m in model.modules() if isinstance(m, ResNetFPN)]
    if not backbones:
        raise ValueError("no ResNetFPN in the model: --backbone_ckpt only applies to "
                         "BE/BC/BE_GAN-style models")
    for b in backbones:
        load_torchvision_state(b, state)
    return len(backbones)
