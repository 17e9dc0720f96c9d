"""BC -- contour extraction and refinement (PolyTransform-style).

Port of vaeplay_tpu/models/bc.py (rebuild of reference models/networks_BC.py),
NCHW, with the reference's state_dict keys, so that
vaeplay_tpu/models/torch_convert.py:bc_from_torch reads a port state_dict
unchanged:

  FeatureNet  networks_BC.py:80-93    `feature` (ResNet50-FPN, level "0",
                                      stride 4, 256 channels)
  MaskNet     networks_BC.py:95-129   `conv1.{0,1,2}` 3x3 BN ConvBlocks
                                      256 -> 128 -> 64 -> 32, a bilinear 2x,
                                      `conv2.{0,1}` 32 -> 16 -> 8, a bilinear
                                      2x, `predictor.{0,1}` 3x3 convs 8 -> 4 ->
                                      1 with bias, no norm, no activation
  EdgeNet     networks_BC.py:131-147  on the 1-channel mask logits:
                                      `conv1.{0,1,2}` 1 -> 1 3x3 convs with
                                      ReLU, `predictor.{0,1}` without
  RefineNet   networks_BC.py:149-176  the point features as an NCHW map (B,
                                      points, features, 1): `deform_blocks.
                                      {0..5}` SelfAttentionBlocks over the
                                      feature positions, then `fc_blocks.
                                      {0,1}`, two nn.Linear, to per-point
                                      (dx, dy)
  ComposeNet  networks_BC.py:178-241

The JAX package's SmallChannelConv3x3S1 (MaskNet's predictor) and
OneChannelConv3x3 (EdgeNet) are TPU lane rewrites of plain 3x3 convolutions;
here they are plain convolutions.

The contours are traced inside the forward (networks_BC.py:217): the mask
logits are thresholded at sigmoid >= 0.5 on the device, bit-packed
(ops/bits.py, 1/32 of the f32 map), copied to the host, traced there by the
native tracer (ops/contour.py) and the points copied back. The copy is a
synchronisation: the device waits for the trace. `trace_contours` counts its
calls and host seconds.
"""

import time
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vaeplay_torch.core import init as vinit
from vaeplay_torch.core.layers import ConvBlock, SelfAttentionBlock, add_coords, upsample2x_bilinear
from vaeplay_torch.models.backbone import ResNetFPN
from vaeplay_torch.ops.bits import pack_mask_bits, unpack_mask_bits
from vaeplay_torch.ops.contour import batch_find_contours
from vaeplay_torch.ops.image import point_sample_ng

DEFAULT_MAX_POINTS = 256
FEAT_SIZE = 258  # the FPN's 256 channels and the two coordinate channels
PADDING = 1  # of the mask before the trace and of the feature map (train_BC.py:126)
Generator = Optional[torch.Generator]
Contours = Tuple[torch.Tensor, torch.Tensor]


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or f64 for f64 inputs (which the gradient checks use)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


class FeatureNet(nn.Module):
    def __init__(self, backbone_layers: Sequence[int] = (3, 4, 6, 3), backbone_width: int = 64,
                 generator: Generator = None):
        super().__init__()
        self.feature = ResNetFPN(backbone_layers, backbone_width, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.feature(x, levels=("0",))["0"]


class MaskNet(nn.Module):
    def __init__(self, in_channel: int = 256, generator: Generator = None):
        super().__init__()
        c = in_channel
        self.conv1 = nn.Sequential(
            ConvBlock(c, c // 2, 3, bn="batch", generator=generator),
            ConvBlock(c // 2, c // 4, 3, bn="batch", generator=generator),
            ConvBlock(c // 4, c // 8, 3, bn="batch", generator=generator))
        self.conv2 = nn.Sequential(
            ConvBlock(c // 8, c // 16, 3, bn="batch", generator=generator),
            ConvBlock(c // 16, c // 32, 3, bn="batch", generator=generator))
        self.predictor = nn.Sequential(
            ConvBlock(c // 32, c // 64, 3, activate=None, generator=generator),
            ConvBlock(c // 64, 1, 3, activate=None, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample2x_bilinear(self.conv1(x))
        x = upsample2x_bilinear(self.conv2(x))
        return self.predictor(x)


class EdgeNet(nn.Module):
    """Five 1 -> 1 3x3 convolutions on the mask logits (networks_BC.py:131-147)."""

    def __init__(self, generator: Generator = None):
        super().__init__()
        self.conv1 = nn.Sequential(*(ConvBlock(1, 1, 3, generator=generator) for _ in range(3)))
        self.predictor = nn.Sequential(
            *(ConvBlock(1, 1, 3, activate=None, generator=generator) for _ in range(2)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.predictor(self.conv1(x))


class RefineNet(nn.Module):
    """6 attention blocks over (channels = points, positions = feature dims),
    then two linear layers -> per-point (dx, dy) (networks_BC.py:149-176,
    CASE 1). The linear layers are held and computed in `fc_dtype` (their
    weights' dtype): f32 is the reference's; bf16 halves fc0, 545 M weights
    at 256 points. Their kernels start as the JAX package's
    variance_scaling(1/3, fan_in, uniform), which is torch's own Linear
    bound 1/sqrt(fan_in), and their biases at 0. The result has the input's
    dtype."""

    def __init__(self, max_points: int = DEFAULT_MAX_POINTS,
                 fc_dtype: torch.dtype = torch.float32, generator: Generator = None):
        super().__init__()
        self.deform_blocks = nn.Sequential(
            *(SelfAttentionBlock(max_points, generator=generator) for _ in range(6)))
        fc_in = max_points * FEAT_SIZE
        self.fc_blocks = nn.Sequential(nn.Linear(fc_in, fc_in // 8),
                                       nn.Linear(fc_in // 8, max_points * 2))
        for fc in self.fc_blocks:
            vinit.dense_kaiming_(fc.weight, generator)
            vinit.zeros_(fc.bias)
        self.fc_blocks.to(fc_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, p, f = x.shape  # (B, max_points, features)
        y = self.deform_blocks(x[..., None]).reshape(b, p * f)
        y = self.fc_blocks(y.to(self.fc_blocks[0].weight.dtype))
        return y.reshape(b, p, 2).to(x.dtype)


def make_embedding_tensor(pts: torch.Tensor, counts: torch.Tensor, height: int,
                          width: int) -> torch.Tensor:
    """One-hot spatial planes, one per point (the reference's unused CASE 2,
    make_embeding_tensor, networks_BC.py:39-52): (B, max_points, H, W) f32
    with a 1 at each valid point's (y, x), coordinates truncated and clipped
    into the map; planes past a sample's count are zero."""
    b, mp, _ = pts.shape
    xs = pts[..., 0].to(torch.int64).clamp(0, width - 1)
    ys = pts[..., 1].to(torch.int64).clamp(0, height - 1)
    valid = torch.arange(mp, device=pts.device)[None, :] < counts[:, None]
    planes = F.one_hot(ys * width + xs, height * width).to(torch.float32)
    return (planes * valid[..., None]).reshape(b, mp, height, width)


def resample_feature_batched(feature: torch.Tensor, pts: torch.Tensor,
                             counts: torch.Tensor) -> torch.Tensor:
    """resample_feature (networks_BC.py:55-78) as one batched bicubic sample:
    feature (B, C, Hf, Wf), padded and coordinate-augmented; pts (B,
    max_points, 2) [x, y] at full resolution -> (B, max_points, C) f32 (f64
    for f64 features), zero past each count. The points are normalized by
    the feature map's own half-extent, the reference's convention, kept as
    it is (so most points of a 256 px image land outside [-1, 1] and sample
    zeros); align_corners=False, torch's default, which the reference's call
    leaves (networks_BC.py:68)."""
    hf, wf = feature.shape[2:]
    w_half, h_half = (wf - 1) / 2.0, (hf - 1) / 2.0
    grid = torch.stack([(pts[..., 0] - w_half) / w_half, (pts[..., 1] - h_half) / h_half], dim=-1)
    sampled = _wide(point_sample_ng(feature, grid, False, "bicubic"))
    valid = torch.arange(pts.shape[1], device=pts.device)[None, :] < counts[:, None]
    return sampled * valid[..., None].to(sampled.dtype)


def threshold_bits(mask_logits: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """(B, 1, H, W) mask logits -> sigmoid >= 0.5, zero-padded by PADDING,
    every stride-th row and column, bit-packed along W: (B, Hp', ceil(Wp' /
    8)) uint8 on the logits' device. The JAX package thresholds the sigmoid
    map (bc.py:273-276), so this does too, in f32: `logit >= 0` differs just
    below 0, where f32's sigmoid rounds to 0.5."""
    binary = F.pad(torch.sigmoid(mask_logits[:, 0].float()), (PADDING,) * 4) >= 0.5
    return pack_mask_bits(binary[:, ::stride, ::stride])


def trace_contours(mask_logits: torch.Tensor, max_points: int) -> Contours:
    """The contours of the thresholded, padded masks, traced on the host:
    (pts (B, max_points, 2) f32 [x, y] in the padded frame, counts (B,)
    int32) on the logits' device, no gradient (the reference detaches,
    networks_BC.py:29). `trace_contours.calls` counts the calls,
    `.copy_seconds` the host seconds of the packed copy back (which waits
    for the device) and `.trace_seconds` those of the unpack and trace."""
    width = mask_logits.shape[3] + 2 * PADDING
    t0 = time.perf_counter()
    packed = threshold_bits(mask_logits.detach()).cpu().numpy()
    t1 = time.perf_counter()
    pts, counts = batch_find_contours(unpack_mask_bits(packed, width), max_points, threshold=0.5)
    trace_contours.copy_seconds += t1 - t0
    trace_contours.trace_seconds += time.perf_counter() - t1
    trace_contours.calls += 1
    dev = mask_logits.device
    return torch.from_numpy(pts).to(dev), torch.from_numpy(counts).to(dev)


trace_contours.calls = 0
trace_contours.copy_seconds = 0.0
trace_contours.trace_seconds = 0.0


class ComposeNet(nn.Module):
    """NCHW images (B, 3, H, W), H and W multiples of 32 -> {"edges",
    "masks"} logits (B, 1, H, W), "contours" (B, max_points, 2),
    "contour_counts" (B,) and "contour_regressions" (B, max_points, 2).

    `forward(x, contours=None)` traces the contours of its own masks
    (trace_contours); `contours=(pts, counts)` injects them instead, as the
    JAX package's `contours=` does. The refine stage (feature sampling and
    RefineNet) runs outside any autocast, in f32 (f64 for an f64 model),
    with RefineNet's linear layers in `refine_fc_dtype`: the JAX package
    keeps the resampled features and the attention stack in f32 under bf16
    (bc.py:220). Weights are drawn from `generator` (Kaiming-uniform convs,
    zero biases, BatchNorms at ones and zeros, FrozenBatchNorms at identity,
    attention gammas at 0)."""

    def __init__(self, max_points: int = DEFAULT_MAX_POINTS,
                 refine_fc_dtype: torch.dtype = torch.float32,
                 backbone_layers: Sequence[int] = (3, 4, 6, 3), backbone_width: int = 64,
                 generator: Generator = None):
        super().__init__()
        self.max_points = max_points
        self.feature_net = FeatureNet(backbone_layers, backbone_width, generator)
        self.mask_net = MaskNet(generator=generator)
        self.edge_net = EdgeNet(generator)
        self.refine_net = RefineNet(max_points, refine_fc_dtype, generator)

    def forward(self, x: torch.Tensor, contours: Optional[Contours] = None
                ) -> Dict[str, torch.Tensor]:
        feature = self.feature_net(x)
        mask_out = self.mask_net(feature)
        edge_out = self.edge_net(mask_out)
        if contours is None:
            contours = trace_contours(mask_out, self.max_points)
        pts, counts = contours
        with torch.autocast(x.device.type, enabled=False):
            feature_p = add_coords(F.pad(_wide(feature), (PADDING,) * 4))
            regressions = self.refine_net(resample_feature_batched(feature_p, pts, counts))
        return {"edges": edge_out, "masks": mask_out, "contours": pts,
                "contour_counts": counts, "contour_regressions": regressions}

    def _mask_logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.mask_net(self.feature_net(x))

    def mask_probs(self, x: torch.Tensor) -> torch.Tensor:
        """The padded sigmoid mask (B, 1, H + 2, W + 2) the tracer reads."""
        return F.pad(torch.sigmoid(self._mask_logits(x)), (PADDING,) * 4)

    def mask_binary(self, x: torch.Tensor) -> torch.Tensor:
        """mask_probs >= 0.5 as uint8."""
        return (self.mask_probs(x) >= 0.5).to(torch.uint8)

    def mask_bits(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        """The thresholded, padded mask bit-packed along W (threshold_bits),
        every stride-th row and column: (B, ceil((H + 2) / stride),
        ceil(ceil((W + 2) / stride) / 8)) uint8."""
        return threshold_bits(self._mask_logits(x), stride)
