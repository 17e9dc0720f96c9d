"""BCP -- contour point classification and regression with adversarial
training.

Port of vaeplay_tpu/models/bcp.py (rebuild of reference
models/networks_BCP.py), NCHW, with the reference's state_dict keys, so that
vaeplay_tpu/models/torch_convert.py:bcp_from_torch and bcp_disc_from_torch
read a port state_dict unchanged:

  TMPBlock        networks_BCP.py:18-35   `convs.{0,1,2}`: 3x3 [stride 2],
                                          1x1, 3x3 lrelu ConvBlocks; the
                                          instance-norm tower's 3x3s carry the
                                          norm and no bias
  ContentEndoer   networks_BCP.py:37-68   the reference's two towers,
                                          `convs1` (plain) and `convs2`
                                          (instance norm), 8 blocks of 64
                                          channels each, stride 4, their
                                          outputs concatenated to 128 channels
  ClassPredictor  networks_BCP.py:220-251 `convs.{0..5}` stride-2 convs
                                          widening to 2048 channels, a mean
                                          over the map, `cls_convs.{0,1,2}`
  LinePredictor   networks_BCP.py:96-218  the per-point bilinear feature
                                          gather, the global "frequency"
                                          embedding (`frequency_encode_img`,
                                          `frequency_encode_img_sub`), the
                                          optional `batch_attention.{0,1,2}`
                                          point attention, then
                                          `frequency_head`, `params_pred` and
                                          `frequency_pred`
  ComposeNet      networks_BCP.py:253-304
  Discriminator   networks_BCP.py:306-363 `global_convs` over the image,
                                          `local_convs` over the flattened
                                          (P, 4) point set (8192 -> 8192 first
                                          at 2048 points), `merge_convs`

The JAX package's MergedTMPBlock, which evaluates both towers as one
block-diagonal 128-channel stack to fill the TPU's 128 lanes, is not
ported: the two towers are the reference's. `ring` (an
ops.attention.RingRouting) runs the point attention as ring attention over
a mesh's "model" ranks where it is active (JAX models/bcp.py:212-295; the
rest of the net stays replicated). BCP has no BatchNorm, so train and eval
mode compute the same.

The per-point features are held channel-major, (B, 2C + 4, P): the point
attention's 1x1 convolutions then give q, k and v in the layout the
attention kernel reads with no copy, and the linear heads read the
(B, P, 2C + 4) transpose.
"""

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vaeplay_torch.core.layers import ConvBlock, DenseBlock, PointSelfAttentionBlock, add_coords
from vaeplay_torch.ops.attention import RingRouting
from vaeplay_torch.ops.contour import find_contour, resample_points
from vaeplay_torch.ops.image import grid_sample

VALUE_WEIGHT = 10.0
ENCODER_CHANNELS = 64  # each tower's
NUM_CLASSES = 2  # solid and emit bubbles
Generator = Optional[torch.Generator]


class TMPBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, if_down: bool = False,
                 bn: Optional[str] = None, generator: Generator = None):
        super().__init__()
        s = 2 if if_down else 1
        self.convs = nn.Sequential(
            ConvBlock(in_channels, features, 3, s, bn=bn, activate="lrelu", generator=generator),
            ConvBlock(features, features, 1, activate="lrelu", generator=generator),
            ConvBlock(features, features, 3, bn=bn, activate="lrelu", generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(x)


class ContentEndoer(nn.Module):
    """The two towers, plain and instance-norm, each `blocks` TMPBlocks of 64
    channels (the first two stride 2), concatenated: (B, 128, H/4, W/4).
    `blocks` < 8 is the slim variant the tests use."""

    out_channels = 2 * ENCODER_CHANNELS

    def __init__(self, in_channels: int, blocks: int = 8, generator: Generator = None):
        super().__init__()

        def tower(bn):
            return nn.Sequential(*(
                TMPBlock(in_channels if i == 0 else ENCODER_CHANNELS, ENCODER_CHANNELS,
                         if_down=i < 2, bn=bn, generator=generator) for i in range(blocks)))

        self.convs1 = tower(None)
        self.convs2 = tower("instance")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.convs1(x), self.convs2(x)], dim=1)


class ClassPredictor(nn.Module):
    """log2(in_size) - 1 stride-2 3x3 convolutions (ReLU), doubling the
    channels up to 2048, a mean over the map, then three linear layers to
    NUM_CLASSES logits."""

    def __init__(self, in_channels: int, in_size: int = 128, generator: Generator = None):
        super().__init__()
        c, convs = in_channels, []
        for _ in range(int(math.log2(in_size)) - 1):
            out_c = min(c * 2, 2048)
            convs.append(ConvBlock(c, out_c, 3, 2, generator=generator))
            c = out_c
        self.convs = nn.Sequential(*convs)
        self.cls_convs = nn.Sequential(
            DenseBlock(c, c // 2, "lrelu", generator=generator),
            DenseBlock(c // 2, c // 4, "lrelu", generator=generator),
            DenseBlock(c // 4, NUM_CLASSES, None, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cls_convs(self.convs(x).mean(dim=(2, 3)))


class LinePredictor(nn.Module):
    """Per-point offsets (B, P, 2) and trigger probabilities (B, P) at given
    contour points. `point_attention` turns on the three attention blocks at
    the site of the reference's commented-out `batch_attention`
    (networks_BCP.py:122-126), over all `pt_size` points, through `ring`
    where it is active."""

    def __init__(self, image_size: int = 128, pt_size: int = 2048, in_channels: int = 128,
                 point_attention: bool = False, generator: Generator = None,
                 ring: Optional[RingRouting] = None):
        super().__init__()
        self.pt_size, self.point_attention = pt_size, point_attention
        c = in_channels
        # int(ln(size)) - 1, a natural logarithm (3 at 128), as the reference has it
        level = int(math.log(image_size)) - 1
        self.frequency_encode_img = nn.Sequential(
            *(ConvBlock(c, c, 3, 2, bn="instance", activate="lrelu", generator=generator)
              for _ in range(level)),
            ConvBlock(c, c, 1, activate="lrelu", generator=generator))
        self.frequency_encode_img_sub = nn.Sequential(
            DenseBlock(c, c, "lrelu", generator=generator),
            DenseBlock(c, c, None, generator=generator),
            DenseBlock(c, c, None, generator=generator))
        d = 2 * c + 2 + NUM_CLASSES
        if point_attention:
            self.batch_attention = nn.Sequential(
                *(PointSelfAttentionBlock(d, generator, ring) for _ in range(3)))
        self.frequency_head = nn.Sequential(DenseBlock(d, d, "lrelu", generator=generator),
                                            DenseBlock(d, d, "lrelu", generator=generator))
        self.params_pred = nn.Sequential(DenseBlock(2 * d, 2 * d, "lrelu", generator=generator),
                                         DenseBlock(2 * d, d, "lrelu", generator=generator),
                                         DenseBlock(d, 2, None, generator=generator))
        self.frequency_pred = nn.Sequential(DenseBlock(d, d, "lrelu", generator=generator),
                                            DenseBlock(d, d, "lrelu", generator=generator),
                                            DenseBlock(d, 1, None, generator=generator))

    def forward(self, x: torch.Tensor, contours: torch.Tensor, counts: torch.Tensor,
                x_cls: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, c = x.shape[:2]
        p = self.pt_size
        valid = (torch.arange(p, device=x.device)[None, :] < counts[:, None])[:, None, :]
        pt_feat = grid_sample(x, contours).transpose(1, 2)          # (B, C, P)
        pt_feat = pt_feat * valid.to(pt_feat.dtype)
        pt_cnts = contours.transpose(1, 2) * valid.to(contours.dtype)  # (B, 2, P)
        y = self.frequency_encode_img_sub(self.frequency_encode_img(x).mean(dim=(2, 3)))
        cls_soft = torch.softmax(x_cls, dim=-1)
        feat = torch.cat([pt_feat, pt_cnts, y[:, :, None].expand(b, c, p),
                          cls_soft[:, :, None].expand(b, cls_soft.shape[1], p)], dim=1)
        if self.point_attention:
            feat = self.batch_attention(feat)
        feat = feat.transpose(1, 2)                                  # (B, P, 2C + 4)
        f = self.frequency_head(feat)
        pred = self.params_pred(torch.cat([feat, f], dim=-1))
        freq = torch.sigmoid(self.frequency_pred(f))[..., 0]
        return pred, freq


class ComposeNet(nn.Module):
    """NCHW images (B, 3, H, W) [img, bmask, emask], contour points (B, P, 2)
    in normalized [-1, 1] coordinates (the ground truth's in training, traced
    from channel 1 at eval, eval_contours_from_masks) and their counts (B,)
    -> {"classes" (B, 2) logits, "contours", "contour_counts", "target_pts"
    (B, P, 2) offsets x VALUE_WEIGHT, "target_frequency" (B, P)}. The line
    predictor reads the class logits detached (networks_BCP.py:296).
    `encoder_out_size` is the reference's constant 128, the encoder's map at
    512 px, which sizes the heads whatever the input size; it and
    `encoder_blocks` give the tests' slim models."""

    def __init__(self, pt_size: int = 2048, point_attention: bool = False,
                 encoder_blocks: int = 8, encoder_out_size: int = 128,
                 generator: Generator = None, ring: Optional[RingRouting] = None):
        super().__init__()
        self.encoder = ContentEndoer(5, encoder_blocks, generator)
        c = self.encoder.out_channels
        self.cls_classifier = ClassPredictor(c, encoder_out_size, generator=generator)
        self.line_predictor = LinePredictor(encoder_out_size, pt_size, c, point_attention,
                                            generator=generator, ring=ring)

    def forward(self, x: torch.Tensor, contours: torch.Tensor,
                counts: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = self.encoder(add_coords(x, normalize=True))
        x_cls = self.cls_classifier(h)
        pred_pts, pred_freq = self.line_predictor(h, contours, counts, x_cls.detach())
        return {"classes": x_cls, "contours": contours, "contour_counts": counts,
                "target_pts": pred_pts, "target_frequency": pred_freq}


def eval_contours_from_masks(x: np.ndarray, max_points: int) -> Tuple[np.ndarray, np.ndarray]:
    """The eval path's contours (networks_BCP.py:277-289): channel 1 (the
    content mask) of each NHWC image (B, H, W, 3) traced on the host at
    level 0.8, decimated to max_points and normalized to [-1, 1]: (pts (B,
    max_points, 2) f32, zero past each count, counts (B,) int32)."""
    b, h = x.shape[0], x.shape[1]
    pts = np.zeros((b, max_points, 2), np.float32)
    counts = np.zeros((b,), np.int32)
    for i in range(b):
        cnt = resample_points(find_contour(np.asarray(x[i, :, :, 1], np.float32), level=0.8),
                              max_points)
        n = min(len(cnt), max_points)
        if n:
            pts[i, :n] = (cnt[:n] / h - 0.5) / 0.5
        counts[i] = n
    return pts, counts


class Discriminator(nn.Module):
    """imgs (B, 3, H, W) and point sets (B, P, 4), zero-padded [x, y, dx, dy]
    x VALUE_WEIGHT -> (B,) real/fake probabilities. The sigmoid runs on the
    logit widened to f32 (f64 for an f64 model), also under bf16 autocast,
    since the BCE that reads it must be f32 (ops/losses.py:bce)."""

    MAX_CHANNELS = 512

    def __init__(self, image_size: int = 512, pt_size: int = 2048, generator: Generator = None):
        super().__init__()
        mc = self.MAX_CHANNELS
        level = int(math.log2(image_size)) - 2 - 1
        convs, c = [ConvBlock(3, 32, 3, 2, activate="lrelu", generator=generator)], 32
        for _ in range(level - 1):
            out_c = min(c * 2, mc)
            convs.append(ConvBlock(c, out_c, 3, 2, bn="instance", activate="lrelu",
                                   generator=generator))
            c = out_c
        convs.append(ConvBlock(c, mc, 1, activate="lrelu", generator=generator))
        self.global_convs = nn.Sequential(*convs)

        c_in, local = pt_size * 4, []
        out_c = min(c_in // 2, mc)
        for _ in range(level):
            local += [DenseBlock(c_in, c_in, "tanh", bias=False, generator=generator),
                      DenseBlock(c_in, out_c, None, bias=False, generator=generator)]
            c_in = out_c
            out_c = min(c_in // 2, mc)
        local.append(DenseBlock(c_in, mc, "lrelu", bias=False, generator=generator))
        self.local_convs = nn.Sequential(*local)
        self.merge_convs = nn.Sequential(
            DenseBlock(2 * mc, 2 * mc, "lrelu", generator=generator),
            DenseBlock(2 * mc, mc, "lrelu", generator=generator),
            DenseBlock(mc, mc, "lrelu", generator=generator),
            DenseBlock(mc, mc // 2, "lrelu", generator=generator),
            DenseBlock(mc // 2, 1, None, bias=False, generator=generator))

    def forward(self, imgs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        global_feat = self.global_convs(imgs).mean(dim=(2, 3))
        local_feat = self.local_convs(targets.reshape(targets.shape[0], -1))
        logit = self.merge_convs(torch.cat([global_feat, local_feat], dim=1))
        # autocast leaves sigmoid in its input's dtype
        return torch.sigmoid(logit.to(torch.promote_types(logit.dtype, torch.float32)))[:, 0]
