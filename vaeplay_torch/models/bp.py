"""BP -- ellipse parameter + emit-line prediction for "emit"-type bubbles.

Port of vaeplay_tpu/models/bp.py (rebuild of reference models/networks_BP.py),
NCHW inside, with the reference's state_dict key names. Stage 1 regresses 5
ellipse params (cx, cy, rx, ry, step) from a conv encoder; stage 2 samples
720 points on the detached predicted ellipse, gathers image features there
with one batched grid-sample, and runs attention towers that predict a
per-point trigger class and 4 line params.

  ContentEndoer          networks_BP.py:19-42   `encoder.convs.{0..6}`
  EllipseParamPredictor  networks_BP.py:44-66   `ellipse_predictor.fcs.{0..2}`
                         (the reference's conv stack there is dead code and
                         has no counterpart)
  ValueEncoder           networks_BP.py:68-92   `value_encoder.{fcs,attns}`
  EmitLineParamPredictor networks_BP.py:94-152
  EmitLinePredictor      networks_BP.py:176-240 `emit_line_predictor.convs`
  ComposeNet             networks_BP.py:242-262

Fixed shapes throughout: S = SAMPLE_COUNT = 720 points per image.
"""

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vaeplay_torch.core.layers import ConvBlock, DenseBlock, SelfAttentionBlock
from vaeplay_torch.ops.geometry import sample_points_ellipse
from vaeplay_torch.ops.image import point_sample_ng
from vaeplay_torch.ops.losses import VALUE_WEIGHT

SAMPLE_SCALE = 2
SAMPLE_COUNT = int(360 * SAMPLE_SCALE)
# The reference's emit-line conv pyramid (networks_BP.py:180-188) as
# (channels, stride); ComposeNet reads it when built without emit_channels.
EMIT_CHANNELS: Tuple[Tuple[int, int], ...] = (
    (64, 2), (128, 2), (256, 2), (512, 2), (1024, 2), (2048, 1), (2048, 1))

Generator = Optional[torch.Generator]


class ContentEndoer(nn.Module):
    """7-conv encoder, stride 8, 256 channels (networks_BP.py:19-42). The
    reference's misspelling is kept for API parity."""

    def __init__(self, generator: Generator = None):
        super().__init__()
        layers, c_in = [], 3
        for c, s in [(64, 1), (128, 1), (256, 2), (256, 2), (256, 2), (256, 1), (256, 1)]:
            layers.append(ConvBlock(c_in, c, 3, stride=s, generator=generator))
            c_in = c
        self.convs = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = conv(x)
        return x


class EllipseParamPredictor(nn.Module):
    """avgpool to 4x4 -> 3 linears -> (cx, cy, rx, ry, step) at x10 scale
    (networks_BP.py:44-66). Flattens NCHW (c, h, w) as the reference does."""

    def __init__(self, in_channels: int = 256, generator: Generator = None):
        super().__init__()
        self.fcs = nn.ModuleList([
            DenseBlock(in_channels * 16, in_channels * 4, activate=None, generator=generator),
            DenseBlock(in_channels * 4, in_channels, activate=None, generator=generator),
            DenseBlock(in_channels, 5, activate=None, generator=generator),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.adaptive_avg_pool2d(x, (4, 4)).flatten(1)
        for fc in self.fcs:
            x = fc(x)
        return x


def _attention_stack(x: torch.Tensor, blocks: nn.ModuleList) -> torch.Tensor:
    """(B, S, E) -> (B, S, E) through attention blocks whose positions are the
    E embedding dims and whose channels are the S points: the NCHW map is
    (B, S, E, 1), the reference's layout (networks_BP.py:84-92)."""
    y = x[..., None]
    for block in blocks:
        y = block(y)
    return y[..., 0]


class ValueEncoder(nn.Module):
    """Per-point MLP embed -> 3 attention blocks over embedding positions.
    Input (B, S, E); output (B, S, out_channels)."""

    def __init__(self, in_features: int = 8, out_channels: int = 2048,
                 points: int = SAMPLE_COUNT, generator: Generator = None):
        super().__init__()
        widths = [in_features, 64, 128, 256, out_channels]
        self.fcs = nn.ModuleList(DenseBlock(a, b, activate=None, generator=generator)
                                 for a, b in zip(widths[:-1], widths[1:]))
        self.attns = nn.ModuleList(SelfAttentionBlock(points, generator=generator)
                                   for _ in range(3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for fc in self.fcs:
            x = fc(x)
        return _attention_stack(x, self.attns)


class EmitLineParamPredictor(nn.Module):
    """Trigger + line-param heads over ellipse-sampled point features
    (networks_BP.py:94-152)."""

    def __init__(self, in_channels: int = 2048, points: int = SAMPLE_COUNT,
                 generator: Generator = None):
        super().__init__()
        c = in_channels
        self.value_encoder = ValueEncoder(8, c, points, generator=generator)
        self.batch_attention_a = nn.ModuleList(
            SelfAttentionBlock(points, generator=generator) for _ in range(3))
        self.batch_attention_b = nn.ModuleList(
            SelfAttentionBlock(points, generator=generator) for _ in range(3))
        self.trigger_pred = nn.ModuleList([
            DenseBlock(c, c, activate="lrelu", generator=generator),
            DenseBlock(c, c, activate="lrelu", generator=generator),
            DenseBlock(c, 2, activate=None, generator=generator),
        ])
        self.params_pred = nn.ModuleList([
            DenseBlock(c, c, activate="lrelu", generator=generator),
            DenseBlock(c, c, activate=None, generator=generator),
            DenseBlock(c, 4, activate=None, generator=generator),
        ])

    def forward(self, feat_pts: torch.Tensor, sample_pts: torch.Tensor,
                params: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, _ = feat_pts.shape
        # embed: [cx, cy, rx, ry] broadcast + on-step indicator + the
        # reference's concat-then-reshape of (dpx, dpy, radian), which
        # interleaves the three blocks rather than zipping per point
        # (networks_BP.py:133-138); reproduced bit for bit. Index math in f32.
        params = params.float()
        sample_pts = sample_pts.float()
        param_embed = params[:, None, :4].expand(b, s, 4)
        step = torch.round(params[:, 4:5])  # round half to even, as jnp.round
        idx = torch.arange(s, dtype=torch.float32, device=params.device).expand(b, s)
        # round(step) == 0 makes the remainder NaN and the test False, exactly
        # the reference's torch.remainder(arange, 0) (networks_BP.py:132)
        d_embed = (torch.remainder(idx, step) == 0).float()[..., None]
        scrambled = torch.cat(
            [sample_pts[:, :, 2], sample_pts[:, :, 3], sample_pts[:, :, 5]], dim=-1
        ).reshape(b, s, 3)
        embed = torch.cat([param_embed, d_embed, scrambled], dim=-1).to(feat_pts.dtype)
        x = feat_pts + self.value_encoder(embed)

        t = _attention_stack(x, self.batch_attention_a)
        for fc in self.trigger_pred:
            t = fc(t)
        p = _attention_stack(x, self.batch_attention_b)
        for fc in self.params_pred:
            p = fc(p)
        return t, p


class EmitLinePredictor(nn.Module):
    """Conv pyramid over the raw image + batched ellipse-point feature gather
    + param predictor (networks_BP.py:176-240)."""

    def __init__(self, image_size: int = 512,
                 channels: Sequence[Tuple[int, int]] = EMIT_CHANNELS,
                 generator: Generator = None):
        super().__init__()
        self.image_size = image_size
        layers, c_in = [], 3
        for c, s in channels:
            layers.append(ConvBlock(c_in, c, 3, stride=s, activate="lrelu", generator=generator))
            c_in = c
        self.convs = nn.ModuleList(layers)
        self.param_predictor = EmitLineParamPredictor(c_in, generator=generator)

    def forward(self, x: torch.Tensor, params: torch.Tensor):
        for conv in self.convs:
            x = conv(x)
        # params arrive at x10 scale; stage 2 consumes /VALUE_WEIGHT coords
        # (networks_BP.py:233). Coordinate math stays f32.
        params = params.float()
        params = torch.cat([params[:, :4] / VALUE_WEIGHT, params[:, 4:]], dim=1)
        sample_pts = sample_points_ellipse(params, SAMPLE_COUNT, SAMPLE_SCALE)
        feat_pts = point_sample_ng(x, sample_pts[..., :2], False, "bilinear")
        if_triggers, line_params = self.param_predictor(feat_pts, sample_pts, params)
        return if_triggers, line_params, sample_pts


class ComposeNet(nn.Module):
    """Full BP pipeline (networks_BP.py:242-262). `emit_channels` defaults to
    the module-level EMIT_CHANNELS; `generator` seeds the random init."""

    def __init__(self, image_size: int = 512,
                 emit_channels: Optional[Sequence[Tuple[int, int]]] = None,
                 generator: Generator = None):
        super().__init__()
        self.image_size = image_size
        self.encoder = ContentEndoer(generator=generator)
        self.ellipse_predictor = EllipseParamPredictor(generator=generator)
        self.emit_line_predictor = EmitLinePredictor(
            image_size, EMIT_CHANNELS if emit_channels is None else emit_channels,
            generator=generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: NHWC images (B, H, W, 3), as the JAX model takes them."""
        x = x.permute(0, 3, 1, 2).contiguous()
        ellipse_params = self.ellipse_predictor(self.encoder(x))
        # stage 2 sees detached stage-1 outputs (networks_BP.py:256)
        if_triggers, line_params, sample_pts = self.emit_line_predictor(
            x, ellipse_params.detach())
        return {
            "ellipse_params": ellipse_params,
            "if_triggers": if_triggers,
            "line_params": line_params,
            "sample_infos": sample_pts,
        }

    def emit_line_only(self, x: torch.Tensor, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The teacher-forced stage-2 pass (reference train_BP.py:86-99): the
        emit-line predictor alone on NHWC images x, with ground-truth ellipse
        params at x10 scale."""
        x = x.permute(0, 3, 1, 2).contiguous()
        if_triggers, line_params, sample_pts = self.emit_line_predictor(x, params)
        return {
            "if_triggers": if_triggers,
            "line_params": line_params,
            "sample_infos": sample_pts,
        }
