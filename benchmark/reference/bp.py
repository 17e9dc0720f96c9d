"""Plain reference of BP (kungyao/vae-play models/networks_BP.py, train_BP.py,
test_BP.py) as the port computes it: ellipse parameters from a conv
encoder, 720 points sampled on the detached ellipse, their features
gathered from a conv pyramid, and attention towers over the 2048 embedding
positions that predict a trigger class and 4 line parameters per point.

Functional, over a dict of weights with the port's state_dict keys. The
synthetic emit-line batches are made here again from the seed, as the
port's `SyntheticEmitDataset` makes them (numpy, bit for bit). A run can
hand stage 2 the ellipse parameters of another run's stage 1 (`teacher`),
so that both sides sample their points at the same ellipse: BP rounds the
fifth parameter to an integer step, and two precisions can round it apart.
"""

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.common import (Adam, Ops, Spec, TrainRecord, activation, conv_spec,
                                        grads_of, leaves, linear_spec, make_weights, nudged,
                                        run_train, swap_last_row)

VALUE_WEIGHT = 10.0
DICE_SMOOTH = 1.0
ATTN_BLOCKS = 3
LOSS_KEYS = ("loss_cx", "loss_cy", "loss_rest", "trig_loss", "param_loss",
             "pos_trig_loss", "pos_param_loss")  # pass 1's five come before the step's first update
OUTPUT_KEYS = ("ellipse_params", "if_triggers", "line_params")  # compared after a step's forward
PRE = "emit_line_predictor.param_predictor."
# SAGAN's gamma starts at 0, which leaves attention out of a first step's
# outputs; a model in training has it away from 0, and so do these weights
GAMMA_BOUND = 0.5


# ---- weights -------------------------------------------------------------------------------

def _attention_specs(prefix: str, points: int) -> List[Spec]:
    cq = max(points // 8, 1)
    out = []
    for i in range(ATTN_BLOCKS):
        p = f"{prefix}{i}."
        out.append(Spec(p + "gamma", (1,), GAMMA_BOUND))
        out += conv_spec(p + "q.conv.0.", cq, points, 1)
        out += conv_spec(p + "k.conv.0.", cq, points, 1)
        out += conv_spec(p + "v.conv.0.", points, points, 1)
    return out


def param_specs(cfg: dict) -> List[Spec]:
    """BP's weights, in the port's state_dict order."""
    specs, c_in = [], 3
    for i, (c, _) in enumerate(cfg["encoder_channels"]):
        specs += conv_spec(f"encoder.convs.{i}.conv.0.", c, c_in, 3)
        c_in = c
    for i, (n_out, n_in) in enumerate([(c_in * 4, c_in * 16), (c_in, c_in * 4), (5, c_in)]):
        specs += linear_spec(f"ellipse_predictor.fcs.{i}.fc.0.", n_out, n_in)
    c_in = 3
    for i, (c, _) in enumerate(cfg["emit_channels"]):
        specs += conv_spec(f"emit_line_predictor.convs.{i}.conv.0.", c, c_in, 3)
        c_in = c
    s = cfg["sample_count"]
    widths = [8, 64, 128, 256, c_in]
    for i in range(4):
        specs += linear_spec(f"{PRE}value_encoder.fcs.{i}.fc.0.", widths[i + 1], widths[i])
    specs += _attention_specs(PRE + "value_encoder.attns.", s)
    specs += _attention_specs(PRE + "batch_attention_a.", s)
    specs += _attention_specs(PRE + "batch_attention_b.", s)
    for head, n_out in (("trigger_pred", 2), ("params_pred", 4)):
        for i, (o, n) in enumerate([(c_in, c_in), (c_in, c_in), (n_out, c_in)]):
            specs += linear_spec(f"{PRE}{head}.{i}.fc.0.", o, n)
    return specs


def weight_seed(seed: int) -> int:
    return seed % (2 ** 63)


def weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return make_weights(param_specs(cfg), weight_seed(seed), device)


# ---- data ----------------------------------------------------------------------------------

def sample_batch(cfg: dict, batch_size: int, seed: int, batch_seed: int):
    """(images (B, S, S, 3), phase-1 params (B, 5), phase-2 rows (B, 720, 6)),
    f32 numpy: procedural emit-line bubbles, an ellipse ring with radial
    lines every `step` samples, as the port's SyntheticEmitDataset draws them
    for dataset seed `seed` and batch seed `batch_seed`."""
    rng = np.random.default_rng((seed, batch_seed))
    n, count = cfg["image_size"], cfg["sample_count"]
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    imgs = np.zeros((batch_size, n, n, 3), np.float32)
    p1s = np.zeros((batch_size, 5), np.float32)
    p2s = np.zeros((batch_size, count, 6), np.float32)
    ds = np.arange(count, dtype=np.float32)
    radians = ds / 2.0 * np.pi / 180.0
    for b in range(batch_size):
        cx, cy = rng.uniform(-0.3, 0.3, 2)
        rx, ry = rng.uniform(0.25, 0.55, 2)
        step = float(rng.integers(10, 40))
        length = rng.uniform(0.1, 0.3)
        p1s[b] = [cx, cy, rx, ry, step]
        px = cx + rx * np.cos(radians)
        py = cy + ry * np.sin(radians)
        dpx = rx * -np.sin(radians)
        dpy = ry * np.cos(radians)
        norm = np.sqrt(dpx ** 2 + dpy ** 2)
        dpx, dpy = dpy / norm, -dpx / norm
        trig = (ds % step == 0).astype(np.float32)
        p2s[b] = np.stack([trig, px, py, dpx, dpy, np.full_like(ds, length)], axis=-1)
        exn = (xx / (n - 1) - 0.5) / 0.5
        eyn = (yy / (n - 1) - 0.5) / 0.5
        d = ((exn - cx) / rx) ** 2 + ((eyn - cy) / ry) ** 2
        inside = d <= 1.0
        ring = (d <= 1.0) & (d >= 0.8)
        imgs[b, :, :, 0] = ring.astype(np.float32)
        imgs[b, :, :, 1] = inside.astype(np.float32)
        imgs[b, :, :, 2] = ring.astype(np.float32)
        sel = trig > 0
        for t in np.linspace(0, 1, 8):
            lx = px[sel] + dpx[sel] * length * t
            ly = py[sel] + dpy[sel] * length * t
            ix = np.clip(((lx * 0.5 + 0.5) * (n - 1)).astype(int), 0, n - 1)
            iy = np.clip(((ly * 0.5 + 0.5) * (n - 1)).astype(int), 0, n - 1)
            imgs[b, iy, ix, 0] = 1.0
    return imgs, p1s, p2s


def inference_pool(cfg: dict, traffic: dict, seed: int) -> List[np.ndarray]:
    """The images an inference cell cycles through: `pool_batches` batches
    of `batch_size`, batch seeds 0, 1, ..."""
    return [sample_batch(cfg, traffic["batch_size"], seed, b)[0]
            for b in range(traffic["pool_batches"])]


# ---- model ---------------------------------------------------------------------------------

def _conv(ops: Ops, P, prefix: str, x, stride: int, act: Optional[str], slope: float = 0.02):
    w = P[prefix + "conv.0.weight"]
    return activation(ops.conv2d(x, w, P.get(prefix + "conv.0.bias"), stride,
                                 (w.shape[-1] - 1) // 2), act, slope)


def _dense(ops: Ops, P, prefix: str, x, act: Optional[str]):
    return activation(ops.linear(x, P[prefix + "fc.0.weight"], P[prefix + "fc.0.bias"]), act, 0.2)


def _attention_stack(ops: Ops, P, prefix: str, x):
    """(B, S, E) through SAGAN blocks over the E positions of the (B, S, E,
    1) map: out = gamma softmax(q kᵀ) v + x."""
    y = x[..., None]
    b, c, h, w = y.shape
    pos = lambda t: t.reshape(b, t.shape[1], h * w).transpose(1, 2)
    for i in range(ATTN_BLOCKS):
        p = f"{prefix}{i}."
        q, k, v = (_conv(ops, P, p + n + ".", y, 1, "relu") for n in ("q", "k", "v"))
        out = ops.attention(pos(q), pos(k), pos(v)).transpose(1, 2).reshape(b, c, h, w)
        y = P[p + "gamma"] * out + y
    return y[..., 0]


def sample_points_ellipse(params, count: int, scale: float):
    """(B, S, 6) [px, py, outward normal (dpx, dpy), index, radian] on the
    ellipses (cx, cy, rx, ry) of params, in f32."""
    p = params.float()
    cx, cy, rx, ry = (p[:, i, None] for i in range(4))
    ds = torch.arange(count, dtype=torch.float32, device=p.device)
    radians = ds / scale * (math.pi / 180.0)
    cos_t, sin_t = torch.cos(radians), torch.sin(radians)
    px, py = cx + rx * cos_t, cy + ry * sin_t
    dpx, dpy = rx * -sin_t, ry * cos_t
    norm = torch.sqrt(dpx ** 2 + dpy ** 2)
    dpx, dpy = dpy / norm, -(dpx / norm)
    b = p.shape[0]
    return torch.stack([px, py, dpx, dpy, ds.expand(b, count), radians.expand(b, count)], dim=-1)


def _point_features(x, grid):
    """Bilinear samples (B, N, C) of the map x at grid (B, N, 2) in [-1, 1],
    zero outside, computed in f32 and returned in x's dtype."""
    out = F.grid_sample(x.float(), grid.float()[:, None], mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out[:, :, 0, :].transpose(1, 2).to(x.dtype)


def stage1(ops: Ops, P, cfg: dict, x):
    """NCHW image -> (B, 5) ellipse parameters at x10 scale."""
    for i, (_, s) in enumerate(cfg["encoder_channels"]):
        x = _conv(ops, P, f"encoder.convs.{i}.", x, s, "relu")
    x = F.adaptive_avg_pool2d(x, (4, 4)).flatten(1)
    for i in range(3):
        x = _dense(ops, P, f"ellipse_predictor.fcs.{i}.", x, None)
    return x


def stage2(ops: Ops, P, cfg: dict, x, params):
    """NCHW image and (B, 5) ellipse parameters at x10 scale -> trigger
    logits (B, S, 2), line parameters (B, S, 4), sample infos (B, S, 6)."""
    for i, (_, s) in enumerate(cfg["emit_channels"]):
        x = _conv(ops, P, f"emit_line_predictor.convs.{i}.", x, s, "lrelu")
    params = params.float()
    params = torch.cat([params[:, :4] / VALUE_WEIGHT, params[:, 4:]], dim=1)
    sample = sample_points_ellipse(params, cfg["sample_count"], cfg["sample_scale"])
    feat = _point_features(x, sample[..., :2])
    b, s, _ = feat.shape
    step = torch.round(params[:, 4:5])
    idx = torch.arange(s, dtype=torch.float32, device=params.device).expand(b, s)
    on_step = (torch.remainder(idx, step) == 0).float()[..., None]  # NaN (False) at step 0
    # the reference's concat-then-reshape of (dpx, dpy, radian) (networks_BP.py:133-138)
    scrambled = torch.cat([sample[:, :, 2], sample[:, :, 3], sample[:, :, 5]], -1).reshape(b, s, 3)
    v = torch.cat([params[:, None, :4].expand(b, s, 4), on_step, scrambled], -1).to(feat.dtype)
    for i in range(4):
        v = _dense(ops, P, f"{PRE}value_encoder.fcs.{i}.", v, None)
    x = feat + _attention_stack(ops, P, PRE + "value_encoder.attns.", v)
    t = _attention_stack(ops, P, PRE + "batch_attention_a.", x)
    for i, act in enumerate(("lrelu", "lrelu", None)):
        t = _dense(ops, P, f"{PRE}trigger_pred.{i}.", t, act)
    p = _attention_stack(ops, P, PRE + "batch_attention_b.", x)
    for i, act in enumerate(("lrelu", None, None)):
        p = _dense(ops, P, f"{PRE}params_pred.{i}.", p, act)
    return t, p, sample


def _teacher(answer, imgs):
    """Another run's ellipses where they fit this batch; a run whose answers
    do not fit (it dropped rows) is followed on the reference's own."""
    return answer if answer is not None and answer.shape[0] == imgs.shape[0] else None


def forward(ops: Ops, P, cfg: dict, imgs, teacher=None) -> Dict[str, torch.Tensor]:
    """NHWC images -> BP's four outputs. Stage 2 runs at the detached stage-1
    output, or at `teacher` where given."""
    x = imgs.permute(0, 3, 1, 2).contiguous()
    ellipse = stage1(ops, P, cfg, x)
    t, p, s = stage2(ops, P, cfg, x, ellipse.detach() if teacher is None else teacher)
    return {"ellipse_params": ellipse, "if_triggers": t, "line_params": p, "sample_infos": s}


# ---- losses (tools/ops.py) -----------------------------------------------------------------

def value_scaled(params):
    return torch.cat([params[:, :4] * VALUE_WEIGHT, params[:, 4:]], dim=1)


def _masked_mean(x, mask):
    mask = mask.to(x.dtype).expand(x.shape)
    return (x * mask).sum() / mask.sum().clamp(min=1.0)


def _dice(inputs, targets):
    b = inputs.shape[0]
    i, t = inputs.reshape(b, -1), targets.reshape(b, -1)
    score = (2.0 * (i * t).sum(1) + DICE_SMOOTH) / (i.sum(1) + t.sum(1) + DICE_SMOOTH)
    return 1.0 - score.mean()


def ellipse_param_loss(preds, gt) -> Dict[str, torch.Tensor]:
    gt = value_scaled(gt)
    return {"loss_cx": (preds[:, 0] - gt[:, 0]).abs().mean(),
            "loss_cy": (preds[:, 1] - gt[:, 1]).abs().mean(),
            "loss_rest": (preds[:, 2:] - gt[:, 2:]).abs().mean()}


def ellipse_pt_loss(triggers, line_params, sample_info, targets) -> Dict[str, torch.Tensor]:
    """compute_ellipse_pt_loss (tools/ops.py:83-166), batched: targets
    gathered per point by its index; CE split into triggered and other
    points plus a per-point dice on each softmax channel; L1 on [dx, dy,
    angle] split alike, MSE + L1 on the length over the triggered points."""
    deg = sample_info[..., 4].to(torch.int32).long()
    ts = torch.gather(targets, 1, deg[..., None].expand(-1, -1, targets.shape[-1]))
    trig_t = ts[..., 0]
    tgt = torch.stack([
        (ts[..., 1] - sample_info[..., 0]) * VALUE_WEIGHT,
        (ts[..., 2] - sample_info[..., 1]) * VALUE_WEIGHT,
        torch.arccos((ts[..., 3] * sample_info[..., 2]
                      + ts[..., 4] * sample_info[..., 3]).clamp(-1.0, 1.0)),
        ts[..., 5] * VALUE_WEIGHT], dim=-1)
    lbl = trig_t >= 0.5
    ce = -torch.gather(torch.log_softmax(triggers, -1), -1,
                       trig_t.to(torch.int32).long()[..., None])[..., 0]
    trig = _masked_mean(ce, lbl) + _masked_mean(ce, ~lbl)
    probs = torch.softmax(triggers, dim=-1)
    d0 = _dice(probs[..., 0].reshape(-1, 1), (1.0 - trig_t).reshape(-1, 1))
    d1 = _dice(probs[..., 1].reshape(-1, 1), trig_t.reshape(-1, 1))
    trig = (trig + (d0 + d1) / 2.0) * 2.0
    l1 = (line_params - tgt).abs()
    normal = (_masked_mean(l1[..., :3], lbl[..., None])
              + _masked_mean(l1[..., :3], (~lbl)[..., None]))
    sq = (line_params[..., 3] - tgt[..., 3]) ** 2
    return {"trig_loss": trig,
            "param_loss": _masked_mean(sq, lbl) + _masked_mean(l1[..., 3], lbl) + normal}


# ---- runs ----------------------------------------------------------------------------------

def train(cfg: dict, traffic: dict, seed: int, device, precision: str = "f32",
          steps: int = 3, teacher: Optional[list] = None, fault: Optional[str] = None,
          against: Optional[dict] = None, keep_first_grads: bool = False,
          nudge: bool = False) -> TrainRecord:
    """`steps` iterations of train_BP from the seed's weights on the seed's
    batches (batch seeds 0, 1, ...): pass 1 trains the full model on its own
    detached ellipse (or teacher[k]), pass 2 the emit-line predictor alone
    at the ground-truth ellipse, one Adam stepping every leaf in both
    passes. Planted faults (`fault`): "half_batch" trains on the first half
    of each batch, "row_swapped" hands the losses the first image's outputs
    in place of the last's. `nudge` starts from the weights one ulp up."""
    ops = Ops(precision)
    w = weights(cfg, seed, device)
    P = leaves(nudged(w) if nudge else w)
    opt = Adam(P, cfg["train"]["lr"], tuple(cfg["train"]["betas"]), cfg["train"]["eps"])
    b = traffic["batch_size"]

    def step(k, descend):
        imgs, p1, p2 = (torch.from_numpy(a).float().to(device)
                        for a in sample_batch(cfg, b, seed, k))
        if fault == "half_batch":
            imgs, p1, p2 = imgs[:b // 2], p1[:b // 2], p2[:b // 2]
        with ops.context(device):
            raw = forward(ops, P, cfg, imgs, _teacher(teacher[k] if teacher else None, imgs))
        if fault == "row_swapped":
            raw = {n: swap_last_row(v) for n, v in raw.items()}
        preds = {n: v.float() for n, v in raw.items()}
        m = {**ellipse_param_loss(preds["ellipse_params"], p1),
             **ellipse_pt_loss(preds["if_triggers"], preds["line_params"],
                               preds["sample_infos"][..., :5], p2)}
        descend(opt, grads_of(sum(m.values()), P))
        x = imgs.permute(0, 3, 1, 2).contiguous()
        with ops.context(device):
            t, p, s = stage2(ops, P, cfg, x, value_scaled(p1))
        pt = ellipse_pt_loss(t.float(), p.float(), s.float()[..., :5], p2)
        descend(opt, grads_of(pt["trig_loss"] + pt["param_loss"], P))
        m.update(pos_trig_loss=pt["trig_loss"], pos_param_loss=pt["param_loss"])
        return ({k: m[k].detach() for k in LOSS_KEYS}, raw["ellipse_params"].detach(),
                {n: raw[n] for n in OUTPUT_KEYS})

    return run_train(step, P, steps, ops, LOSS_KEYS[:5], against, keep_first_grads)


@torch.no_grad()
def infer(cfg: dict, P: Dict[str, torch.Tensor], imgs: np.ndarray, device, ops: Ops,
          teacher=None) -> Dict[str, torch.Tensor]:
    """test_BP's forward of NHWC f32 images, outputs in f32; stage 2 at
    `teacher` where given."""
    x = torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).to(device)
    with ops.context(device):
        out = forward(ops, P, cfg, x, _teacher(teacher, x))
    return {k: v.float() for k, v in out.items()}
