"""Losses -- port of the parts of vaeplay_tpu/ops/losses.py that BP, the
circle VAE-GAN and BE train on: the ellipse parameter L1 and the per-point
emit-line loss (reference tools/ops.py), the VAE-GAN's loss pieces
(reference models/networks.py:264-281), BE's mask/edge head loss
(train_BE.py:58-60), and the helpers they use. Functions
on tensors of any device; fixed-shape, mask-weighted means as in the JAX
package.
"""

from typing import Dict

import torch
import torch.nn.functional as F

# tools/ops.py:10 -- shared coordinate scale for point/param regression heads
VALUE_WEIGHT = 10.0
DICE_SMOOTH = 1.0  # tools/ops.py:12


def value_scaled(params: torch.Tensor) -> torch.Tensor:
    """Ellipse params (B, >=4) with cx, cy, rx, ry multiplied by VALUE_WEIGHT
    (the scale the ellipse head regresses and stage 2 takes)."""
    return torch.cat([params[:, :4] * VALUE_WEIGHT, params[:, 4:]], dim=1)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over the elements where mask (broadcastable to x) is
    truthy; an empty mask gives 0 (the sum is divided by max(sum(mask), 1))."""
    mask = mask.to(x.dtype).expand(x.shape)
    return (x * mask).sum() / mask.sum().clamp(min=1.0)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element CE with integer labels (= F.cross_entropy, no reduction)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def dice_loss(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Soft dice over per-sample flattened maps (reference tools/ops.py:12-19).
    inputs, targets: (B, ...) probabilities; returns 1 - mean dice."""
    b = inputs.shape[0]
    iflat, tflat = inputs.reshape(b, -1), targets.reshape(b, -1)
    inter = (iflat * tflat).sum(dim=1)
    score = (2.0 * inter + DICE_SMOOTH) / (iflat.sum(dim=1) + tflat.sum(dim=1) + DICE_SMOOTH)
    return 1.0 - score.mean()


def sigmoid_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy on logits (= BCEWithLogitsLoss, no
    reduction): max(x, 0) - x t + log1p(exp(-|x|))."""
    return F.binary_cross_entropy_with_logits(logits, targets, reduction="none")


def mask_edge_losses(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """0.5 x mean BCE-with-logits + dice(sigmoid): the BE/BC head loss
    (reference train_BE.py:58-60)."""
    return 0.5 * sigmoid_bce_with_logits(logits, targets).mean() + dice_loss(
        torch.sigmoid(logits), targets)


def ellipse_param_loss(preds: torch.Tensor, gt: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Reference tools/ops.py:68-81: gt[:, :4] scaled by VALUE_WEIGHT, L1 per
    part (cx, cy, and the rest)."""
    gt = value_scaled(gt)
    return {
        "loss_cx": (preds[:, 0] - gt[:, 0]).abs().mean(),
        "loss_cy": (preds[:, 1] - gt[:, 1]).abs().mean(),
        "loss_rest": (preds[:, 2:] - gt[:, 2:]).abs().mean(),
    }


def ellipse_pt_loss(
    pred_triggers: torch.Tensor,     # (B, S, 2) trigger logits per sampled point
    pred_line_params: torch.Tensor,  # (B, S, 4) offset_x, offset_y, theta, length
    sample_info: torch.Tensor,       # (B, S, 5) px, py, dpx, dpy, degree index
    gt_targets: torch.Tensor,        # (B, D, 6) per degree: trig, x, y, dx, dy, len
) -> Dict[str, torch.Tensor]:
    """Reference compute_ellipse_pt_loss (tools/ops.py:83-166), batched as the
    JAX package has it. Targets are gathered per sampled point by its degree
    index (truncated to an integer); the trigger head gets CE, split into the
    triggered and the other points' means, plus a dice on each softmax
    channel; the line params get L1 on [dx, dy, angle] split the same way and
    MSE + L1 on the length over the triggered points."""
    deg = sample_info[..., 4].to(torch.int32).long()                  # (B, S)
    ts = torch.gather(gt_targets, 1, deg[..., None].expand(-1, -1, gt_targets.shape[-1]))
    trig_t = ts[..., 0]                                               # (B, S)
    tgt_param = torch.stack([
        (ts[..., 1] - sample_info[..., 0]) * VALUE_WEIGHT,
        (ts[..., 2] - sample_info[..., 1]) * VALUE_WEIGHT,
        torch.arccos((ts[..., 3] * sample_info[..., 2]
                      + ts[..., 4] * sample_info[..., 3]).clamp(-1.0, 1.0)),
        ts[..., 5] * VALUE_WEIGHT,
    ], dim=-1)                                                        # (B, S, 4)
    trig_lbl = trig_t >= 0.5
    ce = softmax_cross_entropy(pred_triggers, trig_t.to(torch.int32))  # (B, S)
    trig_loss = masked_mean(ce, trig_lbl) + masked_mean(ce, ~trig_lbl)
    probs = torch.softmax(pred_triggers, dim=-1)
    # the reference feeds the concatenated (sum S,) vector to compute_dice_loss,
    # whose per-sample flatten makes it a dice per element, averaged over points
    d0 = dice_loss(probs[..., 0].reshape(-1, 1), (1.0 - trig_t).reshape(-1, 1))
    d1 = dice_loss(probs[..., 1].reshape(-1, 1), trig_t.reshape(-1, 1))
    trig_loss = (trig_loss + (d0 + d1) / 2.0) * 2.0

    l1 = (pred_line_params - tgt_param).abs()
    param_normal = (masked_mean(l1[..., :3], trig_lbl[..., None])
                    + masked_mean(l1[..., :3], (~trig_lbl)[..., None]))
    sq = (pred_line_params[..., 3] - tgt_param[..., 3]) ** 2
    param_length = masked_mean(sq, trig_lbl) + masked_mean(l1[..., 3], trig_lbl)
    return {"trig_loss": trig_loss, "param_loss": param_length + param_normal}


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth L1 (Huber, beta 1), no reduction."""
    return F.smooth_l1_loss(pred, target, reduction="none")


def vaegan_losses(x: torch.Tensor, x_tilde: torch.Tensor, disc_layer_original: torch.Tensor,
                  disc_layer_predicted: torch.Tensor, disc_class_original: torch.Tensor,
                  disc_class_predicted: torch.Tensor, disc_class_sampled: torch.Tensor,
                  mus: torch.Tensor, log_variances: torch.Tensor, targets: torch.Tensor,
                  params: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The circle VAE-GAN's loss pieces (reference models/networks.py:264-281),
    per sample, as the trainer composes them (train.py:54-66):
      nle        sum of 0.5 * (x - x_tilde)^2 (a diagnostic)
      kl         -0.5 * sum(-exp(logvar) - mu^2 + logvar + 1)
      mse        sum of 0.5 * (layer_orig - layer_pred)^2
      bce_*      -log(D + 1e-3) for the originals, -log(1 - D + 1e-3) for the
                 reconstructions and the prior samples (not torch's BCE)
      l1_param   smooth_l1(params, targets) summed, over the batch size"""
    b = x.shape[0]
    nle = (0.5 * (x.reshape(b, -1) - x_tilde.reshape(b, -1)) ** 2).sum(dim=1)
    kl = -0.5 * (-torch.exp(log_variances) - mus**2 + log_variances + 1.0).sum(dim=1)
    mse = (0.5 * (disc_layer_original - disc_layer_predicted) ** 2).sum(dim=1)
    return {
        "nle": nle,
        "kl": kl,
        "mse": mse,
        "bce_dis_original": -torch.log(disc_class_original + 1e-3),
        "bce_dis_predicted": -torch.log(1.0 - disc_class_predicted + 1e-3),
        "bce_dis_sampled": -torch.log(1.0 - disc_class_sampled + 1e-3),
        "l1_param": smooth_l1(params, targets).sum() / b,
    }
