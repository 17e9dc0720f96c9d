"""The BP train step -- port of vaeplay_tpu/train/steps_bp.py (reference
train_BP.py:63-99).

Each iteration runs two optimizer passes through one Adam:
  1. the full model: ellipse L1 (cx, cy, rest) plus the emit-line loss
     (trigger CE + dice, line-param L1/MSE) on the detached predicted
     ellipse;
  2. teacher-forced: the emit-line predictor alone, on the weights pass 1
     left, with the ground-truth ellipse params (x VALUE_WEIGHT), and only
     the stage-2 loss.

Gradients are cleared with `zero_grad(set_to_none=False)`: in pass 2 the
encoder and the ellipse predictor get zero gradients, and Adam still steps
them on their decayed moments, as optax does in the JAX step. With
`set_to_none=True` (torch's default) Adam would skip them instead.

With compute_dtype bfloat16 both passes run the model under bf16 autocast
(utils/amp.py) and its outputs are widened to f32 before the losses; pass
2's ground-truth ellipse params stay f32, as the model's coordinate math
does (models/bp.py). Parameters, Adam state and losses stay f32.
"""

from typing import Callable, Dict, Tuple

import torch

from vaeplay_torch.models.bp import ComposeNet
from vaeplay_torch.ops import losses as L
from vaeplay_torch.train.state import TrainState
from vaeplay_torch.utils.amp import autocast

METRIC_KEYS = ("loss_cx", "loss_cy", "loss_rest", "trig_loss", "param_loss",
               "pos_trig_loss", "pos_param_loss")


def _pt_loss(preds: Dict[str, torch.Tensor], p2_targets: torch.Tensor) -> Dict[str, torch.Tensor]:
    return L.ellipse_pt_loss(preds["if_triggers"], preds["line_params"],
                             preds["sample_infos"][..., :5], p2_targets)


def _f32(preds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in preds.items()}


def loss_phase1(model: ComposeNet, imgs: torch.Tensor, p1_targets: torch.Tensor,
                p2_targets: torch.Tensor, compute_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pass 1's loss (the full model) and its five parts."""
    with autocast(imgs.device, compute_dtype):
        preds = _f32(model(imgs))
    el = L.ellipse_param_loss(preds["ellipse_params"], p1_targets)
    pt = _pt_loss(preds, p2_targets)
    total = el["loss_cx"] + el["loss_cy"] + el["loss_rest"] + pt["trig_loss"] + pt["param_loss"]
    return total, {**el, **pt}


def loss_phase2(model: ComposeNet, imgs: torch.Tensor, p1_scaled: torch.Tensor,
                p2_targets: torch.Tensor, compute_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pass 2's loss (teacher-forced stage 2, params at x10 scale) and its
    two parts."""
    with autocast(imgs.device, compute_dtype):
        preds = _f32(model.emit_line_only(imgs, p1_scaled))
    pt = _pt_loss(preds, p2_targets)
    return pt["trig_loss"] + pt["param_loss"], {"pos_trig_loss": pt["trig_loss"],
                                                "pos_param_loss": pt["param_loss"]}


def _descend(state: TrainState, loss: torch.Tensor) -> None:
    state.optimizer.zero_grad(set_to_none=False)
    loss.backward()
    state.apply_gradients()


def make_bp_train_step(model: ComposeNet,
                       compute_dtype: torch.dtype = torch.float32) -> Callable:
    """(state, imgs, p1_targets, p2_targets) -> (state, metrics), updating
    state (whose model is `model`) in place.

    imgs: (B, H, W, 3) stacked [img, bmask, emask] channels (dataset.py:414);
    p1_targets: (B, 5) normalized ellipse params; p2_targets: (B, 720, 6)
    per-sample-point [trigger, x, y, dx, dy, length]; all f32 on the model's
    device. metrics: the seven losses as detached 0-d tensors on the device.
    compute_dtype bfloat16 runs both passes under bf16 autocast.
    """

    def train_step(state: TrainState, imgs: torch.Tensor, p1_targets: torch.Tensor,
                   p2_targets: torch.Tensor) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        total, m1 = loss_phase1(model, imgs, p1_targets, p2_targets, compute_dtype)
        _descend(state, total)
        total, m2 = loss_phase2(model, imgs, L.value_scaled(p1_targets), p2_targets,
                                compute_dtype)
        _descend(state, total)
        metrics = {**m1, **m2}
        return state, {k: metrics[k].detach() for k in METRIC_KEYS}

    return train_step
