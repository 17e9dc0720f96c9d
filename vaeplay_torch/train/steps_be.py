"""The BE train and eval steps -- port of vaeplay_tpu/train/steps_be.py
(reference train_BE.py).

Loss (train_BE.py:58-60), per head (mask, edge):
  0.5 x BCEWithLogits(pred, target) + dice(sigmoid(pred), target)
One backward of their sum and one Adam step over every parameter but the
frozen backbone stem and layer1 (train/state.py:frozen_backbone_adam).
"""

from typing import Callable, Dict, Tuple

import torch

from vaeplay_torch.data.be_data import render_bubble_batch
from vaeplay_torch.models.be import ComposeNet
from vaeplay_torch.ops import losses as L
from vaeplay_torch.ops.bits import pack_mask_bits
from vaeplay_torch.ops.warp import random_joint_rot_flip
from vaeplay_torch.train.state import TrainState
from vaeplay_torch.utils.amp import autocast

METRIC_KEYS = ("loss_edge", "loss_mask")


def be_losses(preds: Dict[str, torch.Tensor], bimgs: torch.Tensor,
              eimgs: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"loss_edge": L.mask_edge_losses(preds["edges"], eimgs),
            "loss_mask": L.mask_edge_losses(preds["masks"], bimgs)}


def make_be_train_step(model: ComposeNet, compute_dtype: torch.dtype = torch.float32) -> Callable:
    """(state, imgs, bimgs, eimgs) -> (state, metrics), updating state (a
    TrainState over `model`, from frozen_backbone_adam) in place.

    imgs (B, 3, H, W), bimgs and eimgs (B, 1, H, W) binary targets, on the
    model's device; the model is in train mode (its BatchNorms use and
    update batch statistics). compute_dtype bfloat16 runs the forward and
    backward under bf16 autocast; the losses and their reductions are f32
    (utils/amp.py). metrics: METRIC_KEYS as detached 0-d tensors."""

    def train_step(state: TrainState, imgs: torch.Tensor, bimgs: torch.Tensor,
                   eimgs: torch.Tensor) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with autocast(imgs.device, compute_dtype):
            preds = model(imgs)
        if compute_dtype == torch.bfloat16:
            preds = {k: v.float() for k, v in preds.items()}
        m = be_losses(preds, bimgs, eimgs)
        state.optimizer.zero_grad()
        (m["loss_edge"] + m["loss_mask"]).backward()
        state.apply_gradients()
        return state, {k: v.detach() for k, v in m.items()}

    return train_step


def augment(imgs: torch.Tensor, bimgs: torch.Tensor, eimgs: torch.Tensor,
            generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The trainer's joint rotation and flip of a batch and its masks, with
    the draws from `generator` (on the batch's device)."""
    imgs, (bimgs, eimgs) = random_joint_rot_flip(imgs, (bimgs, eimgs), generator)
    return imgs, bimgs, eimgs


def make_bubble_train_step(model: ComposeNet, img_size: int,
                           compute_dtype: torch.dtype = torch.float32) -> Callable:
    """(state, params, generator) -> (state, metrics): renders the synthetic
    bubbles from their (B, 5) table on the device (render_bubble_batch),
    augments them there, then make_be_train_step's step. Only the table
    crosses from the host."""
    step = make_be_train_step(model, compute_dtype)

    def fused(state: TrainState, params: torch.Tensor, generator: torch.Generator):
        return step(state, *augment(*render_bubble_batch(img_size, params), generator))

    return fused


def make_be_eval_step(model: ComposeNet) -> Callable:
    """imgs (B, 3, H, W) -> {"edges", "masks"} sigmoid maps (B, 1, H, W): eval
    mode (BatchNorm running statistics), f32, no gradients; the model's mode
    is restored after."""

    @torch.no_grad()
    def eval_step(imgs: torch.Tensor) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            return {k: torch.sigmoid(v) for k, v in model(imgs).items()}
        finally:
            model.train(was_training)

    return eval_step


def make_be_eval_step_packed(model: torch.nn.Module,
                             compute_dtype: torch.dtype = torch.float32) -> Callable:
    """The serving form of make_be_eval_step (JAX steps_be.py:81-113): imgs
    (B, 3, S, S) -> {"edges", "masks"} thresholded at 0.5 and bit-packed
    along W, (B, S, ceil(S / 8)) uint8 on the model's device (ops/bits.py).

    Both manga pastes threshold the sigmoid maps at 0.5 at once
    (eval/manga.py), so only the bits cross back to the host. The threshold
    is `logits >= 0`, with no sigmoid: sigmoid(x) >= 0.5 exactly when x >=
    0. Eval mode, no gradients, the model's mode restored after;
    compute_dtype bfloat16 runs the forward under bf16 autocast, which moves
    only logits near 0 across the threshold."""

    @torch.no_grad()
    def eval_step(imgs: torch.Tensor) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            with autocast(imgs.device, compute_dtype):
                preds = model(imgs)
            return {k: pack_mask_bits(preds[k][:, 0] >= 0) for k in ("edges", "masks")}
        finally:
            model.train(was_training)

    return eval_step
