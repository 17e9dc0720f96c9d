"""The BC train step -- port of vaeplay_tpu/train/steps_bc.py:make_bc_train_step
(reference train_BC.py:52-68).

Loss: (edge BCE + dice) + (mask BCE + dice) + the chamfer point regression
of the traced contours and their regressions against the target and RDP
key contours (ops/losses.py). One backward of their sum and one Adam step
over every parameter but the frozen backbone stem and layer1
(train/state.py:frozen_backbone_adam), with StepLR(10, 0.5) counted in
epochs (train/state.py:step_lr_by_epoch).

The contours are traced inside the forward (models/bc.py:trace_contours),
as the JAX package's callback mode does; the JAX package's two-program
bridge (make_bc_mask_step, BridgeTracer) exists for a runtime without host
callbacks and is not ported.
"""

from typing import Callable, Dict, Optional, Tuple

import torch

from vaeplay_torch.models.bc import ComposeNet, Contours
from vaeplay_torch.ops import losses as L
from vaeplay_torch.train.state import TrainState
from vaeplay_torch.utils.amp import autocast

METRIC_KEYS = ("loss_edge", "loss_mask", "loss_regress")
TARGET_KEYS = ("bimgs", "eimgs", "tgt_pts", "tgt_mask", "key_pts", "key_mask")


def bc_losses(preds: Dict[str, torch.Tensor], bimgs: torch.Tensor, eimgs: torch.Tensor,
              tgt_pts: torch.Tensor, tgt_mask: torch.Tensor, key_pts: torch.Tensor,
              key_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The three losses of one forward's predictions (f32 or wider)."""
    counts = preds["contour_counts"]
    n = preds["contours"].shape[1]
    pred_mask = (torch.arange(n, device=counts.device)[None, :] < counts[:, None]).to(
        preds["contour_regressions"].dtype)
    return {"loss_edge": L.mask_edge_losses(preds["edges"], eimgs),
            "loss_mask": L.mask_edge_losses(preds["masks"], bimgs),
            "loss_regress": L.chamfer_pt_regression_loss(
                preds["contours"], pred_mask, preds["contour_regressions"],
                tgt_pts, tgt_mask, key_pts, key_mask)}


def make_bc_train_step(model: ComposeNet, compute_dtype: torch.dtype = torch.float32
                       ) -> Callable:
    """(state, imgs, bimgs, eimgs, tgt_pts, tgt_mask, key_pts, key_mask,
    contours=None) -> (state, metrics), updating state (frozen_backbone_adam
    over `model`) in place.

    imgs (B, 3, H, W), bimgs and eimgs (B, 1, H, W) binary targets, the
    target and key points and their masks (data/bc_data.py), all on the
    model's device; the model is in train mode. contours None traces the
    masks of this forward; (pts, counts) injects them. compute_dtype
    bfloat16 runs the convolution stages under bf16 autocast (the refine
    stage stays f32, its linear layers in the model's refine_fc_dtype); the
    losses are f32. metrics: METRIC_KEYS as detached 0-d tensors."""

    def train_step(state: TrainState, imgs: torch.Tensor, bimgs: torch.Tensor,
                   eimgs: torch.Tensor, tgt_pts: torch.Tensor, tgt_mask: torch.Tensor,
                   key_pts: torch.Tensor, key_mask: torch.Tensor,
                   contours: Optional[Contours] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with autocast(imgs.device, compute_dtype):
            preds = model(imgs, contours=contours)
        if compute_dtype == torch.bfloat16:
            preds = {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in preds.items()}
        m = bc_losses(preds, bimgs, eimgs, tgt_pts, tgt_mask, key_pts, key_mask)
        state.optimizer.zero_grad()
        (m["loss_edge"] + m["loss_mask"] + m["loss_regress"]).backward()
        state.apply_gradients()
        return state, {k: v.detach() for k, v in m.items()}

    return train_step
