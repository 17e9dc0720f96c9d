"""The BE_GAN train step -- port of vaeplay_tpu/train/steps_be_gan.py
(:35-156; reference train_BE_GAN.py:130-165): two phases an iteration.

  D phase  G runs in train mode with no gradient (its BatchNorm statistics
           still advance); D runs on the real masks, then on sigmoid(G's
           masks and edges), each call updating D's running statistics;
             d_adv  = 1 - mean |D(fake).feats - D(real).feats|
             d_type = CE(D(real).type, labels)
           D's Adam (lr x 0.1, betas (0.5, 0.999)) steps.
  G phase  against the updated D: G in train mode; D on the real masks with
           no gradient (its statistics still advance), then on sigmoid(G's
           outputs);
             2 mask + 2 edge (0.5 BCE + dice each) + mean |fake - real feats|
             + CE(D(fake).type, labels)
             + 0.5 (edge_loss(sigmoid masks) + edge_loss(sigmoid edges))
           G's Adam (lr, betas (0.5, 0.999)) steps, over everything but the
           frozen backbone stem and layer1.

The G phase takes gradients with respect to G's trainable parameters only
(torch.autograd.grad), as the JAX step does: D's `.grad` keeps the D
phase's gradients and no weight gradient of D is computed.
"""

from typing import Callable, Dict, Tuple

import torch

from vaeplay_torch.ops import losses as L
from vaeplay_torch.train.state import GanState
from vaeplay_torch.utils.amp import autocast

D_KEYS = ("d_adv_loss", "d_type_loss")
G_KEYS = ("loss_edge", "loss_mask", "g_adv_loss", "g_type_loss", "loss_cnt")
METRIC_KEYS = D_KEYS + G_KEYS  # the JAX CLI's AVG_KEYS (cli/train_be_gan.py:29-30)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return L.softmax_cross_entropy(logits, labels).mean()


def make_be_gan_train_step(g: torch.nn.Module, d: torch.nn.Module,
                           compute_dtype: torch.dtype = torch.float32) -> Callable:
    """(gan_state, imgs, bimgs, eimgs, labels) -> (gan_state, metrics),
    updating the GanState over g and d in place.

    imgs (B, 3, H, W), bimgs and eimgs (B, 1, H, W) binary targets, labels
    (B,) integer types, on the models' device; both models in train mode.
    compute_dtype bfloat16 runs both nets' forward and backward under bf16
    autocast; parameters, optimizer state, BatchNorm buffers and the losses
    stay f32 (utils/amp.py). metrics: METRIC_KEYS as detached 0-d tensors.
    The phases are exposed as `.d_phase` and `.g_phase`, each (gan_state,
    *batch) -> (gan_state, its metrics)."""

    def widen(t: torch.Tensor) -> torch.Tensor:  # bf16 outputs -> f32 losses
        return t.float() if compute_dtype == torch.bfloat16 else t

    def run_g(imgs: torch.Tensor) -> Dict[str, torch.Tensor]:
        with autocast(imgs.device, compute_dtype):
            preds = g(imgs)
        return {k: widen(v) for k, v in preds.items()}

    def run_d(imgs, m1, m2) -> Tuple[torch.Tensor, torch.Tensor]:
        with autocast(imgs.device, compute_dtype):
            types, feats = d(imgs, m1, m2)
        return widen(types), widen(feats)

    def d_phase(gs: GanState, imgs, bimgs, eimgs, labels):
        with torch.no_grad():
            preds = run_g(imgs)
        real_type, real_feats = run_d(imgs, bimgs, eimgs)
        _, fake_feats = run_d(imgs, torch.sigmoid(preds["masks"]), torch.sigmoid(preds["edges"]))
        m = {"d_adv_loss": 1.0 - (fake_feats - real_feats).abs().mean(),
             "d_type_loss": _ce(real_type, labels)}
        gs.d.optimizer.zero_grad()
        (m["d_adv_loss"] + m["d_type_loss"]).backward()
        gs.d.apply_gradients()
        return gs, {k: v.detach() for k, v in m.items()}

    def g_phase(gs: GanState, imgs, bimgs, eimgs, labels):
        preds = run_g(imgs)
        pm, pe = preds["masks"], preds["edges"]
        sm, se = torch.sigmoid(pm), torch.sigmoid(pe)
        with torch.no_grad():
            _, real_feats = run_d(imgs, bimgs, eimgs)
        fake_type, fake_feats = run_d(imgs, sm, se)
        m = {"loss_edge": L.mask_edge_losses(pe, eimgs),
             "loss_mask": L.mask_edge_losses(pm, bimgs),
             "g_adv_loss": (fake_feats - real_feats).abs().mean(),
             "g_type_loss": _ce(fake_type, labels),
             "loss_cnt": L.edge_loss(sm, bimgs) + L.edge_loss(se, eimgs)}
        total = (2.0 * m["loss_mask"] + 2.0 * m["loss_edge"] + m["g_adv_loss"]
                 + m["g_type_loss"] + 0.5 * m["loss_cnt"])
        params = [p for group in gs.g.optimizer.param_groups for p in group["params"]]
        # the FPN's unread levels get None, as .backward() leaves them
        for p, grad in zip(params, torch.autograd.grad(total, params, allow_unused=True)):
            p.grad = grad
        gs.g.apply_gradients()
        return gs, {k: v.detach() for k, v in m.items()}

    def train_step(gs: GanState, imgs, bimgs, eimgs, labels):
        gs, dm = d_phase(gs, imgs, bimgs, eimgs, labels)
        gs, gm = g_phase(gs, imgs, bimgs, eimgs, labels)
        return gs, {**dm, **gm}

    train_step.d_phase = d_phase
    train_step.g_phase = g_phase
    return train_step
