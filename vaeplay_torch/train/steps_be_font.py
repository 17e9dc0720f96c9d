"""The BE_font train step -- port of vaeplay_tpu/train/steps_be_font.py
(reference train_BE_font.py:97-178): three phases, three optimizers.

  D phase  G runs under no_grad (train mode: its BatchNorm statistics still
           update); D on the real [mask, edge] maps, then on G's, detached:
           d_loss = 0.5 (BCE(real -> 1) + BCE(fake -> 0)) + CE(aux_real,
           labels); D's Adam steps.
  G phase  10 (BCE + dice) on the masks and on the edges + 2 BCE(D(fake) ->
           1) + loss_g_aux, which the reference sets to loss_g_adv x 5
           (train_BE_font.py:142; kept as it is). The aux CE against the
           updated D is logged as g_aux_ce and reaches no loss. D's
           parameters stop requiring a gradient meanwhile, so the backward
           reaches only G; G's Adam steps every parameter that has a
           gradient (the style encoder, unused with labels, has none).
  S phase  the updated G with labels, under no_grad, gives the targets; G
           with y=None (its style encoder's encodings) is pulled toward them:
           BCE+dice on the masks and the edges + 2 (L1(masks) + L1(edges)).
           The gradient is taken with torch.autograd.grad over the style
           encoder's parameters only, and only the `style` Adam steps: no
           U-Net gradient is left in .grad for the next G phase.

Every forward runs in train mode, so G's running statistics update 4 times
a step and D's 3 times, in the reference's order. Under bf16 both nets run
in bf16 autocast; their outputs are widened to f32, D's sigmoid runs in f32
(models/be_font.py:Discriminator) and every loss outside autocast, which
refuses F.binary_cross_entropy. Parameters, Adam state, BatchNorm buffers
and losses stay f32.
"""

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from vaeplay_torch.models.be_font import NUM_CLASSES
from vaeplay_torch.ops import losses as L
from vaeplay_torch.train.state import FontState
from vaeplay_torch.utils.amp import autocast

D_KEYS = ("d_adv_real", "d_aux_real", "d_adv_fake")
G_KEYS = ("loss_edge", "loss_mask", "loss_g_adv", "loss_g_aux", "g_aux_ce")
S_KEYS = ("loss_embed",)
# the JAX CLI's AVG_KEYS (cli/train_be_font.py:31-32), then the logged aux CE
AVG_KEYS = ("loss_edge", "loss_mask", "d_adv_real", "d_aux_real", "d_adv_fake", "loss_g_adv",
            "loss_g_aux", "loss_embed")
METRIC_KEYS = AVG_KEYS + ("g_aux_ce",)
Preds = Dict[str, torch.Tensor]


def conditioning(labels: torch.Tensor, styles: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(B,) class indices and (B, 5) style vectors -> the nets' `y`."""
    return {"cls": F.one_hot(labels.long(), NUM_CLASSES).to(styles.dtype), "cnt_style": styles}


def make_be_font_train_step(g: torch.nn.Module, d: torch.nn.Module,
                            compute_dtype: torch.dtype = torch.float32) -> Callable:
    """(font_state, imgs, masks, edges, labels, styles) -> (font_state,
    metrics), updating the FontState over g and d in place.

    imgs (B, 3, S, S), masks and edges (B, 1, S, S), labels (B,) and styles
    (B, 5), on the models' device. metrics: METRIC_KEYS as detached 0-d
    tensors. The phases are exposed as `.d_phase`, `.g_phase` and
    `.s_phase`, each (font_state, *batch) -> (font_state, its metrics)."""

    def widen(t: torch.Tensor) -> torch.Tensor:  # bf16 outputs -> f32 losses
        return t.float() if t.dtype == torch.bfloat16 else t

    def run_g(imgs, y) -> Preds:
        with autocast(imgs.device, compute_dtype):
            preds = g(imgs, y)
        return {k: widen(v) for k, v in preds.items()}

    def run_d(x, y):
        with autocast(x.device, compute_dtype):
            adv, aux = d(x, y)  # adv: f32 probabilities
        return adv, widen(aux)

    def d_phase(fs: FontState, imgs, masks, edges, labels, styles):
        y = conditioning(labels, styles)
        with torch.no_grad():
            preds = run_g(imgs, y)
        gt_adv, gt_aux = run_d(torch.cat([masks, edges], dim=1), y)
        pd_adv, _ = run_d(torch.cat([preds["masks"], preds["edges"]], dim=1), y)
        m = {"d_adv_real": L.bce(gt_adv, torch.ones_like(gt_adv)).mean(),
             "d_aux_real": L.softmax_cross_entropy(gt_aux, labels).mean(),
             "d_adv_fake": L.bce(pd_adv, torch.zeros_like(pd_adv)).mean()}
        fs.d.optimizer.zero_grad()
        ((m["d_adv_real"] + m["d_adv_fake"]) * 0.5 + m["d_aux_real"]).backward()
        fs.d.apply_gradients()
        return fs, {k: v.detach() for k, v in m.items()}

    def g_phase(fs: FontState, imgs, masks, edges, labels, styles):
        y = conditioning(labels, styles)
        preds = run_g(imgs, y)
        d_params = [p for p in d.parameters() if p.requires_grad]
        for p in d_params:
            p.requires_grad_(False)
        try:
            adv, aux = run_d(torch.cat([preds["masks"], preds["edges"]], dim=1), y)
            m = {"loss_mask": L.mask_edge_losses(preds["masks"], masks) * 10.0,
                 "loss_edge": L.mask_edge_losses(preds["edges"], edges) * 10.0,
                 "loss_g_adv": L.bce(adv, torch.ones_like(adv)).mean() * 2.0,
                 "g_aux_ce": L.softmax_cross_entropy(aux, labels).mean()}
            m["loss_g_aux"] = m["loss_g_adv"] * 5.0  # the reference's bug, kept (:142)
            fs.g.optimizer.zero_grad()
            (m["loss_edge"] + m["loss_mask"] + m["loss_g_adv"] + m["loss_g_aux"]).backward()
        finally:
            for p in d_params:
                p.requires_grad_(True)
        fs.g.apply_gradients()
        return fs, {k: v.detach() for k, v in m.items()}

    def s_phase(fs: FontState, imgs, masks, edges, labels, styles):
        with torch.no_grad():
            ref = run_g(imgs, conditioning(labels, styles))
        preds = run_g(imgs, None)
        pm, pe = preds["masks"], preds["edges"]
        m = {"loss_embed": ((pm - ref["masks"]).abs().mean()
                            + (pe - ref["edges"]).abs().mean()) * 2.0}
        total = L.mask_edge_losses(pm, masks) + L.mask_edge_losses(pe, edges) + m["loss_embed"]
        params = [p for group in fs.style.optimizer.param_groups for p in group["params"]]
        for p, grad in zip(params, torch.autograd.grad(total, params)):
            p.grad = grad
        fs.style.apply_gradients()  # the next G phase's zero_grad drops these .grad
        return fs, {k: v.detach() for k, v in m.items()}

    def train_step(fs: FontState, imgs, masks, edges, labels, styles):
        batch = (imgs, masks, edges, labels, styles)
        fs, dm = d_phase(fs, *batch)
        fs, gm = g_phase(fs, *batch)
        fs, sm = s_phase(fs, *batch)
        metrics = {**dm, **gm, **sm}
        return fs, {k: metrics[k] for k in METRIC_KEYS}

    train_step.d_phase = d_phase
    train_step.g_phase = g_phase
    train_step.s_phase = s_phase
    return train_step
