"""The BCP train step -- port of vaeplay_tpu/train/steps_bcp.py (reference
train_BCP.py:69-147): one G forward, then a D phase and a G phase.

The points (B, P, 6) are [sx, sy, dx, dy, freq, key], normalized, with a
validity mask pmask (B, P); G reads the ground-truth contours
points[..., :2] x pmask.

  forward  G once, with its graph kept. The reference runs the same G
           forward twice, under no_grad for the D phase and again for the G
           phase (train_BCP.py:71,96), with G's weights unchanged between;
           the JAX step linearizes G once (jax.vjp) and so does this one.
  D phase  BCE(D(real) -> 1) and BCE(D(fake) -> 0), their mean x 0.5, on
           real = points[..., :4] x VALUE_WEIGHT and fake = [contours x
           VALUE_WEIGHT, G's offsets, detached], both x pmask; D's Adam steps.
  G phase  class CE + 4 (trigger L1 on the triggered points + the
           non-triggered points' L1 over the triggered count) + 10 offset L1
           + 6 key-point offset L1 + BCE(D(fake) -> 1) against the updated D;
           one backward into G's parameters (torch.autograd.grad), so D's
           .grad keeps the D phase's gradients and no weight gradient of D
           is computed; G's Adam steps.

Under bf16 both nets' forward and backward run in bf16 autocast; the
outputs are widened to f32 first, D's sigmoid runs in f32
(models/bcp.py:Discriminator) and every BCE outside autocast, which refuses
F.binary_cross_entropy. Parameters, Adam state and losses stay f32.
"""

from typing import Callable, Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from vaeplay_torch.models.bcp import VALUE_WEIGHT
from vaeplay_torch.ops import losses as L
from vaeplay_torch.parallel.mesh import data_sum, sync_grads
from vaeplay_torch.train.state import GanState
from vaeplay_torch.utils.amp import autocast

D_KEYS = ("d_adv_real", "d_adv_fake")
G_KEYS = ("loss_class", "loss_frequency_one", "loss_frequency_zero", "loss_total_regress",
          "loss_key_regress", "g_adv_loss")
# the JAX CLI's AVG_KEYS (cli/train_bcp.py:29-31)
METRIC_KEYS = ("loss_class", "loss_frequency_one", "loss_frequency_zero", "loss_total_regress",
               "loss_key_regress", "d_adv_real", "d_adv_fake", "g_adv_loss")
Preds = Dict[str, torch.Tensor]


def _fake_targets(preds: Preds, pmask: torch.Tensor) -> torch.Tensor:
    return torch.cat([preds["contours"] * VALUE_WEIGHT, preds["target_pts"]],
                     dim=-1) * pmask[..., None]


def line_losses(preds: Preds, labels: torch.Tensor, points: torch.Tensor,
                pmask: torch.Tensor, mesh: Optional[DeviceMesh] = None
                ) -> Dict[str, torch.Tensor]:
    """The G phase's losses but the adversarial one (JAX steps_bcp.py:94-113).
    The masked means divide batch-wide sums by batch-wide counts: with a
    mesh, both are summed over the "data" ranks (data_sum), since the ranks'
    point counts differ; the class loss is a mean of equal slices."""
    dt = preds["target_frequency"].dtype
    valid = pmask > 0
    trig = (points[..., 4] > 0.1) & valid
    untrig = (points[..., 4] <= 0.1) & valid
    freq = preds["target_frequency"]
    diff = (preds["target_pts"] - points[..., 2:4] * VALUE_WEIGHT).abs()
    key = (points[..., 5] > 0.9) & valid

    def total(t):
        return data_sum(t.sum(), mesh)

    def count(mask):
        return total(mask.to(dt)).clamp(min=1)

    zero = torch.zeros((), dtype=dt, device=freq.device)
    return {"loss_class": L.softmax_cross_entropy(preds["classes"], labels).mean(),
            "loss_frequency_one": total((freq - 1.0).abs() * trig) / count(trig),
            "loss_frequency_zero": torch.where(
                total(untrig.to(dt)) > 0, total(freq.abs() * untrig.to(dt)) / count(trig), zero),
            "loss_total_regress": total(diff * pmask[..., None])
            / count(pmask[..., None].expand(diff.shape)),
            "loss_key_regress": total(diff.sum(dim=-1) * key.to(dt)) / count(key)}


def make_bcp_train_step(g: torch.nn.Module, d: torch.nn.Module,
                        compute_dtype: torch.dtype = torch.float32,
                        mesh: Optional[DeviceMesh] = None) -> Callable:
    """(gan_state, imgs, labels, points, pmask) -> (gan_state, metrics),
    updating the GanState over g and d in place.

    imgs (B, 3, H, W) [img, bmask, emask], labels (B,), points (B, P, 6) and
    pmask (B, P), on the models' device. metrics: METRIC_KEYS as detached
    0-d tensors. The parts are exposed as `.forward` (*batch -> G's outputs,
    f32, with their graph), `.d_phase` and `.g_phase` ((gan_state, preds,
    *batch) -> (gan_state, their metrics)).

    With a mesh, the batch is this rank's rows (shard_batch), the line
    losses are line_losses' global ones, and each phase averages its net's
    gradients over the ranks (sync_grads) before its update; a G built with
    an active `ring` runs its point attention over the "model" ranks."""

    def widen(t: torch.Tensor) -> torch.Tensor:  # bf16 outputs -> f32 losses
        return t.float() if t.dtype == torch.bfloat16 else t

    def forward(imgs, labels, points, pmask) -> Preds:
        counts = pmask.sum(dim=1).to(torch.int32)
        with autocast(imgs.device, compute_dtype):
            preds = g(imgs, points[..., :2] * pmask[..., None], counts)
        return {k: widen(v) for k, v in preds.items()}

    def run_d(imgs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        with autocast(imgs.device, compute_dtype):
            return d(imgs, targets)  # f32 probabilities

    def d_phase(gs: GanState, preds: Preds, imgs, labels, points, pmask):
        real = run_d(imgs, points[..., :4] * VALUE_WEIGHT * pmask[..., None])
        fake = run_d(imgs, _fake_targets(preds, pmask).detach())
        m = {"d_adv_real": L.bce(real, torch.ones_like(real)).mean(),
             "d_adv_fake": L.bce(fake, torch.zeros_like(fake)).mean()}
        gs.d.optimizer.zero_grad()
        ((m["d_adv_real"] + m["d_adv_fake"]) * 0.5).backward()
        sync_grads(d.parameters(), mesh)
        gs.d.apply_gradients()
        return gs, {k: v.detach() for k, v in m.items()}

    def g_phase(gs: GanState, preds: Preds, imgs, labels, points, pmask):
        m = line_losses(preds, labels, points, pmask, mesh)
        adv = run_d(imgs, _fake_targets(preds, pmask))
        m["g_adv_loss"] = L.bce(adv, torch.ones_like(adv)).mean()
        total = (m["loss_class"] + (m["loss_frequency_one"] + m["loss_frequency_zero"]) * 4.0
                 + m["loss_total_regress"] * 10.0 + m["loss_key_regress"] * 6.0
                 + m["g_adv_loss"])
        params = [p for group in gs.g.optimizer.param_groups for p in group["params"]]
        for p, grad in zip(params, torch.autograd.grad(total, params)):
            p.grad = grad
        sync_grads(params, mesh)
        gs.g.apply_gradients()
        return gs, {k: v.detach() for k, v in m.items()}

    def train_step(gs: GanState, imgs, labels, points, pmask):
        preds = forward(imgs, labels, points, pmask)
        gs, dm = d_phase(gs, preds, imgs, labels, points, pmask)
        gs, gm = g_phase(gs, preds, imgs, labels, points, pmask)
        metrics = {**dm, **gm}
        return gs, {k: metrics[k] for k in METRIC_KEYS}

    train_step.forward = forward
    train_step.d_phase = d_phase
    train_step.g_phase = g_phase
    return train_step
