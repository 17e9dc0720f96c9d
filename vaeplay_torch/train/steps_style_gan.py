"""The Style_GAN train step -- port of vaeplay_tpu/train/steps_style_gan.py
(reference train_Style_GAN.py:162-281, the `train_random_gan` path): three
optimizers, Adam 1e-4 each.

  E/G phase  x_gen = G(x_content, z_sample, labels) runs once with its graph,
             and a detached copy of it, xg, is a leaf. With D's parameters
             frozen: total = KL + rec_d + pixel + gen_d, where z_enc = eps
             exp(logvar / 2) + mu, x_rec = G(x_content, z_enc, labels), KL
             is a sum over the batch and z, each `_d` term is mean(BCE(valid
             -> 1)) + mean(CE(type, labels)) of D on x_rec (rec_d) or xg
             (gen_d), and pixel the mean L1 of x_rec to x_target. Its
             backward fills E's and G's .grad and xg.grad (gen_cot); E's
             Adam steps.
  latent+G   With the UPDATED E: lat = 0.5 mean|E(xg2).mu - z_sample| on a
             fresh detached xg2, and lat_cot = d lat / d xg2 by
             torch.autograd.grad (nothing reaches E's .grad). Then
             x_gen.backward(gen_cot + lat_cot) adds the x_gen branch's
             gradient to G's .grad, and G's Adam steps.
  D phase    d_real = BCE(D(x_target) -> 1) + CE, d_fake = BCE(D(x_rec) -> 0)
             + CE on the pre-update G's x_rec, detached; (d_real + d_fake) / 2;
             D's Adam steps.

The JAX step linearises the x_gen branch once and pulls back the sum of its
two cotangents; here the branch's graph is kept from the E/G phase to its
one backward, so G runs forward twice a step (x_gen and x_rec), with no
retain_graph: E's weights change in place between its two uses, and
autograd's version counters would refuse a second backward through E's
first graph.

Gradients are cleared to zeros, never to None: a parameter with no gradient
this step (a gated branch that a split leaves out) still takes Adam's step
on its decayed moments, as optax's does, and every Adam counts the same
steps. Under bf16 the three nets run in bf16 autocast; their outputs are
widened to f32, D's sigmoid and softmax run in f32 (models/style_gan.py)
and the KL, the L1s, every BCE and CE outside autocast, which refuses
F.binary_cross_entropy. Parameters, Adam state and losses stay f32.

Host spans (utils/profiling.py): each phase's forward is a `train.forward`,
its backward a `train.backward` (the latent+G phase's autograd.grad and
backward together).
"""

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from vaeplay_torch.ops import losses as L
from vaeplay_torch.train.state import StyleGanState
from vaeplay_torch.utils.amp import autocast
from vaeplay_torch.utils.profiling import span

# the JAX CLI's AVG_KEYS (cli/train_style_gan.py:28-29)
AVG_KEYS = ("g_rec_kl_loss", "g_rec_d_loss", "g_rec_pixel_loss", "g_gen_d_loss", "loss_latent",
            "d_real_loss", "d_fake_loss")
Split = Optional[Tuple[int, int]]
Metrics = Dict[str, torch.Tensor]


def clear_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Every .grad a zero tensor: zeroed in place, or made where it is None."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.zero_()


def _widen(t: torch.Tensor) -> torch.Tensor:  # bf16 outputs -> f32 losses
    return t.float() if t.dtype == torch.bfloat16 else t


def make_style_gan_train_step(e: torch.nn.Module, g: torch.nn.Module, d: torch.nn.Module,
                              z_dim: int, compute_dtype: torch.dtype = torch.float32,
                              generator: Optional[torch.Generator] = None) -> Callable:
    """(style_gan_state, x_target, x_content, labels, split=None) ->
    (style_gan_state, metrics), updating the StyleGanState over e, g and d
    in place; eps and z_sample, each (B, z_dim), are drawn from `generator`
    (on the models' device) or torch's default one.

    x_target and x_content (B, 3, S, S) and labels (B,) int on the models'
    device; split=(k0p, k1p) runs G's gated convs label-bucketed on a batch
    sorted label-0 first (sort_batch_by_label). metrics: AVG_KEYS as
    detached 0-d tensors. `.recorded(ss, x_target, x_content, labels, eps,
    z_sample, split=None)` takes the two noise draws instead. The parts are
    `.eg_phase(ss, x_target, x_content, labels, eps, z_sample, split) ->
    (ss, branch, metrics)`, `.latent_g_phase(ss, branch, z_sample) -> (ss,
    metrics)` and `.d_phase(ss, x_target, x_content, labels, x_rec) -> (ss,
    metrics)`, where branch = (x_gen, gen_cot, x_rec)."""

    def run_e(x):
        with autocast(x.device, compute_dtype):
            mu, logvar = e(x)
        return _widen(mu), _widen(logvar)

    def run_g(x_content, z, labels, split):
        with autocast(x_content.device, compute_dtype):
            out = g(x_content, z, labels, split)
        return _widen(out)

    def run_d(x, x_content):
        with autocast(x.device, compute_dtype):
            return d(x, x_content)  # f32 probabilities

    def d_terms(valid, typ, labels, target: float):
        return (L.bce(valid, torch.full_like(valid, target)).mean()
                + L.softmax_cross_entropy(typ, labels).mean())

    def eg_phase(ss: StyleGanState, x_target, x_content, labels, eps, z_sample, split=None):
        d_params = [p for p in d.parameters() if p.requires_grad]
        try:
            with span("train.forward"):
                x_gen = run_g(x_content, z_sample, labels, split)
                xg = x_gen.detach().requires_grad_()
                for p in d_params:
                    p.requires_grad_(False)
                mu, logvar = run_e(x_target)
                x_rec = run_g(x_content, eps * torch.exp(logvar / 2.0) + mu, labels, split)
                m = {"g_rec_kl_loss": 0.5 * torch.sum(torch.exp(logvar) + mu ** 2 - logvar - 1.0),
                     "g_rec_d_loss": d_terms(*run_d(x_rec, x_content), labels, 1.0),
                     "g_rec_pixel_loss": (x_rec - x_target).abs().mean(),
                     "g_gen_d_loss": d_terms(*run_d(xg, x_content), labels, 1.0)}
            clear_grads(ss.e.optimizer.param_groups[0]["params"])
            clear_grads(ss.g.optimizer.param_groups[0]["params"])
            with span("train.backward"):
                sum(m.values()).backward()
        finally:
            for p in d_params:
                p.requires_grad_(True)
        ss.e.apply_gradients()
        return ss, (x_gen, xg.grad, x_rec.detach()), {k: v.detach() for k, v in m.items()}

    def latent_g_phase(ss: StyleGanState, branch, z_sample):
        x_gen, gen_cot, _ = branch
        with span("train.forward"):
            xg2 = x_gen.detach().requires_grad_()
            lat = (run_e(xg2)[0] - z_sample).abs().mean() * 0.5
        with span("train.backward"):
            (lat_cot,) = torch.autograd.grad(lat, xg2)
            x_gen.backward(gen_cot + lat_cot)
        ss.g.apply_gradients()
        return ss, {"loss_latent": lat.detach()}

    def d_phase(ss: StyleGanState, x_target, x_content, labels, x_rec):
        clear_grads(ss.d.optimizer.param_groups[0]["params"])
        with span("train.forward"):
            m = {"d_real_loss": d_terms(*run_d(x_target, x_content), labels, 1.0),
                 "d_fake_loss": d_terms(*run_d(x_rec, x_content), labels, 0.0)}
        with span("train.backward"):
            ((m["d_real_loss"] + m["d_fake_loss"]) * 0.5).backward()
        ss.d.apply_gradients()
        return ss, {k: v.detach() for k, v in m.items()}

    def recorded(ss: StyleGanState, x_target, x_content, labels, eps, z_sample,
                 split: Split = None) -> Tuple[StyleGanState, Metrics]:
        ss, branch, m = eg_phase(ss, x_target, x_content, labels, eps, z_sample, split)
        ss, lm = latent_g_phase(ss, branch, z_sample)
        ss, dm = d_phase(ss, x_target, x_content, labels, branch[2])
        metrics = {**m, **lm, **dm}
        return ss, {k: metrics[k] for k in AVG_KEYS}

    def train_step(ss: StyleGanState, x_target, x_content, labels,
                   split: Split = None) -> Tuple[StyleGanState, Metrics]:
        shape, dev = (x_target.shape[0], z_dim), x_target.device
        eps = torch.randn(shape, generator=generator, device=dev)
        z_sample = torch.randn(shape, generator=generator, device=dev)
        return recorded(ss, x_target, x_content, labels, eps, z_sample, split)

    train_step.recorded = recorded
    train_step.eg_phase = eg_phase
    train_step.latent_g_phase = latent_g_phase
    train_step.d_phase = d_phase
    return train_step


def sort_batch_by_label(labels, *arrays: Sequence, pad: int = 8):
    """Host-side prep for label-bucketed training, the JAX package's own
    (steps_style_gan.py:157-173): stable-sort the batch rows label-0 first
    and return (sorted arrays, sorted labels, (k0p, k1p)), each branch's
    capacity rounded up to a multiple of `pad` and capped at B. The step's
    losses are all batch means or sums, so one permutation of every
    per-sample array leaves the training math unchanged."""
    labels = np.asarray(labels)
    order = np.argsort(labels, kind="stable")
    b = labels.shape[0]
    k0 = int(np.count_nonzero(labels == 0))
    k0p = min(b, -(-k0 // pad) * pad)
    k1p = min(b, -(-(b - k0) // pad) * pad)
    return [np.asarray(a)[order] for a in arrays], labels[order], (k0p, k1p)
