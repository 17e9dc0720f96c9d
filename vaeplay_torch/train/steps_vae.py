"""The circle VAE-GAN train step -- port of vaeplay_tpu/train/steps_vae.py.

The reference runs, per batch, one forward, five `backward(retain_graph=True)`
and four RMSprop steps (train.py:43-78). Its .grad accumulates across the
five backwards and each optimizer reads a disjoint subset, so here one
backward of the sum of the five losses, then the four RMSprop steps of a
GroupedTrainState, make the same update. Loss composition (train.py:54-66):

  loss_recon         = mean((x - x_tilde)^2)
  loss_encoder       = sum(kl) + sum(mse_layer)
  loss_discriminator = sum(bce_orig) + sum(bce_pred) + sum(bce_sampled)
  loss_decoder       = sum(lambda * mse_layer) - (1 - lambda) * loss_discriminator
  loss_aux           = sum(smooth_l1(params, targets)) / B        (lambda = 1e-6)
"""

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import checkpoint

from vaeplay_torch.models.vae_gan import VaeGan
from vaeplay_torch.ops import losses as L
from vaeplay_torch.ops.geometry import encode_circle_param, render_circle_batch
from vaeplay_torch.parallel.mesh import axis_size, data_sum, shard_batch, sync_grads
from vaeplay_torch.train.state import GroupedTrainState, running_stats_untouched
from vaeplay_torch.utils.amp import autocast

LAMBDA_MSE = 1e-6  # train.py:15
GROUPS = ("encoder", "decoder", "discriminator", "param_encoder")  # train.py:136-146
METRIC_KEYS = ("loss_recon", "loss_encoder", "loss_decoder", "loss_discriminator",
               "loss_aux", "kl", "nle")


def vae_gan_losses(outs: Sequence[torch.Tensor], imgs: torch.Tensor, targets: torch.Tensor,
                   mesh: Optional[DeviceMesh] = None) -> Dict[str, torch.Tensor]:
    """The five losses and two diagnostics from VaeGan's training outputs.
    With a mesh, this rank's rows are a slice of the global batch: the sums
    run over the global batch (data_sum), the means are of the slice (equal
    slices, so their mean over the ranks is the global mean)."""
    x_tilde, disc_class, disc_layer, mus, log_variances, params = outs
    b = imgs.shape[0]
    dc = disc_class[:, 0]
    pieces = L.vaegan_losses(imgs, x_tilde, disc_layer[:b], disc_layer[b:2 * b],
                             dc[:b], dc[b:2 * b], dc[2 * b:], mus, log_variances, targets, params)
    loss_discriminator = data_sum(pieces["bce_dis_original"].sum() + pieces["bce_dis_predicted"].sum()
                                  + pieces["bce_dis_sampled"].sum(), mesh)
    return {
        "loss_recon": ((imgs - x_tilde) ** 2).mean(),
        "loss_encoder": data_sum(pieces["kl"].sum() + pieces["mse"].sum(), mesh),
        "loss_decoder": data_sum((LAMBDA_MSE * pieces["mse"]).sum(), mesh)
        - (1.0 - LAMBDA_MSE) * loss_discriminator,
        "loss_discriminator": loss_discriminator,
        "loss_aux": pieces["l1_param"],
        "kl": data_sum(pieces["kl"].sum(), mesh),
        "nle": pieces["nle"].mean(),
    }


def make_train_step(model: VaeGan, compute_dtype: torch.dtype = torch.float32,
                    remat: bool = False, mesh: Optional[DeviceMesh] = None) -> Callable:
    """(state, imgs, targets, generator) -> (state, metrics), updating state
    (a GroupedTrainState over `model`) in place.

    imgs: (B, C, n, n) on the model's device; targets: (B, 3) encoded [log
    r/n, x, y]; generator: a torch.Generator on that device, from which the
    step draws the forward's noise (eps, z_p). metrics: METRIC_KEYS as
    detached f32 0-d tensors on the device.

    compute_dtype bfloat16 runs the forward and backward under bf16 autocast
    (utils/amp.py). remat=True checkpoints the whole training forward, so
    the backward recomputes the activations instead of keeping them;
    parameters and running statistics after the step are the plain step's.

    With a mesh, imgs and targets are this rank's rows of the global batch
    (shard_batch): the noise is drawn for the global batch from `generator`
    and sliced alike, the losses are vae_gan_losses' global ones, and the
    gradients are averaged over the ranks (sync_grads) before the update;
    the model's BatchNorms take global statistics once global_batchnorm has
    converted them."""

    def forward(imgs: torch.Tensor, eps: torch.Tensor, z_p: torch.Tensor):
        with autocast(imgs.device, compute_dtype):
            return model(imgs, noise=(eps, z_p))

    def train_step(state: GroupedTrainState, imgs: torch.Tensor, targets: torch.Tensor,
                   generator: torch.Generator) -> Tuple[GroupedTrainState, Dict[str, torch.Tensor]]:
        noise = shard_batch(mesh, model.draw_noise(imgs.shape[0] * axis_size(mesh, "data"),
                                                   generator, imgs.device))
        if remat:
            outs = checkpoint(forward, imgs, *noise, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(),
                                                  running_stats_untouched(model)))
        else:
            outs = forward(imgs, *noise)
        if compute_dtype == torch.bfloat16:  # losses and their reductions in f32
            outs = [o.float() for o in outs]
        m = vae_gan_losses(outs, imgs, targets, mesh)
        total = (m["loss_recon"] + m["loss_encoder"] + m["loss_decoder"]
                 + m["loss_discriminator"] + m["loss_aux"])
        state.zero_grad()
        total.backward()
        sync_grads(state.model.parameters(), mesh)
        state.apply_gradients()
        return state, {k: v.detach() for k, v in m.items()}

    return train_step


def circle_batch(img_size: int, raw_params: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 3) raw [radius, cx, cy] on a device -> the (B, 1, n, n) rendered
    circles and (B, 3) encoded targets, computed there."""
    r, cx, cy = raw_params.unbind(dim=1)
    enc = encode_circle_param(img_size, r, cx, cy)
    targets = torch.stack([enc["radius"], enc["x"], enc["y"]], dim=-1)
    return render_circle_batch(img_size, r, cx, cy), targets


def make_circle_train_step(model: VaeGan, img_size: int,
                           compute_dtype: torch.dtype = torch.float32,
                           remat: bool = False, mesh: Optional[DeviceMesh] = None) -> Callable:
    """(state, raw_params, generator) -> (state, metrics): renders the batch
    and encodes the targets on the device from the (B, 3) circle params,
    then make_train_step's step; no image crosses the host->device link (the
    reference renders every circle on the CPU, datasets/dataset.py:52-56)."""
    step = make_train_step(model, compute_dtype, remat, mesh)

    def fused(state: GroupedTrainState, raw_params: torch.Tensor, generator: torch.Generator):
        return step(state, *circle_batch(img_size, raw_params), generator)

    return fused


def make_eval_step(model: VaeGan) -> Callable:
    """(imgs, generator) -> (x_tilde, params): model.reconstruct in eval mode
    (running statistics), f32, without gradients; the model's train/eval
    mode is restored after."""

    @torch.no_grad()
    def eval_step(imgs: torch.Tensor, generator: torch.Generator):
        was_training = model.training
        model.eval()
        try:
            return model.reconstruct(imgs, generator)
        finally:
            model.train(was_training)

    return eval_step
