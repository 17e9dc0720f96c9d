"""Train state -- the port's counterpart of vaeplay_tpu/train/state.py.

  TrainState         one optimizer (BP, BE, BC): the model, `torch.optim.Adam`
                     (betas (0.9, 0.999) unless given, eps 1e-8, as the JAX
                     package's `torch_adam` gives optax.adam) over the
                     parameters that require a gradient, its learning-rate
                     schedule and the count of optimizer steps.
  frozen_backbone_adam  BE's and BC's state: the JAX package's `frozen_backbone_adam`
                     and `stop_frozen_gradients` (state.py:96-139) as one
                     rule, torchvision's trainable_layers=3: every backbone's
                     body.conv1 and body.layer1 stop requiring a gradient, so
                     Adam skips them and no backward runs through them (XLA
                     dead-codes that backward in the JAX package).
  GanState           a GAN's generator and discriminator, a TrainState each
                     (the JAX package's steps_be_gan.GanState): BE_GAN's and
                     BCP's.
  FontState          BE_font's three optimizers (the JAX package's
                     steps_be_font.FontState): `g` over all of the
                     generator, `style` over its style encoder only (the
                     same tensors, a second Adam), `d` over the
                     discriminator.
  StyleGanState      Style_GAN's three optimizers (the JAX package's
                     steps_style_gan.StyleGanState): `e` over the encoder,
                     `g` over the generator, `d` over the discriminator.
  GroupedTrainState  one optimizer per top-level submodule (the VAE-GAN's
                     four RMSprops), the JAX package's `grouped_transform`.
                     The reference's retained backwards accumulate into
                     .grad and each optimizer reads its own disjoint subset,
                     so one backward of the summed losses, then every
                     optimizer's step, is the same update.

Each is saved and restored whole.
"""

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Mapping, Tuple

import torch
from torch import nn
from torch.optim.lr_scheduler import LambdaLR


def step_lr_every_two_epochs(iterations: int) -> Callable[[int], float]:
    """The BP trainer's schedule as a LambdaLR factor of the optimizer step
    count: StepLR(2, 0.1) per epoch with two optimizer steps per iteration
    (vaeplay_tpu/cli/train_bp.py:66-72). LambdaLR, like optax, gives the
    update numbered k (from 0) the factor at k."""
    steps_per_epoch = 2 * iterations

    def factor(step: int) -> float:
        return 0.1 ** ((step // steps_per_epoch) // 2)

    return factor


def step_lr_by_epoch(iterations: int) -> Callable[[int], float]:
    """BC's schedule, StepLR(10, 0.5) counted in epochs of `iterations`
    optimizer steps (vaeplay_tpu/cli/train_bc.py:114-116), as a LambdaLR
    factor of the step count."""

    def factor(step: int) -> float:
        return 0.5 ** ((step // iterations) // 10)

    return factor


def torch_rmsprop(lr: float) -> Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]:
    """A factory of torch.optim.RMSprop(lr, alpha=0.99, eps=1e-8), the JAX
    package's `torch_rmsprop` (optax rmsprop with eps outside the square
    root): sq = alpha * sq + (1 - alpha) * g^2, p -= lr * g / (sqrt(sq) + eps)."""
    return lambda params: torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8)


@dataclass
class TrainState:
    """Model, optimizer and scheduler, and `step`, the optimizer steps taken.
    The optimizer and scheduler update the model's parameters in place."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: LambdaLR
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, lr: float,
               schedule: Callable[[int], float] = lambda step: 1.0,
               betas: Tuple[float, float] = (0.9, 0.999)) -> "TrainState":
        trainable = [p for p in model.parameters() if p.requires_grad]
        optimizer = torch.optim.Adam(trainable, lr=lr, betas=betas, eps=1e-8)
        return cls(model, optimizer, LambdaLR(optimizer, schedule))

    def apply_gradients(self) -> None:
        """One optimizer step on the gradients in the parameters' .grad, then
        the schedule's."""
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "step": self.step}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Strict: raises when the saved model's keys or shapes differ."""
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])
        self.step = int(sd["step"])


FROZEN_BACKBONE_MODULES = ("conv1", "layer1")  # under a backbone's `body`


def is_frozen_backbone_param(name: str) -> bool:
    """torchvision's trainable_layers=3 rule on a parameter name: the stem
    conv and layer1 of a ResNet body (`...body.conv1.weight`,
    `...body.layer1.*`) are frozen."""
    parts = name.split(".")
    return any(parts[i] == "body" and parts[i + 1] in FROZEN_BACKBONE_MODULES
               for i in range(len(parts) - 1))


def freeze_backbone_stem(model: nn.Module) -> List[str]:
    """Turn off requires_grad on the frozen backbone parameters; returns
    their names."""
    names = [n for n, _ in model.named_parameters() if is_frozen_backbone_param(n)]
    for n in names:
        model.get_parameter(n).requires_grad_(False)
    return names


def frozen_backbone_adam(model: nn.Module, lr: float,
                         betas: Tuple[float, float] = (0.9, 0.999),
                         schedule: Callable[[int], float] = lambda step: 1.0) -> TrainState:
    """A TrainState whose Adam (lr times `schedule`'s factor, `betas`) trains
    everything but the frozen backbone stem and layer1
    (freeze_backbone_stem); raises when the model has no such parameters."""
    if not freeze_backbone_stem(model):
        raise ValueError("the model has no backbone body.conv1/body.layer1 parameters to freeze")
    return TrainState.create(model, lr, schedule, betas)


@dataclass
class GanState:
    """A GAN's two train states: `g` the generator's (BE_GAN's
    frozen_backbone_adam, BCP's plain Adam), `d` the discriminator's. Saved and restored whole: both models, both
    optimizers and both step counts."""

    g: TrainState
    d: TrainState

    def state_dict(self) -> Dict[str, Any]:
        return {"g": self.g.state_dict(), "d": self.d.state_dict()}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Strict, as TrainState.load_state_dict."""
        self.g.load_state_dict(sd["g"])
        self.d.load_state_dict(sd["d"])


@dataclass
class FontState:
    """BE_font's train states: `g` (Adam over every generator parameter),
    `style` (a second Adam, over g.model.style_encoder's parameters only;
    its model is that submodule) and `d`. Saved and restored whole, under
    the keys g, style and d."""

    g: TrainState
    style: TrainState
    d: TrainState

    @classmethod
    def create(cls, g: nn.Module, d: nn.Module, lr: float) -> "FontState":
        """Three Adam(lr, (0.9, 0.999), eps 1e-8); g must have a
        `style_encoder` submodule."""
        return cls(TrainState.create(g, lr), TrainState.create(g.style_encoder, lr),
                   TrainState.create(d, lr))

    def state_dict(self) -> Dict[str, Any]:
        return {"g": self.g.state_dict(), "style": self.style.state_dict(),
                "d": self.d.state_dict()}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Strict, as TrainState.load_state_dict."""
        self.g.load_state_dict(sd["g"])
        self.style.load_state_dict(sd["style"])
        self.d.load_state_dict(sd["d"])


@dataclass
class StyleGanState:
    """Style_GAN's train states `e`, `g` and `d`, each with Adam(lr, (0.9,
    0.999), eps 1e-8). Saved and restored whole, under the keys e, g and d."""

    e: TrainState
    g: TrainState
    d: TrainState

    @classmethod
    def create(cls, e: nn.Module, g: nn.Module, d: nn.Module, lr: float) -> "StyleGanState":
        return cls(TrainState.create(e, lr), TrainState.create(g, lr), TrainState.create(d, lr))

    def state_dict(self) -> Dict[str, Any]:
        return {"e": self.e.state_dict(), "g": self.g.state_dict(), "d": self.d.state_dict()}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Strict, as TrainState.load_state_dict."""
        self.e.load_state_dict(sd["e"])
        self.g.load_state_dict(sd["g"])
        self.d.load_state_dict(sd["d"])


@dataclass
class GroupedTrainState:
    """The model, one optimizer per top-level submodule that holds parameters
    (by its attribute name), and `step`, the steps taken (one step of every
    optimizer counts once). The optimizers update the model in place."""

    model: nn.Module
    optimizers: Dict[str, torch.optim.Optimizer]
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module,
               group_optimizers: Mapping[str, Callable[[Iterable[nn.Parameter]],
                                                       torch.optim.Optimizer]]
               ) -> "GroupedTrainState":
        """group_optimizers maps each submodule's name to an optimizer factory
        (such as torch_rmsprop(lr)); raises when a parameter has no group."""
        groups = {name for name, child in model.named_children()
                  if next(child.parameters(), None) is not None}
        if groups != set(group_optimizers) or next(model.parameters(recurse=False), None) is not None:
            raise ValueError(f"optimizer groups {sorted(group_optimizers)} do not cover the "
                             f"model's parameter groups {sorted(groups)} exactly")
        return cls(model, {name: make(getattr(model, name).parameters())
                           for name, make in group_optimizers.items()})

    def zero_grad(self) -> None:
        for opt in self.optimizers.values():
            opt.zero_grad()

    def apply_gradients(self) -> None:
        """One step of every optimizer on the gradients in .grad."""
        for opt in self.optimizers.values():
            opt.step()
        self.step += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(),
                "optimizers": {k: o.state_dict() for k, o in self.optimizers.items()},
                "step": self.step}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Strict: raises when the saved model's keys or shapes, or its
        optimizer groups, differ."""
        if set(sd["optimizers"]) != set(self.optimizers):
            raise ValueError(f"saved optimizer groups {sorted(sd['optimizers'])}, "
                             f"not {sorted(self.optimizers)}")
        self.model.load_state_dict(sd["model"])
        for k, opt in self.optimizers.items():
            opt.load_state_dict(sd["optimizers"][k])
        self.step = int(sd["step"])


@contextlib.contextmanager
def running_stats_untouched(model: nn.Module):
    """Inside, every BatchNorm updates copies of its running buffers, which
    are dropped after: a train-mode forward whose statistics updates are
    discarded. torch.utils.checkpoint reruns the forward in the backward,
    which would update them a second time (jax.checkpoint is functional and
    updates nothing then; the copies keep the recompute saving the same
    tensors as the forward, which checkpoint checks), and BC's mask step
    discards them as the JAX mask step does."""
    names = ("running_mean", "running_var", "num_batches_tracked")
    norms = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    kept = [[getattr(m, n) for n in names] for m in norms]
    for m in norms:
        for n in names:
            setattr(m, n, getattr(m, n).clone())
    try:
        yield
    finally:
        for m, buffers in zip(norms, kept):
            for n, t in zip(names, buffers):
                setattr(m, n, t)
