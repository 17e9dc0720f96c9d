"""Train state -- the port's counterpart of vaeplay_tpu/train/state.py for one
optimizer: the model, `torch.optim.Adam` (betas (0.9, 0.999), eps 1e-8, as
the JAX package's `torch_adam` gives optax.adam), its learning-rate schedule
and the count of optimizer steps, saved and restored together.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict

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
               schedule: Callable[[int], float] = lambda step: 1.0) -> "TrainState":
        optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
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
