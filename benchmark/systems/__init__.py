"""The system under test, one module per model: how a cell builds and drives
`vaeplay_torch`'s own entry points, and what it reads back from them.

A training module offers `Trainer(cfg, traffic, seed, device, weights)` with
next_batch (the feed's next batch, on the host where the feed makes it
there), to_device, step, fetch, reset_losses, params, capture, warm_up and
close;
an inference module `Server(cfg, traffic, seed, device, weights)`, called on
a batch of inputs, with teacher and close. The weights are the benchmark's
(reference.<model>.weights), loaded into the port's modules, which are built
on the meta device so that no init of the port's runs.
"""

import dataclasses
from typing import Dict, List

import torch


@dataclasses.dataclass
class Captured:
    """What a Trainer's `capture()` reads from the program during the
    compared steps: every leaf's gradient as its optimizer got it first (on
    the host), the first step's model outputs (on the host, f32), and per
    step the answer a reference continues from."""

    first_grads: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    first_outputs: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    answers: List[torch.Tensor] = dataclasses.field(default_factory=list)


def first_step_hook(captured: Captured, names: Dict[torch.nn.Parameter, str]):
    """An optimizer step pre-hook that copies the gradients its optimizer is
    about to apply, the first time it runs, under the names given."""
    done = []

    def hook(optimizer, args, kwargs):
        if done:
            return
        done.append(True)
        for group in optimizer.param_groups:
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                captured.first_grads[names[p]] = g.detach().to("cpu", copy=True)

    return hook


def host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32, copy=True)
