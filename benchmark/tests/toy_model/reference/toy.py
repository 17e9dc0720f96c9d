"""Plain reference of the toy model, a two-layer perceptron: y = W2 relu(W1
x + b1) + b2 over a batch of Gaussian inputs, the mean squared error
against Gaussian targets, plain Adam. Batches are made here from the seed,
on the device, and handed to the program alike (`batch`)."""

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.common import (Adam, Ops, TrainRecord, grads_of, leaves, linear_spec,
                                        make_weights, nudged, run_train, swap_last_row)


def param_specs(cfg: dict):
    return (linear_spec("0.", cfg["hidden"], cfg["inputs"])
            + linear_spec("2.", cfg["outputs"], cfg["hidden"]))


def weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return make_weights(param_specs(cfg), seed % (2 ** 63), device)


def batch(cfg: dict, traffic: dict, seed: int, k: int, device):
    """Step k's (inputs, targets)."""
    gen = torch.Generator(device=device).manual_seed((seed + k + 1) % (2 ** 63))
    b = traffic["batch_size"]
    return (torch.randn((b, cfg["inputs"]), generator=gen, device=device),
            torch.randn((b, cfg["outputs"]), generator=gen, device=device))


def train(cfg: dict, traffic: dict, seed: int, device, precision: str = "f32", steps: int = 3,
          teacher: Optional[list] = None, fault: Optional[str] = None,
          against: Optional[dict] = None, keep_first_grads: bool = False,
          nudge: bool = False) -> TrainRecord:
    """`steps` steps from the seed's weights and batches; `teacher` is
    unused. Planted faults: "half_batch" trains on the first half of each
    batch, "row_swapped" replaces the last answer by the first."""
    ops = Ops(precision)
    w = weights(cfg, seed, device)
    P = leaves(nudged(w) if nudge else w)
    t = cfg["train"]
    opt = Adam(P, t["lr"], tuple(t["betas"]), t["eps"])

    def step(k, descend):
        x, y = batch(cfg, traffic, seed, k, device)
        if fault == "half_batch":
            x, y = x[: x.shape[0] // 2], y[: y.shape[0] // 2]
        with ops.context(device):
            h = F.relu(ops.linear(x, P["0.weight"], P["0.bias"]))
            out = ops.linear(h, P["2.weight"], P["2.bias"]).float()
        if fault == "row_swapped":
            out = swap_last_row(out)
        loss = F.mse_loss(out, y)
        descend(opt, grads_of(loss, P))
        return {"loss": loss.detach()}, None, {"y": out}

    return run_train(step, P, steps, ops, ("loss",), against, keep_first_grads)
