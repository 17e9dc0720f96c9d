"""The toy model as a program would train it: a torch.nn perceptron and
torch's Adam, on the reference's batches."""

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.toy import batch
from benchmark.systems import Captured, first_step_hook, host


class Perceptron(torch.nn.Sequential):
    def __init__(self, inputs: int, hidden: int, outputs: int):
        super().__init__(torch.nn.Linear(inputs, hidden), torch.nn.ReLU(),
                         torch.nn.Linear(hidden, outputs))


def loss_of(model: Perceptron, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.mse_loss(model(x), y)


class Trainer:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, weights):
        with torch.device("meta"):
            model = Perceptron(cfg["inputs"], cfg["hidden"], cfg["outputs"])
        self.model = model.to_empty(device=device)
        self.model.load_state_dict(weights)
        t = cfg["train"]
        self.optimizer = torch.optim.Adam(self.model.parameters(), t["lr"],
                                          tuple(t["betas"]), t["eps"])
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.acc, self.cnt, self.steps = None, 0, 0

    def next_batch(self):
        return batch(self.cfg, self.traffic, self.seed, self.steps, self.device)

    def to_device(self, batch):
        return batch

    def step(self, batch) -> None:
        loss = loss_of(self.model, *batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.acc = loss.detach() if self.acc is None else self.acc + loss.detach()
        self.cnt += 1
        self.steps += 1

    def fetch(self) -> Dict[str, float]:
        return {"loss": float(self.acc) / self.cnt}

    def reset_losses(self) -> None:
        self.acc, self.cnt = None, 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @contextlib.contextmanager
    def capture(self):
        """While open: every leaf's gradient as Adam gets it first, and the
        first step's answers."""
        cap = Captured()
        names = {p: n for n, p in self.model.named_parameters()}

        def outputs(module, args, out):
            if not cap.first_outputs:
                cap.first_outputs["y"] = host(out)

        handles = [self.optimizer.register_step_pre_hook(first_step_hook(cap, names)),
                   self.model.register_forward_hook(outputs)]
        try:
            yield cap
        finally:
            for h in handles:
                h.remove()

    def warm_up(self) -> None:
        """Every shape of the loop is the compared steps' shape."""

    def close(self) -> None:
        pass
