"""BP as `vaeplay_torch` runs it: the loop body of `cli/train_bp.py` and the
forward of `cli/test_bp.py`."""

import contextlib
from typing import Dict

import torch

from benchmark.reference.bp import OUTPUT_KEYS
from benchmark.systems import Captured, first_step_hook, host
from vaeplay_torch.cli.test_bp import predict
from vaeplay_torch.cli.train_bp import to_device
from vaeplay_torch.data.bp_data import SyntheticEmitDataset
from vaeplay_torch.data.prefetch import epoch_iterator
from vaeplay_torch.models.bp import ComposeNet
from vaeplay_torch.train.metrics import accumulating, fetch_averages
from vaeplay_torch.train.state import TrainState, step_lr_every_two_epochs
from vaeplay_torch.train.steps_bp import make_bp_train_step
from vaeplay_torch.utils.amp import resolve_dtype


def build_model(cfg: dict, weights: Dict[str, torch.Tensor], device) -> ComposeNet:
    with torch.device("meta"):
        model = ComposeNet(image_size=cfg["image_size"],
                           emit_channels=[tuple(c) for c in cfg["emit_channels"]])
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return model


class Trainer:
    """`train_bp`'s state, step and batch feed: SyntheticEmitDataset seeded
    with the run's seed, epoch_iterator's prefetch thread, to_device, and
    accumulating(make_bp_train_step(...)) on one TrainState."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, weights):
        self.device = device
        self.model = build_model(cfg, weights, device).train()
        iterations = traffic["epoch_iterations"]
        t = cfg["train"]
        self.state = TrainState.create(self.model, t["lr"], step_lr_every_two_epochs(iterations),
                                       betas=tuple(t["betas"]))
        self.step_fn = accumulating(make_bp_train_step(self.model,
                                                       resolve_dtype(traffic["compute_dtype"])))
        self.samples_per_step = traffic["batch_size"]
        self.workers = traffic["workers"]
        self.dset = SyntheticEmitDataset(img_size=cfg["image_size"],
                                         data_size=iterations * self.samples_per_step, seed=seed)
        self.it = epoch_iterator(self.dset, self.samples_per_step, 0, workers=self.workers)
        self.acc, self.cnt, self.steps = None, 0, 0

    def next_batch(self):
        try:
            batch = next(self.it)
        except StopIteration:  # the CLI's restart
            self.it.close()
            self.it = epoch_iterator(self.dset, self.samples_per_step, self.steps,
                                     workers=self.workers)
            batch = next(self.it)
        return batch

    def to_device(self, batch):
        return to_device(batch, self.device)

    def step(self, batch) -> None:
        self.state, self.acc, self.cnt = self.step_fn(self.state, self.acc, self.cnt, *batch)
        self.steps += 1

    def fetch(self) -> Dict[str, float]:
        return fetch_averages(self.acc, self.cnt)

    def reset_losses(self) -> None:
        self.acc, self.cnt = None, 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @contextlib.contextmanager
    def capture(self):
        """While open: the gradient of every leaf as Adam gets it first (pass
        1 of the first step), pass 1's outputs of the first step, and each
        step's ellipse from stage 1 (the answer stage 2 samples at)."""
        cap = Captured()
        names = {p: n for n, p in self.model.named_parameters()}

        def outputs(module, args, out):
            if not cap.first_outputs:
                cap.first_outputs.update({k: host(out[k]) for k in OUTPUT_KEYS})

        handles = [
            self.state.optimizer.register_step_pre_hook(first_step_hook(cap, names)),
            self.model.register_forward_hook(outputs),
            self.model.ellipse_predictor.register_forward_hook(
                lambda module, args, out: cap.answers.append(out.detach().clone()))]
        try:
            yield cap
        finally:
            for h in handles:
                h.remove()

    def warm_up(self) -> None:
        """Every shape of the loop is the compared steps' shape."""

    def close(self) -> None:
        self.it.close()
        thread = getattr(self.it, "_thread", None)
        if thread is not None:
            thread.join(timeout=30)


class Server:
    """`test_bp.predict` on a ComposeNet in eval mode."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, weights):
        self.device = device
        self.model = build_model(cfg, weights, device).eval()
        self.samples_per_step = traffic["batch_size"]

    def __call__(self, imgs) -> Dict[str, torch.Tensor]:
        return predict(self.model, imgs, self.device)

    @staticmethod
    def teacher(outputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The answer stage 2 sampled at: the predicted ellipse."""
        return outputs["ellipse_params"]

    def close(self) -> None:
        pass
