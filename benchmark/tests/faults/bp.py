"""Faults planted in BP's timed path. Training: half of each batch left out
of both passes' losses (the mean over the rest); one sample's outputs
replaced by another's where the step reads them. Inference: the forward
answers half of each batch and repeats it; one image's answers replaced by
another's."""

import torch

from benchmark.tests.faults import half_rows, swap

FAULTS = {"train_loop": ("half_batch", "row_swapped"),
          "infer_closed_loop": ("half_batch", "row_swapped")}


def plant(monkeypatch, cell, fault: str) -> None:
    import vaeplay_torch.models.bp as bp_model
    import vaeplay_torch.train.steps_bp as steps_bp

    if fault == "half_batch" and cell.traffic["driver"] == "train_loop":
        for name in ("loss_phase1", "loss_phase2"):
            real = getattr(steps_bp, name)
            monkeypatch.setattr(steps_bp, name, lambda m, i, a, b, d, real=real:
                                real(m, *half_rows(i, a, b), d))
    elif fault == "row_swapped" and cell.traffic["driver"] == "train_loop":
        real = steps_bp._f32
        monkeypatch.setattr(steps_bp, "_f32",
                            lambda preds: {k: swap(v) for k, v in real(preds).items()})
    elif cell.traffic["driver"] == "infer_closed_loop":
        real = bp_model.ComposeNet.forward
        if fault == "half_batch":
            forward = lambda self, x: {k: torch.cat([v, v])[: x.shape[0]]
                                       for k, v in real(self, x[: x.shape[0] // 2]).items()}
        else:
            forward = lambda self, x: {k: swap(v) for k, v in real(self, x).items()}
        monkeypatch.setattr(bp_model.ComposeNet, "forward", forward)
    else:
        raise ValueError((cell.name, fault))
