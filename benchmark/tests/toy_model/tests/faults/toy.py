"""Faults planted in the toy's timed path: half of each batch left out of
the loss (the mean over the rest); one sample's answer replaced by
another's where the model produces it."""

from benchmark.tests.faults import half_rows, swap

FAULTS = {"train_loop": ("half_batch", "row_swapped")}


def plant(monkeypatch, cell, fault: str) -> None:
    import benchmark.systems.toy as toy

    if fault == "half_batch":
        real = toy.loss_of
        monkeypatch.setattr(toy, "loss_of", lambda m, x, y: real(m, *half_rows(x, y)))
    elif fault == "row_swapped":
        real = toy.Perceptron.forward
        monkeypatch.setattr(toy.Perceptron, "forward", lambda self, x: swap(real(self, x)))
    else:
        raise ValueError((cell.name, fault))
