"""Faults planted in Style_GAN's timed path: half of each rendered batch
left out (the mean over the rest); one sample's outputs of E and G
replaced by another's where the step widens them to f32."""

from benchmark.tests.faults import half_rows, swap

FAULTS = {"train_loop": ("half_batch", "row_swapped")}


def plant(monkeypatch, cell, fault: str) -> None:
    import vaeplay_torch.cli.train_style_gan as sg_cli
    import vaeplay_torch.train.steps_style_gan as steps_sg

    if fault == "half_batch":
        real = sg_cli.render_batch
        monkeypatch.setattr(sg_cli, "render_batch", lambda *a: (
            lambda xt, xc, lab, split: (*half_rows(xt, xc, lab), None))(*real(*a)))
    elif fault == "row_swapped":
        monkeypatch.setattr(steps_sg, "_widen", lambda t: swap(t.float()))
    else:
        raise ValueError((cell.name, fault))
