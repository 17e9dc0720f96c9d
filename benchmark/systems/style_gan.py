"""Style_GAN as `vaeplay_torch` trains it: the loop body of
`cli/train_style_gan.py` on synthetic bubbles rendered on the card."""

import contextlib
from typing import Dict

import torch

from benchmark.reference.style_gan import noise_seed
from benchmark.systems import Captured, first_step_hook, host
from vaeplay_torch.cli.train_style_gan import Bucketing, device_batches
from vaeplay_torch.data.be_data import SyntheticBubbleDataset
from vaeplay_torch.models.style_gan import Discriminator, Generator, StyleEncoder
from vaeplay_torch.train.metrics import accumulating, fetch_averages
from vaeplay_torch.train.state import StyleGanState
from vaeplay_torch.train.steps_style_gan import make_style_gan_train_step
from vaeplay_torch.utils.amp import autocast, resolve_dtype


class Trainer:
    """`train_style_gan`'s StyleGanState, step and feed: E, G and D with
    their three Adams, the step's noise from a generator on the card seeded
    from the run's seed, and device_batches over SyntheticBubbleDataset
    seeded with it, label bucketing as the cell's traffic says."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, weights):
        self.device, self.cfg = device, cfg
        s, z, classes = cfg["image_size"], cfg["z_dim"], cfg["num_classes"]
        with torch.device("meta"):
            nets = {"e": StyleEncoder(z, s, max_channels=cfg["encoder_max_channels"]),
                    "g": Generator(s, z),
                    "d": Discriminator(s, classes, max_channels=cfg["discriminator_max_channels"])}
        for name, net in nets.items():
            nets[name] = net.to_empty(device=device).train()
            nets[name].load_state_dict({k[len(name) + 1:]: v for k, v in weights.items()
                                        if k.startswith(name + ".")})
        self.nets = nets
        self.ss = StyleGanState.create(nets["e"], nets["g"], nets["d"], cfg["train"]["lr"])
        self.cdtype = resolve_dtype(traffic["compute_dtype"])
        noise = torch.Generator(device=device).manual_seed(noise_seed(seed))
        self.step_fn = accumulating(make_style_gan_train_step(nets["e"], nets["g"], nets["d"], z,
                                                              self.cdtype, noise))
        self.samples_per_step = b = traffic["batch_size"]
        self.bucketing = Bucketing(traffic["label_bucketing"], classes, b)
        self.dset = SyntheticBubbleDataset(img_size=s, data_size=traffic["epoch_iterations"] * b,
                                           seed=seed)
        self.workers = traffic["workers"]
        self.it = device_batches(self.dset, b, 0, self.workers, classes, self.bucketing, device)
        self.acc, self.cnt, self.steps = None, 0, 0

    def next_batch(self):
        try:
            return next(self.it)
        except StopIteration:  # the CLI's restart
            self.it = device_batches(self.dset, self.samples_per_step, self.steps, self.workers,
                                     self.cfg["num_classes"], self.bucketing, self.device)
            return next(self.it)

    def to_device(self, batch):
        """device_batches renders every batch on the card."""
        return batch

    def step(self, batch) -> None:
        self.ss, self.acc, self.cnt = self.step_fn(self.ss, self.acc, self.cnt, *batch)
        self.steps += 1

    def fetch(self) -> Dict[str, float]:
        return fetch_averages(self.acc, self.cnt)

    def reset_losses(self) -> None:
        self.acc, self.cnt = None, 0

    def params(self) -> Dict[str, torch.Tensor]:
        return {f"{n}.{k}": p for n, net in self.nets.items() for k, p in net.named_parameters()}

    @contextlib.contextmanager
    def capture(self):
        """While open: every leaf's gradient as its Adam gets it first, and
        the first step's first outputs of G (x_gen), E (mu, logvar of the
        target) and D (its two heads on x_rec)."""
        cap = Captured()
        handles = []
        for n, ts in (("e", self.ss.e), ("g", self.ss.g), ("d", self.ss.d)):
            names = {p: f"{n}.{k}" for k, p in self.nets[n].named_parameters()}
            handles.append(ts.optimizer.register_step_pre_hook(first_step_hook(cap, names)))
        keys = {"g": ("g",), "e": ("e.mu", "e.logvar"), "d": ("d.adv", "d.aux")}

        def outputs(n):
            def hook(module, args, out):
                if keys[n][0] not in cap.first_outputs:
                    outs = out if isinstance(out, tuple) else (out,)
                    cap.first_outputs.update({k: host(o) for k, o in zip(keys[n], outs)})
            return hook

        handles += [self.nets[n].register_forward_hook(outputs(n)) for n in keys]
        try:
            yield cap
        finally:
            for h in handles:
                h.remove()

    def warm_up(self) -> None:
        """G's forward and backward in both of its forms, blended and split
        at (B/2, B/2), which the bucketing picks by each batch's labels; the
        gradients are cleared by the next step. Weights, optimizer state and
        the step's noise stay as they are."""
        b, s, z = self.samples_per_step, self.cfg["image_size"], self.cfg["z_dim"]
        dev, g = self.device, self.nets["g"]
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.rand((b, 3, s, s), generator=gen, device=dev)
        code = torch.randn((b, z), generator=gen, device=dev).requires_grad_()
        labels = (torch.arange(b, device=dev) >= b // 2).long()
        forms = [None] + ([self.bucketing.allowed] if self.bucketing.enabled else [])
        for split in forms:
            with autocast(dev, self.cdtype):
                out = g(x, code, labels, split)
            out.float().sum().backward()
        for p in g.parameters():
            p.grad = None if p.grad is None else p.grad.zero_()

    def close(self) -> None:
        pass
