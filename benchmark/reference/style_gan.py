"""Plain reference of Style_GAN, the bubble-style VAE-GAN (kungyao/vae-play
models/network_Style_GAN.py, train_Style_GAN.py's `train_random_gan`), as the
port trains it: an encoder E, a label-gated U-Net generator G whose MLP
paints a fourth input plane, and a discriminator D, each with its own Adam.

Functional, over one dict of weights whose keys are the port's state_dict
keys of E, G and D under "e.", "g." and "d.". G's gated convolutions run in
their blended form (out = conv_1(x)(1 - y) + conv_2(x) y) on every batch:
the port's label-bucketed form computes the same per-sample values. The
synthetic bubbles, their label sort and the step's noise are made here
again from the seed.
"""

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.common import (Adam, Ops, Spec, TrainRecord, activation, conv_spec,
                                        grads_of, leaves, linear_spec, make_weights, nudged,
                                        run_train, swap_last_row)

LOSS_KEYS = ("g_rec_kl_loss", "g_rec_d_loss", "g_rec_pixel_loss", "g_gen_d_loss", "loss_latent",
             "d_real_loss", "d_fake_loss")
# computed before the step's first optimizer update (loss_latent reads the updated E)
PRE_UPDATE = LOSS_KEYS[:4] + LOSS_KEYS[5:]
NETS = ("e", "g", "d")
IMAGE_CHANNEL = 3


# ---- weights -------------------------------------------------------------------------------

def mlp_widths(nf_in: int, nf_out: int, blocks: int) -> List[int]:
    ratio = int(2 ** (int(math.log2(nf_out / nf_in)) / (blocks - 1)))
    widths, out = [nf_in, nf_in], nf_in
    for _ in range(blocks - 2):
        out = min(out * ratio, nf_out)
        widths.append(out)
    return widths + [nf_out]


def _levels(cfg: dict) -> int:
    return int(math.log2(cfg["image_size"])) - 2


def _pyramid(prefix: str, c: int, levels: int, c_max: int) -> List[Spec]:
    out = []
    for i in range(1, levels + 1):
        out += conv_spec(f"{prefix}convs.{i}.conv.0.", min(c * 2, c_max), c, 3, bias=False)
        c = min(c * 2, c_max)
    return out


def _top(c: int, levels: int, c_max: int) -> int:
    for _ in range(levels):
        c = min(c * 2, c_max)
    return c


def _scse_specs(p: str, c: int) -> List[Spec]:
    return (conv_spec(p + "cSE.1.", c // 4, c, 1) + conv_spec(p + "cSE.3.", c, c // 4, 1)
            + conv_spec(p + "sSE.0.", 1, c, 1))


def param_specs(cfg: dict) -> List[Spec]:
    """E's, G's and D's weights under "e.", "g." and "d.", each in the port's
    state_dict order."""
    lv, z, s = _levels(cfg), cfg["z_dim"], cfg["image_size"]
    e_max, d_max = cfg["encoder_max_channels"], cfg["discriminator_max_channels"]
    ce = _top(64, lv, e_max)
    specs = conv_spec("e.convs.0.conv.0.", 64, IMAGE_CHANNEL, 5)
    specs += _pyramid("e.", 64, lv, e_max)
    specs += conv_spec(f"e.convs.{lv + 1}.conv.0.", ce, ce, 3)
    specs += conv_spec(f"e.convs.{lv + 2}.conv.0.", ce, ce, 3)
    specs += linear_spec("e.fc_mu.fc.0.", z, ce) + linear_spec("e.fc_logvar.fc.0.", z, ce)
    w = mlp_widths(z, s * s, cfg["mlp_blocks"])
    for i in range(len(w) - 1):
        specs += linear_spec(f"g.mlp.model.{i}.fc.0.", w[i + 1], w[i])
    for name, c_in, c_out, k, bias in (("conv1", IMAGE_CHANNEL + 1, 32, 3, True),
                                       ("conv2", 32, 32, 3, True), ("down1", 32, 64, 4, False),
                                       ("down2", 64, 128, 4, False), ("down3", 128, 256, 4, False),
                                       ("down4", 256, 256, 4, False)):
        for half in ("conv_1", "conv_2"):
            specs += conv_spec(f"g.{name}.{half}.conv.0.", c_out, c_in, k, bias)
    for name, c in (("skip1", 256), ("skip2", 128), ("skip3", 64)):
        specs += conv_spec(f"g.{name}.conv.0.", c, c, 3, bias=False)
    for name, c_in, c_skip, c in (("up1", 256, 256, 256), ("up2", 256, 128, 128),
                                  ("up3", 128, 64, 64)):
        specs += conv_spec(f"g.{name}.up_convs.0.", c, c_in, 4, transposed=True)
        specs += conv_spec(f"g.{name}.cat_convs.0.conv.0.", c, c + c_skip, 3)
        specs += _scse_specs(f"g.{name}.cat_convs.1.", c) + _scse_specs(f"g.{name}.cat_convs.2.", c)
    specs += conv_spec("g.final.0.", 32, 64, 4, transposed=True)
    for i, c_out in ((1, 32), (2, 32), (3, IMAGE_CHANNEL)):
        specs += conv_spec(f"g.final.{i}.conv.0.", c_out, 32, 3)
    cd = _top(64, lv, d_max)
    specs += conv_spec("d.convs.0.conv.0.", 64, 2 * IMAGE_CHANNEL, 5)
    specs += _pyramid("d.", 64, lv, d_max)
    for head, n in (("adv_convs", 1), ("aux_convs", cfg["num_classes"])):
        specs += conv_spec(f"d.{head}.0.conv.0.", cd, cd, 3)
        specs += conv_spec(f"d.{head}.1.conv.0.", n, cd, 3)
    return specs


def weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return make_weights(param_specs(cfg), seed % (2 ** 63), device)


def noise_seed(seed: int) -> int:
    """The seed of the step's noise generator (eps and z_sample)."""
    return (seed + 1) % (2 ** 63)


# ---- data ----------------------------------------------------------------------------------

def bubble_params(image_size: int, batch_size: int, seed: int, batch_seed: int):
    """(params (B, 5) [cx, cy, rx, ry, gray] f64, raw labels (B,) in 1..3),
    the port's sample_bubble_params stream."""
    rng = np.random.default_rng((seed, batch_seed))
    labels = rng.integers(1, 4, size=batch_size)
    params = np.zeros((batch_size, 5), np.float64)
    for i in range(batch_size):
        cx, cy = rng.uniform(0.3 * image_size, 0.7 * image_size, size=2)
        rx, ry = rng.uniform(0.15 * image_size, 0.3 * image_size, size=2)
        params[i] = (cx, cy, rx, ry, rng.uniform(0.0, 0.4))
    return params, labels.astype(np.int64)


def render(n: int, p: torch.Tensor):
    """Bubbles (B, 3, n, n) and their content masks (B, 1, n, n), f32: a
    white page, a gray ellipse interior, a black ring, by an f64 distance
    test on f32 pixel coordinates."""
    coords = torch.arange(n, dtype=torch.float32, device=p.device).to(torch.float64)
    dx = (coords.view(1, 1, n) - p[:, 0, None, None]) / p[:, 2, None, None]
    dy = (coords.view(1, n, 1) - p[:, 1, None, None]) / p[:, 3, None, None]
    d = dx * dx + dy * dy
    inside = d <= 1.0
    ring = inside & (d >= 0.75)
    gray = p[:, 4, None, None].to(torch.float32)
    img = torch.where(ring, 0.0, torch.where(inside, gray, 1.0))
    return img[:, None].expand(-1, 3, -1, -1).contiguous(), inside[:, None].float()


def batch(cfg: dict, traffic: dict, seed: int, k: int, device):
    """Step k's (x_target, x_content, labels): batch seed k of the seed's
    bubbles, labels = raw % classes, sorted label-0 first (stable) when the
    cell buckets by label."""
    b, n = traffic["batch_size"], cfg["image_size"]
    params, raw = bubble_params(n, b, seed, k)
    labels = raw % cfg["num_classes"]
    if traffic["label_bucketing"] and cfg["num_classes"] == 2:
        order = np.argsort(labels, kind="stable")
        params, labels = params[order], labels[order]
    imgs, masks = render(n, torch.from_numpy(params).to(device))
    return imgs, masks.expand(-1, 3, -1, -1).contiguous(), torch.from_numpy(labels).to(device)


# ---- model ---------------------------------------------------------------------------------

def _conv(ops: Ops, P, prefix: str, x, stride: int = 1, norm: bool = False,
          act: Optional[str] = "relu"):
    w = P[prefix + "weight"]
    y = ops.conv2d(x, w, P.get(prefix + "bias"), stride, (w.shape[-1] - 1) // 2)
    if norm:
        y = F.instance_norm(y, eps=1e-5)
    return activation(y, act, 0.02)


def _flat(h):
    if h.shape[2:] != (1, 1):
        raise ValueError(f"the map before the flatten is {tuple(h.shape[2:])}, not 1 x 1")
    return h.flatten(1)


def encode(ops: Ops, P, cfg: dict, x):
    lv = _levels(cfg)
    h = _conv(ops, P, "e.convs.0.conv.0.", x, act=None)
    for i in range(1, lv + 1):
        h = _conv(ops, P, f"e.convs.{i}.conv.0.", h, 2, norm=True)
    for i in (lv + 1, lv + 2):
        h = _conv(ops, P, f"e.convs.{i}.conv.0.", h, 2)
    h = _flat(h)
    return (ops.linear(h, P["e.fc_mu.fc.0.weight"], P["e.fc_mu.fc.0.bias"]),
            ops.linear(h, P["e.fc_logvar.fc.0.weight"], P["e.fc_logvar.fc.0.bias"]))


def _gated(ops: Ops, P, prefix: str, x, labels, stride: int, norm: bool, act):
    a = _conv(ops, P, prefix + "conv_1.conv.0.", x, stride, norm, act)
    b = _conv(ops, P, prefix + "conv_2.conv.0.", x, stride, norm, act)
    lab = labels.reshape(-1, 1, 1, 1)
    return a * (1.0 - lab.to(a.dtype)) + b * lab.to(b.dtype)


def _scse(ops: Ops, P, p: str, x):
    c = F.relu(ops.conv2d(F.adaptive_avg_pool2d(x, 1), P[p + "cSE.1.weight"], P[p + "cSE.1.bias"]))
    c = torch.sigmoid(ops.conv2d(c, P[p + "cSE.3.weight"], P[p + "cSE.3.bias"]))
    s = torch.sigmoid(ops.conv2d(x, P[p + "sSE.0.weight"], P[p + "sSE.0.bias"]))
    return x * c + x * s


def _up(ops: Ops, P, p: str, x, skip):
    u = ops.conv_transpose2d(x, P[p + "up_convs.0.weight"], P[p + "up_convs.0.bias"])
    h = torch.cat([F.relu(F.instance_norm(u, eps=1e-5)), skip], dim=1)
    h = _conv(ops, P, p + "cat_convs.0.conv.0.", h)
    return F.relu(_scse(ops, P, p + "cat_convs.2.", _scse(ops, P, p + "cat_convs.1.", h)))


def generate(ops: Ops, P, cfg: dict, x, z, labels):
    s = cfg["image_size"]
    h = z.flatten(1)
    for i in range(cfg["mlp_blocks"]):
        h = ops.linear(h, P[f"g.mlp.model.{i}.fc.0.weight"], P[f"g.mlp.model.{i}.fc.0.bias"])
    h = torch.cat([x, h.reshape(-1, 1, s, s)], dim=1)
    h = _gated(ops, P, "g.conv1.", h, labels, 1, False, None)
    h = _gated(ops, P, "g.conv2.", h, labels, 1, False, None)
    d1 = _gated(ops, P, "g.down1.", h, labels, 2, True, "relu")
    d2 = _gated(ops, P, "g.down2.", d1, labels, 2, True, "relu")
    d3 = _gated(ops, P, "g.down3.", d2, labels, 2, True, "relu")
    d4 = _gated(ops, P, "g.down4.", d3, labels, 2, True, "relu")
    u = _up(ops, P, "g.up1.", d4, _conv(ops, P, "g.skip1.conv.0.", d3, norm=True))
    u = _up(ops, P, "g.up2.", u, _conv(ops, P, "g.skip2.conv.0.", d2, norm=True))
    u = _up(ops, P, "g.up3.", u, _conv(ops, P, "g.skip3.conv.0.", d1, norm=True))
    f = ops.conv_transpose2d(u, P["g.final.0.weight"], P["g.final.0.bias"])
    f = _conv(ops, P, "g.final.1.conv.0.", f)
    f = _conv(ops, P, "g.final.2.conv.0.", f)
    return torch.tanh(_conv(ops, P, "g.final.3.conv.0.", f, act=None))


def discriminate(ops: Ops, P, cfg: dict, x, x_content):
    h = _conv(ops, P, "d.convs.0.conv.0.", torch.cat([x, x_content], dim=1))
    for i in range(1, _levels(cfg) + 1):
        h = _conv(ops, P, f"d.convs.{i}.conv.0.", h, 2, norm=True)
    adv = _conv(ops, P, "d.adv_convs.0.conv.0.", h, 2, act="lrelu")
    adv = _flat(_conv(ops, P, "d.adv_convs.1.conv.0.", adv, 2, act=None))
    aux = _conv(ops, P, "d.aux_convs.0.conv.0.", h, 2, act="lrelu")
    aux = _flat(_conv(ops, P, "d.aux_convs.1.conv.0.", aux, 2, act=None))
    wide = torch.promote_types(adv.dtype, torch.float32)
    return torch.sigmoid(adv.to(wide)), torch.softmax(aux.to(wide), dim=-1)


# ---- the step (train_Style_GAN.py:162-281) --------------------------------------------------

def _f32(t):
    return t.float() if t.dtype == torch.bfloat16 else t


def _d_terms(valid, typ, labels, target: float):
    """mean BCE(valid -> target) + mean CE over D's class probabilities (the
    reference's double softmax)."""
    ce = -torch.gather(torch.log_softmax(typ, -1), -1, labels.long()[:, None])[:, 0]
    return F.binary_cross_entropy(valid, torch.full_like(valid, target)).mean() + ce.mean()


def train(cfg: dict, traffic: dict, seed: int, device, precision: str = "f32",
          steps: int = 3, teacher: Optional[list] = None, fault: Optional[str] = None,
          against: Optional[dict] = None, keep_first_grads: bool = False,
          nudge: bool = False) -> TrainRecord:
    """`steps` steps of train_Style_GAN from the seed's weights, batches and
    noise. E/G phase: x_gen = G(content, z_sample) kept with its graph and a
    detached copy xg; with D frozen, KL + rec_d + pixel + gen_d backpropagates
    into E, G and xg; E's Adam steps. Latent+G: with the updated E, lat =
    0.5 mean|E(xg).mu - z_sample|; x_gen's branch pulls back xg's gradient
    plus lat's into G; G's Adam steps. D phase on the target and the
    pre-update x_rec; D's Adam steps. `teacher` is unused (no intermediate
    answer feeds a later stage). Planted faults (`fault`): "half_batch"
    trains on the first half of each batch, "row_swapped" replaces G's last
    output row by its first where G produces them. `nudge` starts from the
    weights one ulp up."""
    ops = Ops(precision)
    w = weights(cfg, seed, device)
    P = leaves(nudged(w) if nudge else w)
    nets = {n: {k: v for k, v in P.items() if k.startswith(n + ".")} for n in NETS}
    t = cfg["train"]
    opts = {n: Adam(nets[n], t["lr"], tuple(t["betas"]), t["eps"]) for n in NETS}
    noise = torch.Generator(device=device).manual_seed(noise_seed(seed))
    b, z = traffic["batch_size"], cfg["z_dim"]

    def step(k, descend):
        xt, xc, labels = batch(cfg, traffic, seed, k, device)
        eps = torch.randn((b, z), generator=noise, device=device)
        zs = torch.randn((b, z), generator=noise, device=device)
        if fault == "half_batch":
            xt, xc, labels, eps, zs = (a[:b // 2] for a in (xt, xc, labels, eps, zs))
        swap = swap_last_row if fault == "row_swapped" else (lambda t: t)
        with ops.context(device):
            x_gen = swap(_f32(generate(ops, P, cfg, xc, zs, labels)))
        xg = x_gen.detach().requires_grad_()
        frozen_d = {k: v.detach() for k, v in nets["d"].items()}
        with ops.context(device):
            mu, logvar = (_f32(a) for a in encode(ops, P, cfg, xt))
            x_rec = swap(_f32(generate(ops, P, cfg, xc, eps * torch.exp(logvar / 2.0) + mu,
                                       labels)))
            rec = discriminate(ops, frozen_d, cfg, x_rec, xc)
            gen = discriminate(ops, frozen_d, cfg, xg, xc)
        m = {"g_rec_kl_loss": 0.5 * torch.sum(torch.exp(logvar) + mu ** 2 - logvar - 1.0),
             "g_rec_d_loss": _d_terms(*rec, labels, 1.0),
             "g_rec_pixel_loss": (x_rec - xt).abs().mean(),
             "g_gen_d_loss": _d_terms(*gen, labels, 1.0)}
        eg = {**nets["e"], **nets["g"], "xg": xg}
        g_eg = grads_of(sum(m.values()), eg)
        descend(opts["e"], {k: g_eg[k] for k in nets["e"]})
        xg2 = x_gen.detach().requires_grad_()
        with ops.context(device):
            mu2 = _f32(encode(ops, P, cfg, xg2)[0])
        lat = (mu2 - zs).abs().mean() * 0.5
        (lat_cot,) = torch.autograd.grad(lat, xg2)
        g_gen = grads_of(x_gen, nets["g"], grad_outputs=g_eg["xg"] + lat_cot)
        descend(opts["g"], {k: g_eg[k] + g_gen[k] for k in nets["g"]})
        with ops.context(device):
            real = discriminate(ops, P, cfg, xt, xc)
            fake = discriminate(ops, P, cfg, x_rec.detach(), xc)
        m["loss_latent"] = lat
        m["d_real_loss"] = _d_terms(*real, labels, 1.0)
        m["d_fake_loss"] = _d_terms(*fake, labels, 0.0)
        descend(opts["d"], grads_of((m["d_real_loss"] + m["d_fake_loss"]) * 0.5, nets["d"]))
        outputs = {"g": x_gen, "e.mu": mu, "e.logvar": logvar, "d.adv": rec[0], "d.aux": rec[1]}
        return {k: m[k].detach() for k in LOSS_KEYS}, None, outputs

    return run_train(step, P, steps, ops, PRE_UPDATE, against, keep_first_grads)
