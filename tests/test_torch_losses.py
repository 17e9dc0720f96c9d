"""The port's BP, VAE-GAN, BE_GAN and BCP losses (vaeplay_torch.ops.losses)
against the JAX package's: values and gradients against jax.grad, on the
CPU at f32 (BE_GAN's edge loss also in f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaeplay_torch.ops import losses as TL
from vaeplay_tpu.ops import losses as JL

TOL = 1e-5  # f32, same formulas; reductions may sum in another order
B, S, D = 3, 40, 40


def _pt_inputs(rng, trig_rows):
    """Logits, line params, sample info and per-degree targets whose trigger
    column is trig_rows (B, D)."""
    logits = rng.normal(size=(B, S, 2)).astype(np.float32)
    line = rng.normal(size=(B, S, 4)).astype(np.float32)
    info = np.zeros((B, S, 5), np.float32)
    info[..., :2] = rng.uniform(-0.8, 0.8, (B, S, 2))
    ang = rng.uniform(0, 2 * np.pi, (B, S))
    info[..., 2], info[..., 3] = np.cos(ang), np.sin(ang)
    # degree indices with a fraction, truncated by the gather; some repeat
    info[..., 4] = rng.integers(0, D, (B, S)) + rng.uniform(0, 0.99, (B, S))
    gt = np.zeros((B, D, 6), np.float32)
    gt[..., 0] = trig_rows
    gt[..., 1:3] = rng.uniform(-0.9, 0.9, (B, D, 2))
    tang = rng.uniform(0, 2 * np.pi, (B, D))
    gt[..., 3], gt[..., 4] = np.cos(tang), np.sin(tang)
    # point 0 of image 1 faces its target's direction: a dot product of 1
    # up to rounding, where the clip of arccos's argument acts
    gt[1, int(info[1, 0, 4]), 3:5] = info[1, 0, 2:4]
    gt[..., 5] = rng.uniform(0.1, 0.3, (B, D))
    return logits, line, info, gt


def _check(fn_t, fn_j, diff_args, const_args):
    """Each output's value, and the gradient of its sum over diff_args."""
    t_args = [torch.from_numpy(a).requires_grad_() for a in diff_args]
    t_out = fn_t(*t_args, *map(torch.from_numpy, const_args))
    j_consts = [jnp.asarray(a) for a in const_args]
    j_out = fn_j(*map(jnp.asarray, diff_args), *j_consts)
    assert sorted(t_out) == sorted(j_out)
    for key in j_out:
        np.testing.assert_allclose(t_out[key].detach().numpy(), np.asarray(j_out[key]),
                                   atol=TOL, rtol=TOL, err_msg=key)
        grads_t = torch.autograd.grad(t_out[key], t_args, retain_graph=True,
                                      allow_unused=True, materialize_grads=True)
        grads_j = jax.grad(lambda *a: fn_j(*a, *j_consts)[key],
                           argnums=tuple(range(len(diff_args))))(*map(jnp.asarray, diff_args))
        for i, (gt, gj) in enumerate(zip(grads_t, grads_j)):
            assert bool(torch.isfinite(gt).all()), (key, i)
            np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=TOL, rtol=TOL,
                                       err_msg=f"d {key} / d arg {i}")


@pytest.mark.parametrize("case", ["both_classes", "no_trigger", "all_triggered"])
def test_ellipse_pt_loss_matches_jax(case):
    rng = np.random.default_rng({"both_classes": 0, "no_trigger": 1, "all_triggered": 2}[case])
    trig = {"both_classes": (rng.uniform(size=(B, D)) < 0.3).astype(np.float32),
            "no_trigger": np.zeros((B, D), np.float32),  # max(sum(mask), 1) in masked_mean
            "all_triggered": np.ones((B, D), np.float32)}[case]
    logits, line, info, gt = _pt_inputs(rng, trig)
    _check(TL.ellipse_pt_loss, JL.ellipse_pt_loss, (logits, line), (info, gt))


def test_ellipse_param_loss_matches_jax():
    rng = np.random.default_rng(3)
    preds = rng.normal(size=(4, 5)).astype(np.float32) * 5
    gt = np.concatenate([rng.uniform(-0.5, 0.5, (4, 4)),
                         rng.integers(10, 40, (4, 1))], axis=1).astype(np.float32)
    _check(TL.ellipse_param_loss, JL.ellipse_param_loss, (preds,), (gt,))


@pytest.mark.parametrize("name", ["masked_mean", "masked_mean_empty", "dice_loss",
                                  "softmax_cross_entropy"])
def test_helpers_match_jax(name):
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(3, 7, 2)).astype(np.float32)
    if name.startswith("masked_mean"):
        mask = (rng.uniform(size=(3, 7, 1)) < (0.0 if name.endswith("empty") else 0.5))
        t = TL.masked_mean(torch.from_numpy(x), torch.from_numpy(mask))
        j = JL.masked_mean(jnp.asarray(x), jnp.asarray(mask))
        if name.endswith("empty"):
            assert float(t) == 0.0
    elif name == "dice_loss":
        y = (rng.uniform(size=x.shape) < 0.5).astype(np.float32)
        t = TL.dice_loss(torch.from_numpy(x), torch.from_numpy(y))
        j = JL.dice_loss(jnp.asarray(x), jnp.asarray(y))
    else:
        labels = rng.integers(0, 2, (3, 7)).astype(np.int32)
        t = TL.softmax_cross_entropy(torch.from_numpy(x), torch.from_numpy(labels))
        j = JL.softmax_cross_entropy(jnp.asarray(x), jnp.asarray(labels))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", ["interior", "saturated"])
def test_vaegan_losses_match_jax(case):
    """Every piece, values and gradients; "saturated" puts the discriminator's
    outputs at exactly 0 and 1, where the + 1e-3 inside the logs keeps them
    finite (not torch's BCE clamps)."""
    rng = np.random.default_rng({"interior": 5, "saturated": 6}[case])
    b, z, f = 4, 8, 24
    x = (rng.uniform(size=(b, 1, 8, 8)) < 0.5).astype(np.float32)
    x_tilde = rng.uniform(0.05, 0.95, (b, 1, 8, 8)).astype(np.float32)
    layer_o, layer_p = (rng.normal(size=(b, f)).astype(np.float32) for _ in range(2))
    dc = rng.uniform(0.02, 0.98, (3, b)).astype(np.float32)
    if case == "saturated":
        dc[0, :2], dc[1, :2], dc[2, 2:] = 0.0, 1.0, 1.0
        dc[0, 2:] = 1.0
    mus, logvar = (rng.normal(size=(b, z)).astype(np.float32) for _ in range(2))
    targets = rng.normal(size=(b, 3)).astype(np.float32) * 0.5
    params = targets + rng.normal(size=(b, 3)).astype(np.float32) * 1.5  # both Huber branches
    diff = (x_tilde, layer_o, layer_p, dc[0], dc[1], dc[2], mus, logvar, params)

    def order(fn):
        return lambda xt, lo, lp, d0, d1, d2, mu, lv, p, xx, tg: fn(
            xx, xt, lo, lp, d0, d1, d2, mu, lv, tg, p)

    t_out = order(TL.vaegan_losses)(*map(torch.from_numpy, diff + (x, targets)))
    j_out = order(JL.vaegan_losses)(*map(jnp.asarray, diff + (x, targets)))
    for key in j_out:  # the per-sample pieces themselves
        assert bool(torch.isfinite(t_out[key]).all()), key
        np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]), atol=TOL,
                                   rtol=TOL, err_msg=key)

    def summed(fn):
        return lambda *a: {k: v.sum() for k, v in order(fn)(*a).items()}

    _check(summed(TL.vaegan_losses), summed(JL.vaegan_losses), diff, (x, targets))


def test_smooth_l1_matches_jax():
    rng = np.random.default_rng(7)
    target = rng.normal(size=(5, 3)).astype(np.float32)
    pred = target + np.linspace(-3, 3, 15, dtype=np.float32).reshape(5, 3)  # |d| < 1 and >= 1
    np.testing.assert_allclose(TL.smooth_l1(torch.from_numpy(pred), torch.from_numpy(target)),
                               np.asarray(JL.smooth_l1(jnp.asarray(pred), jnp.asarray(target))),
                               atol=TOL, rtol=TOL)
    _check(lambda p, t: {"l": TL.smooth_l1(p, t).sum()},
           lambda p, t: {"l": JL.smooth_l1(p, t).sum()}, (pred,), (target,))


@pytest.mark.parametrize("shape", [(2, 1, 9, 13), (1, 1, 1, 4)])
def test_laplacian_edges_matches_jax(shape):
    """|3x3 Laplacian / 8| with zero-padded borders on an NCHW map against
    the JAX package's on NHWC, f32, including a 1-pixel-high map."""
    x = np.random.default_rng(shape[2]).normal(size=shape).astype(np.float32)
    want = np.asarray(JL.laplacian_edges(jnp.asarray(np.transpose(x, (0, 2, 3, 1)))))
    got = TL.laplacian_edges(torch.from_numpy(x))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.transpose(want, (0, 3, 1, 2)), rtol=TOL,
                               atol=TOL * np.abs(want).max())


def test_edge_loss_value_and_gradient_match_jax():
    """BE_GAN's edge loss on sigmoid maps and binary targets, value and the
    gradient with respect to the maps, in f64 within 1e-12 relative."""
    rng = np.random.default_rng(7)
    maps = 1.0 / (1.0 + np.exp(-rng.normal(size=(2, 1, 12, 10))))
    targets = (rng.uniform(size=(2, 1, 12, 10)) < 0.4).astype(np.float64)
    nhwc = lambda a: jnp.asarray(np.transpose(a, (0, 2, 3, 1)))
    with jax.enable_x64(True):
        want, want_g = jax.value_and_grad(JL.edge_loss)(nhwc(maps), nhwc(targets))
        want, want_g = float(want), np.transpose(np.asarray(want_g), (0, 3, 1, 2))
    x = torch.from_numpy(maps).requires_grad_()
    got = TL.edge_loss(x, torch.from_numpy(targets))
    got.backward()
    np.testing.assert_allclose(float(got), want, rtol=1e-12)
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=1e-9, atol=1e-12 * np.abs(want_g).max())


@pytest.mark.parametrize("case", ["interior", "saturated"])
def test_bce_value_and_gradient_match_jax(case):
    """BCP's BCE on probabilities: values and the gradient with respect to the
    probabilities against the JAX package's custom VJP, f32, exact to 1e-6
    relative; saturated probabilities (0, 1, 1.5e-38, 1e-40, 1 - 6e-8) meet
    torch's clamps (log terms at -100, the backward's denominator at 1e-12)
    on both sides and stay finite. 1e-40 is subnormal in f32: XLA on the CPU
    flushes it to 0, so the JAX value there is the clamp's 100, where torch
    takes -log(1e-40) = 92.10; that one value is held to the latter."""
    rng = np.random.default_rng(8)
    if case == "interior":
        p = rng.uniform(0.02, 0.98, 12).astype(np.float32)
        t = (rng.uniform(size=12) < 0.5).astype(np.float32)
    else:
        p = np.array([0.0, 1.0, 1.5e-38, 1e-40, 1.0 - 6e-8, 0.0, 1.0, 0.5], np.float32)
        t = np.array([1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 1.0, 1.0], np.float32)
    x = torch.from_numpy(p).requires_grad_()
    got = TL.bce(x, torch.from_numpy(t))
    got.sum().backward()
    want, vjp = jax.vjp(lambda q: JL.bce(q, jnp.asarray(t)), jnp.asarray(p))
    want, want_g = np.array(want), np.asarray(vjp(jnp.ones_like(want))[0])
    subnormal = (p > 0) & (p < np.finfo(np.float32).tiny)
    want[subnormal] = -np.log(p[subnormal].astype(np.float64))
    assert subnormal.sum() == (case == "saturated")
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(x.grad).all())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=1e-6, atol=0)
