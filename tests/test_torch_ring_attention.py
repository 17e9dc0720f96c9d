"""The port's ring attention (vaeplay_torch.parallel.ring_attention) in 2-
and 4-rank gloo worlds against the JAX ring on a virtual model mesh, its
block update against the plain attention, and RingRouting's rule against
JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from vaeplay_torch.ops.attention import RingRouting, attention_backward, reference_attention
from vaeplay_torch.parallel import ring_attention as R
from vaeplay_tpu.ops.attention import RingRouting as JaxRingRouting
from vaeplay_tpu.parallel.mesh import create_mesh
from vaeplay_tpu.parallel.ring_attention import ring_self_attention as jax_ring

B, N, DK, DV = 2, 64, 8, 12


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, N, DK), (B, N, DK), (B, N, DV), (B, N, DV))]


def _jax_ring(world, q, k, v, w):
    mesh = create_mesh(n_data=1, n_model=world, devices=jax.devices()[:world])

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jax_ring(q, k, v, mesh, axis="model")) * w)

    out = jax_ring(q, k, v, mesh, axis="model")
    return np.asarray(out), [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("world", [2, 4])
def test_ring_matches_jax_ring(tmp_path, world):
    q, k, v, w = _inputs(world)
    want_out, want_grads = _jax_ring(world, q, k, v, w)
    ranks = W.run_world(W.ring_forward_backward, world, tmp_path, q, k, v, w, torch.float32)
    got_out = np.concatenate([r["out"].numpy() for r in ranks], axis=1)
    np.testing.assert_allclose(got_out, want_out, atol=2e-4, rtol=2e-4)
    for i, want in enumerate(want_grads):
        got = np.concatenate([r["grads"][i].numpy() for r in ranks], axis=1)
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)


def test_ring_under_bf16_autocast_computes_in_f32(tmp_path):
    """Called inside a bf16 autocast on bf16 slices, the ring's forward and
    backward still compute in f32: its output and gradients are those of
    the f64 attention of the same bf16 inputs, rounded once to bf16
    (within 2^-8 of each tensor's largest magnitude)."""
    q, k, v, w = _inputs(11)
    q = q * 2  # scores of a few tens: a bf16 score would be off by ~0.1
    rounded = [torch.tensor(a).bfloat16().double() for a in (q, k, v)]
    g = torch.tensor(w).bfloat16().double()
    want_out = reference_attention(*rounded)
    want_grads = attention_backward(*rounded, g)
    ranks = W.run_world(W.ring_bf16_autocast, 2, tmp_path, q, k, v, w)
    got_out = torch.cat([r["out"] for r in ranks], dim=1)
    assert got_out.dtype == torch.bfloat16
    for got, want in [(got_out, want_out)] + [
            (torch.cat([r["grads"][i] for r in ranks], dim=1), want_grads[i]) for i in range(3)]:
        torch.testing.assert_close(got.double(), want, rtol=0,
                                   atol=2.0 ** -8 * float(want.abs().max()))


def test_replicated_ring_equals_plain_attention_f64(tmp_path):
    """Every rank holding q, k, v whole: the gathered output is the plain
    attention's, and the gradients' mean over the ranks its gradients."""
    q, k, v, w = (a.astype(np.float64) for a in _inputs(7))
    t = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = reference_attention(*t)
    (torch.sin(out) * torch.tensor(w)).sum().backward()
    for r in W.run_world(W.ring_replicated, 2, tmp_path, q, k, v, w):
        torch.testing.assert_close(r["out"], out.detach(), rtol=0, atol=1e-12)
        for got, want in zip(r["grads"], t):
            torch.testing.assert_close(got, want.grad, rtol=0, atol=1e-12)


def test_ring_step_over_blocks_equals_plain_attention():
    """The block update and its backward iterated over 4 key/value blocks in
    one process (as chip_smoke.py holds them at BCP's shape)."""
    q, k, v, g = (torch.from_numpy(a).double() for a in _inputs(3))
    blocks = 4
    kb, vb = k.chunk(blocks, dim=1), v.chunk(blocks, dim=1)
    m = torch.full((B, N), R._NEG_INF, dtype=torch.float64)
    l, acc = torch.zeros(B, N, dtype=torch.float64), torch.zeros(B, N, DV, dtype=torch.float64)
    for kk, vv in zip(kb, vb):
        m, l, acc = R._ring_step(q, kk, vv, m, l, acc)
    out = acc / l[..., None]
    torch.testing.assert_close(out, reference_attention(q, k, v), rtol=0, atol=1e-12)
    lse, delta = m + torch.log(l), (g * out).sum(-1)
    parts = [R._ring_grad_step(q, kk, vv, g, lse, delta) for kk, vv in zip(kb, vb)]
    dq = sum(p[0] for p in parts)
    dk, dv = torch.cat([p[1] for p in parts], 1), torch.cat([p[2] for p in parts], 1)
    for got, want in zip((dq, dk, dv), attention_backward(q, k, v, g)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape,min_n", [((1, 2), 64), ((2, 2), 64), ((1, 4), 1024),
                                         ((4, 1), 16)])
def test_routing_rule_matches_jax(tmp_path, shape, min_n):
    ns = [16, 30, 64, 66, 1024, 2048, 4096]
    world = shape[0] * shape[1]
    mesh = create_mesh(n_data=shape[0], n_model=shape[1], devices=jax.devices()[:world])
    want = [JaxRingRouting(mesh, min_n=min_n).active(n) for n in ns]
    got = W.run_world(W.routing_active, world, tmp_path, shape, ns, min_n)
    assert all(r == want for r in got)
    assert not RingRouting().active(4096)
