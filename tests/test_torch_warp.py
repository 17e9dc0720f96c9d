"""The port's device augmentation (vaeplay_torch.ops.warp) against the JAX
package's ops/warp.py, on the CPU: the rotation matrices, the nearest warp
at exact half-pixel source coordinates, and the joint rotation/flip with the
JAX function's own draws handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaeplay_torch.ops import warp as TW
from vaeplay_tpu.ops import warp as JW


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _jax_draws(rng, b, max_deg=30.0):
    """random_joint_rot_flip's draws, split from `rng` as the JAX function
    splits them (warp.py:94-100)."""
    r_ang, r_v, r_h = jax.random.split(rng, 3)
    angles = jax.random.uniform(r_ang, (b,), minval=-max_deg, maxval=max_deg)
    vflip = jax.random.bernoulli(r_v, 0.5, (b,))
    hflip = jax.random.bernoulli(r_h, 0.5, (b,))
    return tuple(torch.from_numpy(np.asarray(t)) for t in (angles, vflip, hflip))


@pytest.mark.parametrize("h,w", [(16, 16), (12, 17)])
def test_rotation_inv_matrix_matches_jax(h, w):
    """Within 2 f32 ulps of 1 (the two frameworks' f32 cos and sin may
    round differently)."""
    angles = np.random.default_rng(0).uniform(-30, 30, 6).astype(np.float32)
    want = np.asarray(JW.rotation_inv_matrix(jnp.asarray(angles), h, w))
    got = TW.rotation_inv_matrix(torch.from_numpy(angles), h, w).numpy()
    assert got.shape == (6, 2, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2.5e-7 * max(h, w), rtol=0)


@pytest.mark.parametrize("shift", [(0.5, -1.5), (-2.5, 0.5)])
def test_affine_warp_half_pixel_rounding_matches_jax(shift):
    """Translations to exact half pixels: nearest sampling rounds half to
    even on both sides (jnp.round, torch.round), so the two warps agree bit
    for bit; the fill covers what falls outside."""
    x = np.random.default_rng(1).uniform(size=(2, 7, 9, 3)).astype(np.float32)
    tx, ty = shift
    inv = np.array([[[1.0, 0.0, tx], [0.0, 1.0, ty]], [[0.0, 1.0, ty], [1.0, 0.0, tx]]],
                   np.float32)
    want = np.asarray(JW.affine_warp(jnp.asarray(x), jnp.asarray(inv), fill=0.25))
    got = _nhwc(TW.affine_warp(_nchw(x), torch.from_numpy(inv), fill=0.25))
    np.testing.assert_array_equal(got, want)
    if shift == (0.5, -1.5):
        # output row 2 reads source row 0.5 -> 0 (even); columns 0.5 and 1.5 -> 0 and 2
        np.testing.assert_array_equal(got[0, 2, :2], x[0, 0, [0, 2]])
        assert (got[0, 0] == 0.25).all()  # row -1.5 -> -2, outside: the fill
        np.testing.assert_array_equal(got[0, 1, :2], x[0, 0, [0, 2]])  # row -0.5 -> 0
    assert (got == 0.25).any() and (got != 0.25).any()


@pytest.mark.parametrize("h,w,seed", [(32, 32, 0), (24, 40, 1), (31, 20, 2)])
def test_random_joint_rot_flip_matches_jax(h, w, seed):
    """The JAX function's draws (split from its rng as it splits them)
    handed to the port: the image (white fill) and both masks (black fill),
    rotated about ((w - 1) / 2, (h - 1) / 2) and flipped the same way, agree
    bit for bit with the JAX outputs."""
    rng = np.random.default_rng(seed)
    b = 4
    imgs = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    bm = (rng.uniform(size=(b, h, w, 1)) < 0.4).astype(np.float32)
    em = (rng.uniform(size=(b, h, w, 1)) < 0.2).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    j_img, (j_b, j_e) = JW.random_joint_rot_flip(key, jnp.asarray(imgs), (jnp.asarray(bm),
                                                                        jnp.asarray(em)))
    draws = _jax_draws(key, b)
    t_img, (t_b, t_e) = TW.random_joint_rot_flip(_nchw(imgs), (_nchw(bm), _nchw(em)),
                                                 draws=draws)
    for got, want in ((t_img, j_img), (t_b, j_b), (t_e, j_e)):
        np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
    assert bool(draws[1].any()) or bool(draws[2].any())  # a flip happened somewhere
    assert float(t_img.max()) <= 1.0 and set(np.unique(t_b.numpy())) <= {0.0, 1.0}


def test_draws_from_a_generator():
    """Angles uniform in [-30, 30), two flip bits, all from the generator (on
    the batch's device), the same for a seed; a zero angle with no flips
    leaves the batch unchanged."""
    a = TW.draw_rot_flip(64, torch.Generator().manual_seed(3), torch.device("cpu"))
    b = TW.draw_rot_flip(64, torch.Generator().manual_seed(3), torch.device("cpu"))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    angles, vflip, hflip = a
    assert float(angles.min()) >= -30.0 and float(angles.max()) < 30.0
    assert 0 < int(vflip.sum()) < 64 and 0 < int(hflip.sum()) < 64
    imgs = torch.rand(2, 3, 8, 8, generator=torch.Generator().manual_seed(4))
    no = (torch.zeros(2), torch.zeros(2, dtype=torch.bool), torch.zeros(2, dtype=torch.bool))
    out, (m,) = TW.random_joint_rot_flip(imgs, (imgs[:, :1],), draws=no)
    assert torch.equal(out, imgs) and torch.equal(m, imgs[:, :1])
    g = torch.Generator().manual_seed(5)
    out1, _ = TW.random_joint_rot_flip(imgs, (), generator=g)
    out2, _ = TW.random_joint_rot_flip(imgs, (), draws=TW.draw_rot_flip(
        2, torch.Generator().manual_seed(5), torch.device("cpu")))
    assert torch.equal(out1, out2)
