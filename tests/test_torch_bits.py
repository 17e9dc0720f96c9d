"""The port's bit packing (vaeplay_torch.ops.bits) against the JAX package's
pack_mask_bits (models/bc.py) and unpack_mask_bits (train/steps_bc.py), at
ragged widths: the packed bytes equal, and each side unpacks the other's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaeplay_torch.ops.bits import pack_mask_bits, unpack_mask_bits
from vaeplay_tpu.models.bc import pack_mask_bits as jax_pack
from vaeplay_tpu.train.steps_bc import unpack_mask_bits as jax_unpack

WIDTHS = [1, 7, 8, 9, 64]


def _mask(w, seed=0, shape=(3, 5)):
    return (np.random.default_rng(seed + w).uniform(size=shape + (w,)) < 0.5).astype(np.uint8)


@pytest.mark.parametrize("w", WIDTHS)
def test_pack_equals_jax(w):
    """(B, H, W) {0, 1} -> (B, H, ceil(W / 8)) uint8, byte for byte JAX's,
    from uint8 and from bool input."""
    m = _mask(w)
    want = np.asarray(jax_pack(jnp.asarray(m)))
    got = pack_mask_bits(torch.from_numpy(m))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, 5, (w + 7) // 8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pack_mask_bits(torch.from_numpy(m).bool()).numpy(), want)


@pytest.mark.parametrize("w", WIDTHS)
def test_unpack_round_trip_and_matches_jax(w):
    """unpack(pack(m)) is m as float32 {0, 1}, and equals JAX's unpack of
    JAX's packing."""
    m = _mask(w, seed=1)
    got = unpack_mask_bits(pack_mask_bits(torch.from_numpy(m)).numpy(), w)
    assert got.dtype == np.float32 and got.shape == m.shape
    np.testing.assert_array_equal(got, m.astype(np.float32))
    np.testing.assert_array_equal(got, jax_unpack(jax_pack(jnp.asarray(m)), w))


def test_msb_first_order():
    """Pixel 0 of a row is the most significant bit: np.unpackbits' order."""
    row = np.zeros((1, 1, 9), np.uint8)
    row[0, 0, 0] = row[0, 0, 8] = 1
    np.testing.assert_array_equal(pack_mask_bits(torch.from_numpy(row)).numpy(),
                                  [[[128, 128]]])
