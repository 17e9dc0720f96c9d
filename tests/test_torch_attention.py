"""The port's attention op (vaeplay_torch.ops.attention) against the JAX
package's: its plain version on the CPU at f32, and the CUDA kernel on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaeplay_torch.ops import attention
from vaeplay_tpu.ops.attention import _pallas_attention, _reference_attention

# tests/test_attention.py's shapes, plus BP's attention at a short N
SHAPES = [(2, 64, 4, 32), (2, 100, 8, 16), (2, 256, 16, 128), (2, 333, 5, 7),
          (2, 64, 90, 720)]


def _qkv(b, n, dk, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, dk)).astype(np.float32),
            rng.normal(size=(b, n, dk)).astype(np.float32),
            rng.normal(size=(b, n, dv)).astype(np.float32))


# against the JAX einsum reference at f32 (1e-5), and against the Pallas
# kernel in interpret mode at full precision with test_attention.py's own 1e-3
@pytest.mark.parametrize("against,tol", [("reference", 1e-5), ("pallas_interpret", 1e-3)])
@pytest.mark.parametrize("b,n,dk,dv", SHAPES)
def test_plain_attention_matches_jax(b, n, dk, dv, against, tol):
    qn, kn, vn = _qkv(b, n, dk, dv)
    launches = attention.flash_attention.launches
    got = attention.spatial_self_attention(
        torch.from_numpy(qn), torch.from_numpy(kn), torch.from_numpy(vn))
    assert attention.flash_attention.launches == launches  # CPU: plain version
    q, k, v = jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn)
    if against == "reference":
        ref = _reference_attention(q, k, v)
    else:
        ref = _pallas_attention(q, k, v, interpret=True, full_precision=True)
    assert got.shape == (b, n, dv) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=tol)


def test_kernel_wrapper_rejects_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 4, 4))
    with pytest.raises(ValueError, match="not a CUDA device"):
        attention.flash_attention(q, k, v)


@pytest.mark.cuda
def test_cuda_tensor_takes_the_kernel(monkeypatch):
    """A CUDA tensor never reaches the plain version: the kernel launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def plain(*args):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(attention, "reference_attention", plain)
    qn, kn, vn = _qkv(2, 333, 90, 720)
    launches = attention.flash_attention.launches
    got = attention.spatial_self_attention(
        *(torch.from_numpy(a).cuda() for a in (qn, kn, vn)))
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == launches + 1
    ref = _reference_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
