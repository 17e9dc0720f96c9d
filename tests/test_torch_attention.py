"""The port's attention op (vaeplay_torch.ops.attention) against the JAX
package's: its plain version on the CPU at f32, in both input layouts the
kernel takes, the 3xTF32 arithmetic of the kernel emulated on the CPU, the
backward (the autograd Function's) against the JAX custom VJP's, and the
CUDA kernel on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaeplay_torch.ops import attention
from vaeplay_tpu.ops.attention import (_pallas_attention, _pallas_attention_bwd,
                                       _reference_attention)

# tests/test_attention.py's shapes, plus BP's attention at a short N,
# BCP's point attention (Dk 32, Dv 260, not a multiple of 8) at a short N,
# and BE_font's embedding blocks (one position: the output is v, and dq and
# dk are exactly 0, since a softmax over one key is constant)
SHAPES = [(2, 64, 4, 32), (2, 100, 8, 16), (2, 256, 16, 128), (2, 333, 5, 7),
          (2, 64, 90, 720), (2, 128, 32, 260), (2, 1, 32, 256)]
# position-major: a contiguous (B, N, C); channel-major: the (B, N, C)
# transpose view of a contiguous (B, C, N), as SelfAttentionBlock passes them
LAYOUTS = ["position_major", "channel_major"]


def _qkv(b, n, dk, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, dk)).astype(np.float32),
            rng.normal(size=(b, n, dk)).astype(np.float32),
            rng.normal(size=(b, n, dv)).astype(np.float32))


def _in_layout(a: np.ndarray, layout: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t if layout == "position_major" else t.transpose(1, 2).contiguous().transpose(1, 2)


# against the JAX einsum reference at f32 (1e-5), and against the Pallas
# kernel in interpret mode at full precision with test_attention.py's own 1e-3
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("against,tol", [("reference", 1e-5), ("pallas_interpret", 1e-3)])
@pytest.mark.parametrize("b,n,dk,dv", SHAPES)
def test_plain_attention_matches_jax(b, n, dk, dv, against, tol, layout):
    qn, kn, vn = _qkv(b, n, dk, dv)
    q, k, v = (_in_layout(a, layout) for a in (qn, kn, vn))
    assert n == 1 or (q.stride(2) if layout == "position_major" else q.stride(1)) == 1
    launches = attention.flash_attention.launches
    got = attention.spatial_self_attention(q, k, v)
    assert attention.flash_attention.launches == launches  # CPU: plain version
    q, k, v = jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn)
    if against == "reference":
        ref = _reference_attention(q, k, v)
    else:
        ref = _pallas_attention(q, k, v, interpret=True, full_precision=True)
    assert got.shape == (b, n, dv) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=tol)
    if n == 1:
        assert torch.equal(got, torch.from_numpy(vn))


def test_kernel_wrapper_rejects_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 4, 4))
    with pytest.raises(ValueError, match="not a CUDA device"):
        attention.flash_attention(q, k, v)


@pytest.mark.parametrize("layout,channel_major", [("position_major", False),
                                                  ("channel_major", True)])
def test_wrapper_reads_both_layouts(layout, channel_major):
    t = _in_layout(_qkv(2, 16, 6, 6)[0], layout)
    assert attention._channel_major("k", t) is channel_major


def test_wrapper_rejects_other_layouts():
    # (B, N, C) with neither the channel nor the position stride 1
    t = torch.zeros(2, 6, 16, 3).permute(0, 2, 1, 3)[..., 0]
    with pytest.raises(ValueError, match="channel stride 1 or position stride 1"):
        attention._channel_major("k", t)


@pytest.mark.parametrize("n,layout,dtype,copied", [
    (16, "channel_major", torch.float32, False),  # the model's layout: read in place
    (16, "position_major", torch.float32, True),
    (333, "channel_major", torch.float32, True),  # rows of 333 f32 are not 16-byte multiples
    (16, "channel_major", torch.bfloat16, True),  # widened to f32
    (1, "channel_major", torch.float32, True),  # N = 1: channel stride 1, rows of 4 bytes
])
def test_kernel_operand_layout(n, layout, dtype, copied):
    """flash_attention hands the kernel k and v f32, channel-major, with
    16-byte aligned rows and batches: as they are, or after one copy."""
    t = _in_layout(_qkv(2, n, 6, 6)[2], layout).to(dtype)
    got = attention._tma_operand(t)
    assert (got is not t) is copied
    assert got.dtype == torch.float32 and got.shape == t.shape and got.stride(1) == 1
    assert got.stride(2) % 4 == 0 and got.stride(0) % 4 == 0 and got.data_ptr() % 16 == 0
    torch.testing.assert_close(got, t.float(), atol=0, rtol=0)


def _tf32(x: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 as the kernel does: add half a TF32 unit (0x1000) to
    the bits and drop the 13 low bits, which the tensor cores ignore."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_product(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """a @ b with TF32 operands summed in f32: one pass (big . big), or the
    kernel's three (big . big + big . small + small . big)."""
    a_big, b_big = _tf32(a), _tf32(b)
    out = a_big @ b_big
    if passes == 3:
        out = out + (a_big @ _tf32(b - b_big) + _tf32(a - a_big) @ b_big)
    return out


@pytest.mark.parametrize("passes,within_f32_tol", [(3, True), (1, False)])
def test_tf32x3_keeps_f32_accuracy(passes, within_f32_tol):
    """Why the kernel takes three TF32 passes for f32 inputs: at BP's Dk and
    Dv the three-pass products stay within the f32 tolerance of 1e-4 of the
    JAX reference, a single TF32 pass does not."""
    qn, kn, vn = _qkv(1, 256, 90, 720)
    s = _tf32_product(qn, kn.transpose(0, 2, 1), passes)
    p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    got = _tf32_product(p, vn, passes) / p.sum(-1, keepdims=True)
    ref = np.asarray(_reference_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn)))
    assert np.allclose(got, ref, atol=1e-4, rtol=1e-4) is within_f32_tol


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_cuda_tensor_takes_the_kernel(monkeypatch, layout):
    """A CUDA tensor never reaches the plain version: the kernel launches,
    and writes a channel-major result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def plain(*args):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(attention, "reference_attention", plain)
    qn, kn, vn = _qkv(2, 333, 90, 720)
    launches = attention.flash_attention.launches
    got = attention.spatial_self_attention(
        *(_in_layout(a, layout).cuda() for a in (qn, kn, vn)))
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == launches + 1
    assert got.shape == (2, 333, 720) and got.transpose(1, 2).is_contiguous()
    ref = _reference_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def _grad_out(b, n, dv, layout, seed=1):
    g = np.random.default_rng(seed).normal(size=(b, n, dv)).astype(np.float32)
    return g, _in_layout(g, layout)


def _assert_grads_close(got, ref, tol):
    """Each of (dq, dk, dv) within tol of its largest magnitude plus tol
    relative: ds = (dp - sum(dp * attn)) * attn cancels, so an element's
    error follows its gradient's scale, not its own value."""
    for name, x, r in zip("qkv", got, ref):
        x, r = np.asarray(x.detach().cpu()), np.asarray(r)
        np.testing.assert_allclose(x, r, atol=tol * np.abs(r).max(), rtol=tol, err_msg=name)


# the recompute VJP against the JAX package's, called directly, at f32
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("b,n,dk,dv", SHAPES)
def test_attention_backward_matches_jax(b, n, dk, dv, layout):
    qn, kn, vn = _qkv(b, n, dk, dv)
    gn, g = _grad_out(b, n, dv, layout)
    got = attention.attention_backward(*(_in_layout(a, layout) for a in (qn, kn, vn)), g)
    ref = _pallas_attention_bwd(tuple(jnp.asarray(a) for a in (qn, kn, vn)), jnp.asarray(gn))
    for x, like in zip(got, (qn, kn, vn)):
        assert x.shape == like.shape and x.dtype == torch.float32
        # a channel-major input gets a channel-major gradient, which the
        # convolution behind it takes with no copy (at N = 1 the two
        # layouts are one)
        if n > 1:
            assert (x.stride(1) == 1) is (layout == "channel_major" or like.shape[2] == 1)
    _assert_grads_close(got, ref, 1e-5)
    if n == 1:
        assert not got[0].any() and not got[1].any()
        assert not np.asarray(ref[0]).any() and not np.asarray(ref[1]).any()


def test_spatial_attention_gradcheck():
    """The Function's backward against finite differences, in f64 on the CPU."""
    rng = np.random.default_rng(2)
    q, k = (torch.tensor(rng.normal(size=(2, 7, 3)), requires_grad=True) for _ in range(2))
    v = torch.tensor(rng.normal(size=(2, 7, 5)), requires_grad=True)
    assert torch.autograd.gradcheck(attention.SpatialAttention.apply, (q, k, v))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spatial_attention_grads_equal_autograd_of_plain(layout):
    """spatial_self_attention's gradients (the Function's backward) equal
    autograd through reference_attention, at BP's Dk and Dv, f32, 1e-5."""
    qn, kn, vn = _qkv(2, 100, 90, 720, seed=3)
    _, g = _grad_out(2, 100, 720, layout)

    def grads(fn):
        q, k, v = (_in_layout(a, layout).requires_grad_() for a in (qn, kn, vn))
        fn(q, k, v).backward(g)
        return q.grad, k.grad, v.grad

    _assert_grads_close(grads(attention.spatial_self_attention),
                        grads(attention.reference_attention), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_cuda_function_gradients(layout):
    """On a card the Function's forward is the kernel and its backward the
    recompute VJP; both agree with the JAX package's at f32, TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qn, kn, vn = _qkv(2, 333, 90, 720)
    gn, g = _grad_out(2, 333, 720, layout)
    q, k, v = (_in_layout(a, layout).cuda().requires_grad_() for a in (qn, kn, vn))
    with pytest.raises(RuntimeError, match="spatial_self_attention"):
        attention.flash_attention(q, k, v)  # the wrapper alone records no gradient
    launches = attention.flash_attention.launches
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = attention.spatial_self_attention(q, k, v)
        out.backward(g.cuda())
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert attention.flash_attention.launches == launches + 1
    ref_out = _reference_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    np.testing.assert_allclose(out.detach().cpu().numpy(), np.asarray(ref_out),
                               atol=1e-4, rtol=1e-4)
    ref = _pallas_attention_bwd(tuple(jnp.asarray(a) for a in (qn, kn, vn)), jnp.asarray(gn))
    _assert_grads_close((q.grad, k.grad, v.grad), ref, 1e-4)
