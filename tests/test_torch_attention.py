"""The port's attention op (vaeplay_torch.ops.attention) against the JAX
package's: its plain version on the CPU at f32 and with bf16 operands, in
both input layouts the kernels take, the wrapper's choice of how each
kernel reads k and v, the arithmetic of both kernels (3xTF32, and bf16 with
P rounded against the running max) emulated on the CPU, the backward (the
autograd Function's) against the JAX custom VJP's, and the CUDA kernels on
a card."""

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


# BP's attention at a short N, RefineNet's N 258 and BE_font's N 1, narrow Dv
BF16_SHAPES = [(2, 100, 90, 72), (2, 258, 32, 64), (2, 1, 32, 64)]
# bf16 operands, the plain version against JAX's _reference_attention: both
# compute the scores and softmax in f32 from the same bf16 values, round the
# probabilities to bf16 and sum P.V in f32, so they differ by summation
# order, which can move a result across one bf16 rounding: one ulp, 2^-7
# relative at most. Against the interpreted Pallas kernel at its default
# bf16 instantiation: its blocks round P against other running maxima, 1e-2
# of the output's max plus 1e-2 relative.
BF16_AGAINST = [("reference", 0.0, 2.0 ** -7), ("pallas_interpret", 1e-2, 1e-2)]


def _bf16_np(x: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 (nearest, ties to even), kept in f32."""
    bits = x.astype(np.float32).view(np.uint32)
    bits = bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    return (bits & np.uint32(0xFFFF0000)).view(np.float32)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("against,atol,rtol", BF16_AGAINST)
@pytest.mark.parametrize("b,n,dk,dv", BF16_SHAPES)
def test_plain_attention_bf16_matches_jax(b, n, dk, dv, against, atol, rtol, layout):
    qn, kn, vn = (_bf16_np(a) for a in _qkv(b, n, dk, dv))
    q, k, v = (_in_layout(a, layout).bfloat16() for a in (qn, kn, vn))
    got = attention.spatial_self_attention(q, k, v)
    assert got.shape == (b, n, dv) and got.dtype == torch.bfloat16
    q, k, v = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (qn, kn, vn))
    if against == "reference":
        ref = _reference_attention(q, k, v)
    else:
        ref = _pallas_attention(q, k, v, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol * np.abs(ref).max(), rtol=rtol)
    if n == 1:  # a softmax over one key is 1: the output is v
        assert np.array_equal(got.float().numpy(), vn)


@pytest.mark.parametrize("n,layout,dtype,route,copied", [
    (16, "channel_major", torch.float32, "tma", False),  # the model's layout: read in place
    (16, "position_major", torch.float32, "tma", True),  # copied into the TMA's form
    (333, "channel_major", torch.float32, "direct", False),  # rows of 1332 bytes
    (16, "channel_major", torch.bfloat16, "tma", False),  # bf16 read in place, not widened
    (1, "channel_major", torch.float32, "direct", False),  # N = 1: rows of 4 bytes
    (2048, "channel_major", torch.bfloat16, "tma", False),  # BP's and BCP's N in bf16
    (258, "channel_major", torch.bfloat16, "direct", False),  # BC's N in bf16: rows of 516 bytes
    (1, "channel_major", torch.bfloat16, "direct", False),  # BE_font's N = 1 in bf16
    (16, "misaligned", torch.float32, "direct", False),  # a base address off 16 bytes
])
def test_kernel_operand_layout(n, layout, dtype, route, copied):
    """flash_attention's choice of how the kernel reads k and v: by the TMA
    engine where they are channel-major with 16-byte aligned rows, batches
    and address; by the threads' direct loads, in place, where they are not;
    one copy into the TMA's form only for a position-major operand."""
    a = _qkv(2, n, 6, 6)[2]
    if layout == "misaligned":  # channel-major, one element into its buffer
        buf = torch.zeros(2 * 6 * n + 1, dtype=dtype)
        t = buf[1:].view(2, 6, n).transpose(1, 2).copy_(torch.from_numpy(a))
    else:
        t = _in_layout(a, layout).to(dtype)
    before = attention.flash_attention.copied_bytes
    k, v, got = attention.kernel_operands(t, t)
    assert got == route and attention.operand_route(t) == ("copy" if copied else route)
    assert (k is not t) is copied and (v is not t) is copied
    assert (attention.flash_attention.copied_bytes > before) is copied
    assert k.dtype == dtype and k.shape == t.shape
    if route == "tma":  # position stride 1, 16-byte rows, batches and address
        size = k.element_size()
        assert k.stride(1) == 1 or n == 1
        assert k.stride(2) * size % 16 == 0 and k.stride(0) * size % 16 == 0
        assert k.data_ptr() % 16 == 0
    torch.testing.assert_close(k, t, atol=0, rtol=0)


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


def _bf16_kernel_emulation(q: np.ndarray, k: np.ndarray, v: np.ndarray, bk: int = 64):
    """The bf16 kernel's tiled arithmetic in numpy (csrc/flash_attention_bf16.cu):
    scores of bf16 operands in f32, over key tiles of bk the running max m
    and sum l of P = exp(S - m) in f32, P rounded to bf16 for P.V summed in
    f32, the result acc / l rounded once to bf16."""
    q, k, v = (_bf16_np(a).astype(np.float32) for a in (q, k, v))
    s = q @ k.transpose(0, 2, 1)
    m = np.full(s.shape[:2] + (1,), -1e30, np.float32)
    l = np.zeros_like(m)
    acc = np.zeros(q.shape[:2] + (v.shape[2],), np.float32)
    for k0 in range(0, s.shape[2], bk):
        st = s[:, :, k0:k0 + bk]
        m_new = np.maximum(m, st.max(-1, keepdims=True))
        p = np.exp(st - m_new).astype(np.float32)
        alpha = np.exp(m - m_new).astype(np.float32)
        l = alpha * l + p.sum(-1, keepdims=True)
        acc = acc * alpha + _bf16_np(p) @ v[:, k0:k0 + bk]
        m = m_new
    return _bf16_np(acc / l)


@pytest.mark.parametrize("b,n,dk,dv", [(1, 256, 90, 720), (2, 258, 32, 64)])
def test_bf16_kernel_arithmetic_matches_plain(b, n, dk, dv):
    """The bf16 kernel rounds P against the running max of its key tiles;
    the plain version rounds the normalised softmax. Both round one
    probability to bf16 (2^-9 relative) and the output once, so they agree
    within one output ulp plus 2^-8 of the output's max."""
    qn, kn, vn = _qkv(b, n, dk, dv)
    got = _bf16_kernel_emulation(qn, kn, vn)
    ref = attention.reference_attention(
        *(torch.from_numpy(a).bfloat16() for a in (qn, kn, vn))).float().numpy()
    np.testing.assert_allclose(got, ref, atol=2.0 ** -8 * np.abs(ref).max(), rtol=2.0 ** -7)


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,dk,dv,route", [(2, 2048, 90, 720, "tma"), (2, 258, 32, 256, "direct"),
                                             (2, 1, 32, 256, "direct")])
def test_cuda_bf16_kernel(b, n, dk, dv, route):
    """bf16 operands in the model's layout take the bf16 kernel by the route
    their N gives, with no copy, and write bf16 that agrees with the plain
    version of the same arithmetic within 1e-2 plus 1e-2 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qn, kn, vn = _qkv(b, n, dk, dv)
    q, k, v = (torch.from_numpy(a).cuda().bfloat16().transpose(1, 2).contiguous().transpose(1, 2)
               for a in (qn, kn, vn))
    attention.reset_counts()
    got = attention.spatial_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention.routes[f"bfloat16/{route}"] == 1
    assert attention.flash_attention.copied_bytes == 0 and got.dtype == torch.bfloat16
    ref = attention.reference_attention(q, k, v)
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2, rtol=1e-2)


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
