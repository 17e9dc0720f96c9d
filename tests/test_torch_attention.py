"""The port's attention op (vaeplay_torch.ops.attention) against the JAX
package's: its plain version on the CPU at f32 and with bf16 operands, in
both input layouts the kernels take, the wrapper's choice of how each
kernel reads k and v, the arithmetic of both forward kernels (3xTF32, and
bf16 with P rounded against the running max) and of the backward kernel
emulated on the CPU, the log-sum-exp the forward kernels write, the
backward (the autograd Function's) against the JAX custom VJP's, and the
CUDA kernels on a card (the backward kernel's own card tests, which import
no JAX, are tests/test_torch_attention_cuda.py)."""

import jax
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


def _bwd_kernel_emulation(q, k, v, g, out, passes: int, bk: int = 128, flags: bool = True):
    """The backward kernel's arithmetic in numpy (csrc/flash_attention_bwd.cu):
    the row log-sum-exp and one-hot flags as the forward leaves them, delta =
    sum_c g out in f32 from `out` as the forward leaves it, then over key
    tiles of bk: P recomputed from the log-sum-exp (at most 1; for dV in a
    one-hot row with the log-sum-exp lowered by T = 2^-19 |lse| + 2^-12, the
    recomputation's rounding: 1 at its max), dS 0 in a one-hot row, and
    every product (S, dV, dP, dK, dQ) as `passes`
    TF32 passes summed in f32 (_tf32_product). With 3 passes that is the
    kernel's 3xTF32 for f32 operands; for bf16 operands, exact in TF32, the
    passes with a zero small part add nothing, which leaves the kernel's one
    pass for S and dP and two for dV, dK and dQ (P and dS split). flags=False
    leaves the one-hot flags out (P from the log-sum-exp alone)."""
    lse, onehot = attention.reference_lse(torch.from_numpy(q), torch.from_numpy(k)).numpy()
    onehot = (onehot != 0)[..., None] & flags
    lift = np.where(onehot, (2.0 ** -19 * np.abs(lse) + 2.0 ** -12)[..., None], 0)
    delta = (g * out).sum(-1, dtype=np.float32)[..., None]
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for k0 in range(0, q.shape[1], bk):
        kt, vt = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
        x = _tf32_product(q, kt.transpose(0, 2, 1), passes) - lse[..., None]
        p = np.exp(np.minimum(x + lift, 0), dtype=np.float32)
        dv[:, k0:k0 + bk] = _tf32_product(p.transpose(0, 2, 1), g, passes)
        ds = np.where(onehot, 0, p * (_tf32_product(g, vt.transpose(0, 2, 1), passes) - delta))
        ds = ds.astype(np.float32)
        dk[:, k0:k0 + bk] = _tf32_product(ds.transpose(0, 2, 1), q, passes)
        dq += _tf32_product(ds, kt, passes)
    return dq, dk, dv


# BP's Dk and Dv at a short N, and BC's ragged N 258 (a key tile of 2)
@pytest.mark.parametrize("b,n,dk,dv", [(1, 256, 90, 720), (2, 258, 32, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("passes,within", [(3, True), (1, False)])
def test_bwd_kernel_arithmetic_matches_plain(b, n, dk, dv, dtype, passes, within):
    """The backward kernel's passes keep f32 accuracy: its emulation is within
    1e-5 of attention_backward (of each gradient's largest magnitude, plus
    1e-5 relative) and of the JAX package's _pallas_attention_bwd (in f32 on
    the same values); one TF32 pass a product misses even the card's 1e-4
    (GRAD_TOL). With bf16 operands the kernel takes delta from the forward's
    bf16 output (P rounded to bf16, the result rounded once), where both
    references compute the output in f32: dq and dk, which delta reaches,
    then lie 3.6e-3 to 5.1e-3 from them here and are held at the card's
    bf16 tolerance of 1e-2; dv is held at 1e-5; and with delta from the f32
    output the bf16 passes are within 1e-5 on all three."""
    qn, kn, vn = _qkv(b, n, dk, dv)
    gn = _grad_out(b, n, dv, "position_major")[0]
    if dtype == "bfloat16":  # bf16 values, computed on in f32
        qn, kn, vn, gn = (_bf16_np(a) for a in (qn, kn, vn, gn))
    out = attention.reference_attention(*(torch.from_numpy(a) for a in (qn, kn, vn))).numpy()
    refs = [attention.attention_backward(*(torch.from_numpy(a) for a in (qn, kn, vn, gn))),
            _pallas_attention_bwd(tuple(jnp.asarray(a) for a in (qn, kn, vn)), jnp.asarray(gn))]
    tols = (1e-5, 1e-5, 1e-5)
    if dtype == "bfloat16":
        if within:  # the products alone: delta from the f32 output
            alone = [torch.from_numpy(x) for x in _bwd_kernel_emulation(qn, kn, vn, gn, out, 3)]
            for ref in refs:
                _assert_grads_close(alone, ref, 1e-5)
        out, tols = _bf16_kernel_emulation(qn, kn, vn), (1e-2, 1e-2, 1e-5)
    got = [torch.from_numpy(x) for x in _bwd_kernel_emulation(qn, kn, vn, gn, out, passes)]
    for ref in refs:
        if within:
            _assert_grads_close(got, ref, tols)
        else:  # the gradients held at 1e-5: one pass misses 1e-4 on one at least
            with pytest.raises(AssertionError):
                _assert_grads_close(*([x for x, t in zip(seq, tols) if t == 1e-5]
                                      for seq in (got, ref)), 1e-4)


# q = k = scale x unit rows: S's max is each row's own key, the others at
# least 0.4 scale^2 below, so every row of softmax(S) is one-hot in f32; at
# scale 30 |S| is 900, at 3000 9e6, where 3xTF32 rounds S by about 4
@pytest.mark.parametrize("scale", [30.0, 3000.0])
def test_bwd_kernel_one_hot_rows(scale):
    """Where every row is one-hot the plain backward's dq and dk are exactly 0
    (delta = sum_j P dP is then the max's dP itself) and its dv is g. The
    kernel's emulation, with the forward's one-hot flags, gives the same: dq
    and dk exactly 0, dv within 1e-5. Without them (P from the log-sum-exp
    alone), delta = g . out and dP, computed apart, differ by their rounding,
    and that times k is a gradient where there is none."""
    rng = np.random.default_rng(5)
    u = rng.normal(size=(2, 256, 90))
    qn = kn = (scale * u / np.linalg.norm(u, axis=-1, keepdims=True)).astype(np.float32)
    vn, gn = (rng.normal(size=(2, 256, 64)).astype(np.float32) for _ in range(2))
    ref = attention.attention_backward(*(torch.from_numpy(a) for a in (qn, kn, vn, gn)))
    assert not ref[0].any() and not ref[1].any() and torch.equal(ref[2], torch.from_numpy(gn))
    lse = attention.reference_lse(torch.from_numpy(qn), torch.from_numpy(kn))
    assert bool((lse[1] == 1).all())
    out = attention.reference_attention(*(torch.from_numpy(a) for a in (qn, kn, vn))).numpy()
    dq, dk, dv = _bwd_kernel_emulation(qn, kn, vn, gn, out, 3)
    assert not dq.any() and not dk.any()
    np.testing.assert_allclose(dv, gn, atol=1e-5 * np.abs(gn).max(), rtol=1e-5)
    dq, dk, _ = _bwd_kernel_emulation(qn, kn, vn, gn, out, 3, flags=False)
    assert dq.any() and dk.any()


@pytest.mark.parametrize("b,n,dk", [(1, 256, 90), (2, 258, 32), (2, 1, 32)])
def test_reference_lse_is_the_forward_statistics(b, n, dk):
    """reference_lse, the plain version of what the forward kernels write for
    the backward, is the log-sum-exp of the unscaled scores: the kernels'
    running max m and sum l of exp(S - m) over key tiles give m + log(l),
    and JAX's logsumexp of the same scores agrees; and the one-hot flag,
    1 where l is within ONE_HOT of 1 (always at N = 1)."""
    qn, kn, _ = _qkv(b, n, dk, 4)
    both = attention.reference_lse(torch.from_numpy(qn), torch.from_numpy(kn)).numpy()
    assert both.shape == (2, b, n) and both.dtype == np.float32
    got, onehot = both
    s = qn @ kn.transpose(0, 2, 1)
    m = np.full(s.shape[:2], -1e30, np.float32)
    l = np.zeros_like(m)
    for k0 in range(0, n, 32):  # the f32 kernel's key tiles
        m_new = np.maximum(m, s[:, :, k0:k0 + 32].max(-1))
        l = l * np.exp(m - m_new) + np.exp(s[:, :, k0:k0 + 32] - m_new[..., None]).sum(-1)
        m = m_new
    np.testing.assert_allclose(got, m + np.log(l), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax.nn.logsumexp(jnp.asarray(s), axis=-1)),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(onehot, (l <= 1 + attention.ONE_HOT).astype(np.float32))
    assert n > 1 or onehot.all()


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
    """Each of (dq, dk, dv) within tol (one for all, or one each) of its
    largest magnitude plus tol relative: ds = (dp - sum(dp * attn)) * attn
    cancels, so an element's error follows its gradient's scale, not its own
    value."""
    tols = tol if isinstance(tol, tuple) else (tol,) * len(got)
    for name, x, r, t in zip("qkv", got, ref, tols):
        x, r = np.asarray(x.detach().cpu().float()), np.asarray(r, dtype=np.float32)
        np.testing.assert_allclose(x, r, atol=t * np.abs(r).max(), rtol=t, err_msg=name)


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


# f32 at BP's Dk and Dv (ragged N 333); bf16 there and at BC's N 258, held
# at the bf16 tolerance of 1e-2: the kernel's delta comes from the bf16
# output (test_bwd_kernel_arithmetic_matches_plain) and each gradient is
# rounded once to bf16
@pytest.mark.cuda
@pytest.mark.parametrize("b,n,dk,dv,dtype,tol", [
    (2, 333, 90, 720, torch.float32, 1e-4), (2, 333, 90, 720, torch.bfloat16, 1e-2),
    (2, 258, 32, 256, torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_cuda_function_gradients(layout, b, n, dk, dv, dtype, tol):
    """On a card the Function's forward and backward are the kernels; both
    agree with the JAX package's (in f32 on the same values, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qn, kn, vn = _qkv(b, n, dk, dv)
    gn = _grad_out(b, n, dv, layout)[0]
    if dtype == torch.bfloat16:  # bf16 values, the JAX side on them in f32
        qn, kn, vn, gn = (_bf16_np(a) for a in (qn, kn, vn, gn))
    q, k, v = (_in_layout(a, layout).to("cuda", dtype).requires_grad_() for a in (qn, kn, vn))
    g = _in_layout(gn, layout).to("cuda", dtype)
    with pytest.raises(RuntimeError, match="spatial_self_attention"):
        attention.flash_attention(q, k, v)  # the wrapper alone records no gradient
    launches = attention.flash_attention.launches
    bwd_launches = attention.flash_attention_backward.launches
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = attention.spatial_self_attention(q, k, v)
        out.backward(g)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert attention.flash_attention.launches == launches + 1
    assert attention.flash_attention_backward.launches == bwd_launches + 1
    assert all(t.grad.dtype == dtype for t in (q, k, v))
    ref_out = _reference_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    np.testing.assert_allclose(out.detach().float().cpu().numpy(), np.asarray(ref_out),
                               atol=tol, rtol=tol)
    ref = _pallas_attention_bwd(tuple(jnp.asarray(a) for a in (qn, kn, vn)), jnp.asarray(gn))
    _assert_grads_close((q.grad, k.grad, v.grad), ref, tol)
