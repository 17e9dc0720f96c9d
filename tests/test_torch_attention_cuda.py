"""The attention backward kernel (vaeplay_torch/ops/csrc/flash_attention_bwd.cu)
on a card, held against the plain `attention_backward` on the same CUDA
tensors: every shape chip_smoke.py phase 2 holds, both dtypes, both input
layouts (and with them both of the forward's routes), the gradients'
layouts, the launch counts of a BP training step and the backward's memory.
Imports no JAX; every test carries the `cuda` marker and skips without a
card. On a card:

    python -m pytest tests/test_torch_attention_cuda.py --noconftest -m cuda
"""

import pytest
import torch

from vaeplay_torch.ops import attention

# of each gradient's largest magnitude, plus relative: f32 as chip_smoke.py's
# GRAD_TOL (both sides compute in f32, in other orders); bf16 as its
# BF16_ATTENTION_TOL (both sides round each gradient to bf16 once)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# (B, N, Dk, Dv): BP at B 4 and 8 (TMA route in the forward), BCP's point
# attention and its 4096 cap, BC's N 258 and BE_font's N 1 (direct route)
SHAPES = [(4, 2048, 90, 720), (8, 2048, 90, 720), (16, 2048, 32, 260), (16, 4096, 32, 260),
          (32, 258, 32, 256), (32, 1, 32, 256)]
# the kernel's edges: Dk 128 and 100 (four Dk chunks; at 128 the dK/dQ
# kernel's ring has one slot), Dv 7 and 33 (one value chunk), N 2049 and 333
# (ragged key and query tiles)
EDGES = [(2, 300, 128, 200), (2, 333, 100, 7), (1, 2049, 90, 33)]
LAYOUTS = ["position_major", "channel_major"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain side in f32
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = saved


def _inputs(shape, dtype, layout, seed=0):
    """q, k, v and the output gradient g on the card, in `layout`
    (channel-major: the (B, N, C) transpose view of a contiguous (B, C, N))."""
    b, n, dk, dv = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for c in (dk, dk, dv, dv):
        t = torch.randn(b, n, c, generator=gen, device="cuda").to(dtype)
        if layout == "channel_major":
            t = t.transpose(1, 2).contiguous().transpose(1, 2)
        out.append(t)
    return out


def _worst(got, ref, tol):
    """Largest |got - ref| over atol x max |ref| + rtol x |ref|; above 1 fails."""
    got, ref = got.float(), ref.float()
    bound = tol[0] * float(ref.abs().max()) + tol[1] * ref.abs()
    return float(((got - ref).abs() / bound.clamp(min=1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES + EDGES)
def test_cuda_backward_kernel(card, shape, dtype, layout):
    """SpatialAttention's backward on CUDA tensors launches the kernel once and
    gives attention_backward's gradients, in each input's dtype and layout."""
    q, k, v, g = _inputs(shape, dtype, layout)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    launches = attention.flash_attention_backward.launches
    attention.spatial_self_attention(qg, kg, vg).backward(g)
    torch.cuda.synchronize()
    assert attention.flash_attention_backward.launches == launches + 1
    ref = attention.attention_backward(q, k, v, g)
    for name, t, got, r in zip("qkv", (q, k, v), (qg.grad, kg.grad, vg.grad), ref):
        assert got.dtype == dtype and got.shape == t.shape, name
        if shape[1] > 1:  # a channel-major input gets a channel-major gradient
            assert (got.stride(1) == 1) == (layout == "channel_major"), name
        assert bool(torch.isfinite(got).all()), name
        assert _worst(got, r, TOL[dtype]) <= 1, name
    if shape[1] == 1:  # a softmax over one key: no score gradient
        assert not qg.grad.any() and not kg.grad.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_of_a_sum(card, dtype):
    """The output gradient of out.sum() has every stride 0; the kernel reads
    it as it is and gives attention_backward's gradients."""
    shape = (2, 333, 90, 720)
    q, k, v, _ = _inputs(shape, dtype, "channel_major")
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    attention.spatial_self_attention(qg, kg, vg).sum().backward()
    torch.cuda.synchronize()
    g = torch.ones((), dtype=dtype, device=card).expand(shape[0], shape[1], shape[3])
    for t, got, r in zip((q, k, v), (qg.grad, kg.grad, vg.grad),
                         attention.attention_backward(q, k, v, g)):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        assert _worst(got, r, TOL[dtype]) <= 1


# q = k = scale x unit rows at BP's shape: each row's max is its own key,
# the others far below, so every row of softmax(S) is one-hot; |S| of 900
# and of 9e6, where the recomputed scores round by about 4 (as BP's unscaled
# scores reach once training grows q and k)
@pytest.mark.cuda
@pytest.mark.parametrize("scale", [30.0, 3000.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_one_hot_rows(card, dtype, scale):
    """Where every row is one-hot the forward flags each row and the backward
    gives the plain one's gradients: dq and dk exactly 0, dv = g."""
    b, n, dk, dv = 2, 2048, 90, 720
    _, _, v, g = _inputs((b, n, dk, dv), dtype, "channel_major", seed=3)
    u = torch.randn(b, n, dk, generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda")
    q = (scale * u / u.norm(dim=-1, keepdim=True)).to(dtype)
    q = q.transpose(1, 2).contiguous().transpose(1, 2)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, q, v))
    attention.spatial_self_attention(qg, kg, vg).backward(g)
    lse = torch.empty((2, b, n), device=card)
    attention.flash_attention(q, q, v, lse=lse)
    torch.cuda.synchronize()
    ref = attention.attention_backward(q, q, v, g)
    assert not ref[0].any() and not ref[1].any()
    assert bool((lse[1] == 1).all())
    assert not qg.grad.any() and not kg.grad.any()
    assert _worst(vg.grad, ref[2], TOL[dtype]) <= 1


@pytest.mark.cuda
def test_cuda_backward_holds_no_n_by_n(card):
    """Across the backward at BP's training shape, the device memory peaks
    less than one (B, N, N) f32 buffer above what it held before (the plain
    backward makes two such buffers)."""
    b, n, dk, dv = SHAPES[1]
    q, k, v, g = _inputs(SHAPES[1], torch.float32, "channel_major")
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = attention.spatial_self_attention(qg, kg, vg)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out.backward(g)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < b * n * n * 4


@pytest.mark.cuda
def test_cuda_bp_training_step_launches(card):
    """One BP training step at batch 8 (512 px, full width) launches the
    forward kernel and the backward kernel 18 times each: 9 attention blocks
    a forward, two passes."""
    from vaeplay_torch.cli import train_bp
    from vaeplay_torch.data.bp_data import SyntheticEmitDataset
    from vaeplay_torch.models.bp import ComposeNet
    from vaeplay_torch.train.state import TrainState, step_lr_every_two_epochs
    from vaeplay_torch.train.steps_bp import make_bp_train_step
    from vaeplay_torch.utils.amp import resolve_dtype

    model = ComposeNet(image_size=512, generator=torch.Generator().manual_seed(0)).to(card)
    state = TrainState.create(model, 1e-3, step_lr_every_two_epochs(500))
    step = make_bp_train_step(model, resolve_dtype("float32"))
    batch = SyntheticEmitDataset(img_size=512).sample_batch(8, batch_seed=0)
    attention.reset_counts()
    state, metrics = step(state, *train_bp.to_device(batch, card))
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == 18
    assert attention.flash_attention_backward.launches == 18
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
