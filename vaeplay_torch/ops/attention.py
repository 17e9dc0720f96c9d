"""Spatial / point-set self-attention.

Port of vaeplay_tpu/ops/attention.py. Semantics (the reference's, exactly):

  attn[b, i, j] = softmax_j(q[b, i, :] . k[b, j, :])   (NO 1/sqrt(d) scaling)
  out[b, i, :]  = sum_j attn[b, i, j] * v[b, j, :]

`spatial_self_attention` runs through the `SpatialAttention` autograd
Function, whose forward sends a CPU tensor to the plain version
`reference_attention` and a CUDA tensor to the hand-written kernel
(`csrc/flash_attention.cu`, through `flash_attention`), for every N. There is
no fallback: the kernel launches or the call raises. Its backward, on either
device, is `attention_backward`: the JAX package's recompute VJP
(`_pallas_attention_bwd`) as plain f32 batched matrix products.

Shapes are (B, N, C) throughout. `flash_attention` takes each of q, k, v in
either of two layouts: position-major (channel stride 1, a contiguous
(B, N, C)) or channel-major (position stride 1, the (B, N, C) transpose view
of a contiguous (B, C, N), which is how an NCHW activation holds its
positions), in f32 or bf16. The kernel itself reads f32 with k and v
channel-major and 16-byte aligned rows, where the model leaves them; any
other k or v is brought into that form with one copy, and bf16 is widened
to f32 (exactly) and the result rounded once to bf16.

`RingRouting` (the JAX module's, :150-175) sends a position axis long enough
through the ring over a mesh's "model" ranks (parallel/ring_attention.py)
instead: a model built with the handle consults it, one built without never
rings.
"""

import ctypes
import dataclasses
from typing import Any, Optional

import torch
from torch.autograd.function import once_differentiable

from vaeplay_torch.ops import _build

MAX_DK = 128  # the kernel's limit (MAX_DK in csrc/flash_attention.cu)
_DTYPES = (torch.float32, torch.bfloat16)


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """f32, or f64 for f64 inputs (which the CPU gradient checks use)."""
    return torch.promote_types(t.dtype, torch.float32)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, N, Dk), (B, N, Dk), (B, N, Dv) -> (B, N, Dv), any
    strides. Products and softmax in f32 (f64 for f64 inputs); the result has
    v's dtype."""
    ct = _compute_dtype(q)
    energy = torch.bmm(q.to(ct), k.to(ct).transpose(1, 2))
    attn = torch.softmax(energy, dim=-1)
    return torch.bmm(attn, v.to(ct)).to(v.dtype)


def _channel_major(name: str, t: torch.Tensor) -> bool:
    """False when t's channels are contiguous, True when its positions are;
    raises for any other layout."""
    if t.stride(2) == 1 or t.shape[2] == 1:
        return False
    if t.stride(1) == 1 or t.shape[1] == 1:
        return True
    raise ValueError(f"flash_attention: {name} needs channel stride 1 or position stride 1, "
                     f"got strides {t.stride()}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is on {t.device}, not a CUDA device")
        if t.dim() != 3:
            raise ValueError(f"flash_attention: {name} must be (B, N, D), got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention: q, k, v must share one dtype and device")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} is not float32 or bfloat16")
    b, n, dk = q.shape
    if k.shape != q.shape or v.shape[:2] != (b, n):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if not (0 < dk <= MAX_DK) or n == 0 or v.shape[2] == 0 or not (0 < b <= 65535):
        raise ValueError(f"flash_attention: needs 0 < Dk <= {MAX_DK}, N > 0, Dv > 0 and "
                         f"0 < B <= 65535; got q {tuple(q.shape)}, v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _channel_major(name, t)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention: the kernel wrapper records no gradient; call "
                           "spatial_self_attention, whose autograd Function has the backward")


def _check_out(out: torch.Tensor, v: torch.Tensor) -> None:
    b, n, dv = v.shape
    if out.shape != (b, n, dv) or out.dtype != v.dtype or out.device != v.device:
        raise ValueError(f"flash_attention: out must be {(b, n, dv)} {v.dtype} on {v.device}, "
                         f"got {tuple(out.shape)} {out.dtype} on {out.device}")
    if not (out.is_contiguous() or out.transpose(1, 2).is_contiguous()):
        raise ValueError("flash_attention: out must be a contiguous (B, N, Dv) or the "
                         "transpose view of a contiguous (B, Dv, N)")


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel reads k and v: f32, position stride 1, address and
    channel and batch strides multiples of 16 bytes. t itself where it is so
    already (the model's layout), else one copy into a (B, C, N4) buffer,
    N4 the next multiple of 4, returned as its (B, N, C) view."""
    b, n, c = t.shape
    rows = (t.stride(2),) if b == 1 else (t.stride(2), t.stride(0))
    if (t.dtype == torch.float32 and t.stride(1) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and s % 4 == 0 for s in rows)):
        return t
    buf = torch.empty((b, c, -(-n // 4) * 4), dtype=torch.float32, device=t.device)
    view = buf[:, :, :n].transpose(1, 2)
    view.copy_(t)
    return view


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream and return `out`
    (by default a new contiguous (B, N, Dv)). CUDA tensors only; raises on
    anything the kernel does not take. `flash_attention.launches` counts the
    launches."""
    _check(q, k, v)
    b, n, dk = q.shape
    dv = v.shape[2]
    if out is None:
        out = torch.empty((b, n, dv), dtype=v.dtype, device=v.device)
    else:
        _check_out(out, v)
    q32, k32, v32 = q.float(), _tma_operand(k), _tma_operand(v)
    res = out if out.dtype == torch.float32 else torch.empty_strided(
        out.shape, out.stride(), dtype=torch.float32, device=out.device)
    lib = _build.load("flash_attention")
    strides = (ctypes.c_longlong * 12)(*q32.stride(), *k32.stride(), *v32.stride(), *res.stride())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q32.data_ptr(), k32.data_ptr(), v32.data_ptr(), res.data_ptr(),
            b, n, dk, dv, strides, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    if res is not out:
        out.copy_(res)
    return out


flash_attention.launches = 0


def _bmm_like(like: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the layout of `like`: where `like` is channel-major, computed
    as (bᵀ aᵀ)ᵀ, so the result is the transpose view of a contiguous
    (B, C, N) and the NCHW convolution behind it takes its gradient with no
    copy."""
    if like.stride(2) != 1 and like.stride(1) == 1:
        return torch.bmm(b.transpose(1, 2), a.transpose(1, 2)).transpose(1, 2)
    return torch.bmm(a, b)


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       g: torch.Tensor):
    """(dq, dk, dv) of reference_attention at (q, k, v) for the output
    gradient g, recomputing the softmax rather than saving it: the plain
    counterpart of the JAX package's `_pallas_attention_bwd`. Products in f32
    (f64 for f64 inputs) with torch.bmm on any strides; each gradient has its
    input's dtype and, where that input is channel-major, its layout."""
    ct = _compute_dtype(q)
    qc, kc, vc, gc = q.to(ct), k.to(ct), v.to(ct), g.to(ct)
    attn = torch.softmax(torch.bmm(qc, kc.transpose(1, 2)), dim=-1)  # (B, N, N)
    dv = _bmm_like(v, attn.transpose(1, 2), gc)
    ds = torch.bmm(gc, vc.transpose(1, 2))                           # dp
    ds.sub_((ds * attn).sum(dim=-1, keepdim=True)).mul_(attn)        # in place: one N x N less
    dq = _bmm_like(q, ds, kc)
    dk = _bmm_like(k, ds.transpose(1, 2), qc)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class SpatialAttention(torch.autograd.Function):
    """softmax(q kᵀ) v with the kernel's forward on a CUDA tensor, the plain
    version on a CPU tensor, and `attention_backward` on both. The forward
    saves only q, k and v. Under a bf16 autocast the plain version still
    computes in f32, as the kernel does with bf16 operands."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            with torch.autocast("cpu", enabled=False):  # f32 products, as the kernel's
                return reference_attention(q, k, v)
        b, n, dv = v.shape
        out = torch.empty((b, dv, n), dtype=v.dtype, device=v.device).transpose(1, 2)
        return flash_attention(q, k, v, out=out)

    @staticmethod
    @once_differentiable  # attention_backward works in place on its N x N buffers
    def backward(ctx, g: torch.Tensor):
        return attention_backward(*ctx.saved_tensors, g)


@dataclasses.dataclass(frozen=True)
class RingRouting:
    """The ring (context-parallel) attention handle, threaded through a
    model's constructor down to its attention blocks (bcp.ComposeNet(ring=)):
    there is no global routing state. When `mesh` has >= 2 ranks on `axis`
    and the position axis N >= min_n divides by their number,
    spatial_self_attention runs the ring over them (the JAX rule)."""

    mesh: Any = None
    axis: str = "model"
    min_n: int = 1024

    def active(self, n: int) -> bool:
        """Whether a position axis of size n routes through the ring."""
        if self.mesh is None or self.axis not in (self.mesh.mesh_dim_names or ()):
            return False
        n_dev = self.mesh.size(self.mesh.mesh_dim_names.index(self.axis))
        return n_dev >= 2 and n >= self.min_n and n % n_dev == 0


def spatial_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           ring: Optional[RingRouting] = None) -> torch.Tensor:
    """Unscaled softmax attention over flattened spatial (or point) positions,
    differentiable through `SpatialAttention`.

    q, k: (B, N, Dk); v: (B, N, Dv), each position-major or channel-major.
    Returns (B, N, Dv). A CPU tensor takes the plain version; a CUDA tensor
    takes the kernel, which writes a channel-major result: the (B, N, Dv)
    transpose view of a contiguous (B, Dv, N). With a `ring` active for N,
    the ring over its mesh axis runs instead (every rank of the axis holds
    q, k and v whole) and the result is position-major."""
    if ring is not None and ring.active(q.shape[1]):
        from vaeplay_torch.parallel.ring_attention import replicated_ring_attention

        return replicated_ring_attention(q, k, v, ring.mesh, ring.axis)
    return SpatialAttention.apply(q, k, v)
