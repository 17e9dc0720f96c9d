"""Ring attention -- port of vaeplay_tpu/parallel/ring_attention.py: the
unscaled softmax attention of ops/attention.py with its position axis split
over the "model" ranks of a mesh (context parallelism for BCP's point
attention, up to 4096 points).

Each rank holds an N/d slice of q, k and v. The key/value slices rotate
around the ring, rank i sending to rank i + 1 (`dist.batch_isend_irecv`,
the next slice in flight while this one is used), and each rank carries its
queries' online-softmax state (m, l, acc) in f32, as the JAX `_ring_body`
(:35-69) does; `_ring_step` is one block of that loop.

JAX gets the backward by differentiating `scan` and `ppermute`; torch has no
differentiable send and receive, so `RingAttention.backward` runs the reverse
ring itself: each rank recomputes every block's probabilities from its saved
log-sum-exp, keeps dq, and passes the dk and dv partials around with their
key/value block until they reach the block's owner (`_ring_grad_step` is one
block of it). The ring is plain torch (`torch.bmm`), as the JAX body is
einsums, not Pallas: it launches no hand-written kernel.
"""

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable
from torch.distributed.device_mesh import DeviceMesh

_NEG_INF = -1e30  # the JAX ring's initial row max


def _ring_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, m: torch.Tensor,
               l: torch.Tensor, acc: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One key/value block into the online-softmax state (the JAX `step`):
    q (B, n, Dk), k (B, nb, Dk), v (B, nb, Dv), m and l (B, n), acc (B, n, Dv),
    all in one float dtype; returns the new (m, l, acc)."""
    s = torch.bmm(q, k.transpose(1, 2))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    return m_new, alpha * l + p.sum(dim=-1), acc * alpha[..., None] + torch.bmm(p, v)


def _ring_grad_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                    lse: torch.Tensor, delta: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One key/value block of the backward: the block's probabilities
    P = exp(q kᵀ - lse) recomputed, then (dq part, dk, dv) of that block for
    the output gradient g; delta = rowsum(g * out)."""
    p = torch.exp(torch.bmm(q, k.transpose(1, 2)) - lse[..., None])
    ds = p * (torch.bmm(g, v.transpose(1, 2)) - delta[..., None])
    return torch.bmm(ds, k), torch.bmm(ds.transpose(1, 2), q), torch.bmm(p.transpose(1, 2), g)


def _start_rotation(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup
                    ) -> Tuple[List, List[torch.Tensor]]:
    """Send `tensors` to the next rank of the ring and receive the previous
    rank's; returns (requests, receive buffers)."""
    i, n = dist.get_rank(group), dist.get_world_size(group)
    nxt = dist.get_global_rank(group, (i + 1) % n)
    prv = dist.get_global_rank(group, (i - 1) % n)
    recv = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
           + [dist.P2POp(dist.irecv, t, prv, group) for t in recv])
    return dist.batch_isend_irecv(ops), recv


def _rotate(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup) -> List[torch.Tensor]:
    reqs, recv = _start_rotation(tensors, group)
    for r in reqs:
        r.wait()
    return recv


class RingAttention(torch.autograd.Function):
    """softmax(q kᵀ) v over the ring's whole position axis, for this rank's
    slices q, k, v (B, n, D*); the result is this rank's (B, n, Dv) slice in
    q's dtype. Products in f32 (f64 for f64 inputs), with any autocast
    switched off in both passes: the backward rebuilds each block's
    probabilities from the forward's log-sum-exp, so the two must be
    computed alike."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                group: dist.ProcessGroup) -> torch.Tensor:
        ct = torch.promote_types(q.dtype, torch.float32)
        b, n, _ = q.shape
        with torch.autocast(q.device.type, enabled=False):
            qc, kv = q.to(ct), [k.to(ct).contiguous(), v.to(ct).contiguous()]
            m = torch.full((b, n), _NEG_INF, dtype=ct, device=q.device)
            l = torch.zeros((b, n), dtype=ct, device=q.device)
            acc = torch.zeros((b, n, v.shape[2]), dtype=ct, device=q.device)
            size = dist.get_world_size(group)
            for t in range(size):
                pending = _start_rotation(kv, group) if t < size - 1 else None
                m, l, acc = _ring_step(qc, *kv, m, l, acc)
                if pending is not None:
                    for r in pending[0]:
                        r.wait()
                    kv = pending[1]
            out = acc / l[..., None]
            ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.group = group
        return out.to(q.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        q, k, v, out, lse = ctx.saved_tensors
        group, ct = ctx.group, out.dtype
        with torch.autocast(q.device.type, enabled=False):
            qc, gc = q.to(ct), g.to(ct)
            delta = (gc * out).sum(dim=-1)
            kb, vb = k.to(ct).contiguous(), v.to(ct).contiguous()
            dq = torch.zeros_like(qc)
            dk, dv = torch.zeros_like(kb), torch.zeros_like(vb)
            size = dist.get_world_size(group)
            for t in range(size):
                dq_t, dk_t, dv_t = _ring_grad_step(qc, kb, vb, gc, lse, delta)
                dq += dq_t
                dk += dk_t
                dv += dv_t
                if t < size - 1:  # the block and its partials move on together
                    kb, vb, dk, dv = _rotate((kb, vb, dk, dv), group)
            if size > 1:  # the last holder passes the partials to their owner
                dk, dv = _rotate((dk, dv), group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mesh: DeviceMesh, axis: str = "model") -> torch.Tensor:
    """Context-parallel attention over the mesh axis `axis`: q, k, v (B, n,
    D*) are this rank's slices of the position axis (rank i of the axis
    holds positions [i n, (i + 1) n)); returns this rank's output slice.
    The batch axis is whatever this rank holds: under shard_batch, its
    "data" rows, as the JAX ring co-shards the batch over "data"."""
    return RingAttention.apply(q, k, v, mesh.get_group(axis))


class _GatherPositions(torch.autograd.Function):
    """All ranks' (B, n, D) slices concatenated along positions; the
    backward sums the ranks' output gradients and keeps this rank's slice
    (an all-reduce, which every backend has)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.group, ctx.index, ctx.n = group, dist.get_rank(group), x.shape[1]
        return torch.cat(parts, dim=1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[:, ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None


def replicated_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              mesh: DeviceMesh, axis: str = "model") -> torch.Tensor:
    """The ring for q, k, v (B, N, D*) that every rank of `axis` holds whole
    (BCP's point features are replicated over "model"): each rank takes its
    N/d positions, runs the ring, and the output slices are gathered back
    over `axis`, differentiably. The gradient each rank gets for its inputs
    is d times its slice's share; the mean over the ranks that sync_grads
    takes makes the whole gradient of it."""
    group = mesh.get_group(axis)
    d, i = dist.get_world_size(group), dist.get_rank(group)
    n = q.shape[1] // d

    def mine(t):
        return t[:, i * n:(i + 1) * n]

    return _GatherPositions.apply(RingAttention.apply(mine(q), mine(k), mine(v), group), group)
