"""Multi-process gloo worlds for the port's parallel tests, and the work each
rank does in them.

`run_world(fn, world, tmp_path, *args)` spawns `world` processes, each
joining a gloo world through a `file://` store under tmp_path (no TCP port,
so parallel test workers cannot clash), running fn(rank, world, *args) with
one torch thread, and saving its result; it returns the results in rank
order, and raises if a rank fails or the world outlives `timeout`. The
workers import torch and the port only: anything of JAX is computed by the
test in the parent.
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT = 150  # seconds a world may take, its processes' start included


def _entry(rank, fn, world, init, out, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        res = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def run_world(fn, world, tmp_path, *args, timeout=TIMEOUT):
    out = os.path.join(str(tmp_path), f"world-{fn.__name__}-{time.monotonic_ns()}")
    os.makedirs(out)
    init = "file://" + os.path.join(out, "store")
    ctx = mp.start_processes(_entry, args=(fn, world, init, out, args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__}: the world of {world} outlived {timeout} s")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _mesh(n_data, n_model):
    from vaeplay_torch.parallel.mesh import create_mesh

    return create_mesh(n_data, n_model, device_type="cpu")


# -- ring attention ---------------------------------------------------------

def ring_forward_backward(rank, world, q, k, v, w, dtype):
    """Every rank holds q, k, v (numpy) whole and runs the ring on its N/d
    slice over a 1 x world mesh; returns its output slice and the gradients
    of sum(sin(out) * w) for its slices."""
    from vaeplay_torch.parallel.ring_attention import ring_self_attention

    mesh = _mesh(1, world)
    n = q.shape[1] // world
    sl = slice(rank * n, (rank + 1) * n)
    ts = [torch.tensor(a[:, sl], dtype=dtype, requires_grad=True) for a in (q, k, v)]
    out = ring_self_attention(*ts, mesh)
    (torch.sin(out) * torch.tensor(w[:, sl], dtype=dtype)).sum().backward()
    return {"out": out.detach(), "grads": [t.grad for t in ts]}


def ring_bf16_autocast(rank, world, q, k, v, w):
    """ring_forward_backward in bf16, the ring called and differentiated
    inside a bf16 autocast (as BCP's bf16 G phase calls it), with the loss
    sum(out * w) taken in f32."""
    from vaeplay_torch.parallel.ring_attention import ring_self_attention

    mesh = _mesh(1, world)
    n = q.shape[1] // world
    sl = slice(rank * n, (rank + 1) * n)
    ts = [torch.tensor(a[:, sl], dtype=torch.bfloat16, requires_grad=True) for a in (q, k, v)]
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = ring_self_attention(*ts, mesh)
        (out.float() * torch.tensor(w[:, sl])).sum().backward()
    return {"out": out.detach(), "grads": [t.grad for t in ts]}


def ring_replicated(rank, world, q, k, v, w):
    """The replicated form (every rank holds q, k, v whole, the output is
    gathered back): the output and the gradients' mean over the ranks."""
    from vaeplay_torch.parallel.ring_attention import replicated_ring_attention

    mesh = _mesh(1, world)
    ts = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (q, k, v)]
    out = replicated_ring_attention(*ts, mesh)
    (torch.sin(out) * torch.tensor(w, dtype=torch.float64)).sum().backward()
    grads = []
    for t in ts:
        g = t.grad.clone()
        dist.all_reduce(g)
        grads.append(g / world)
    return {"out": out.detach(), "grads": grads}


def routing_active(rank, world, shape, ns, min_n):
    from vaeplay_torch.ops.attention import RingRouting

    ring = RingRouting(_mesh(*shape), min_n=min_n)
    return [ring.active(n) for n in ns]


# -- mesh -------------------------------------------------------------------

def mesh_layout(rank, world, shape, batch):
    """The mesh's shape, names and this rank's coordinates and batch rows."""
    from vaeplay_torch.parallel.mesh import shard_batch

    mesh = _mesh(*shape)
    return {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
            "coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model")),
            "rows": shard_batch(mesh, batch)}


def data_bn_step(rank, world, x, w):
    """A DataBatchNorm2d's output, input gradient and buffers on this rank's
    rows of x, with the loss sum(y * w) summed over the ranks (data_sum)."""
    from torch import nn

    from vaeplay_torch.parallel.mesh import data_sum, global_batchnorm, shard_batch

    mesh = _mesh(world, 1)
    bn = nn.BatchNorm2d(x.shape[1], momentum=0.3).double()
    assert global_batchnorm(bn, mesh) == 1
    xs, ws = (torch.tensor(a, dtype=torch.float64) for a in shard_batch(mesh, (x, w)))
    xs.requires_grad_(True)
    y = bn(xs)
    data_sum((y * ws).sum(), mesh).backward()
    return {"y": y.detach(), "dx": xs.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var, "n": bn.num_batches_tracked,
            "dw": bn.weight.grad}


# -- train steps ------------------------------------------------------------

def vae_step(rank, world, shape, params, imgs, targets, seed, steps=1, dtype=torch.float64):
    """`steps` VAE-GAN steps on this rank's rows from the same weights and
    noise seed, in `dtype`; returns the metrics, the whole state_dict
    (weights and BN buffers) and the last step's gradients."""
    from vaeplay_torch.cli.train_vae import build_state
    from vaeplay_torch.parallel.mesh import (full_state_dict, global_batchnorm, shard_batch,
                                             shard_state)
    from vaeplay_torch.train.steps_vae import make_train_step

    mesh = _mesh(*shape)
    state = build_state(imgs.shape[-1], params["z"], 1e-4, 0, torch.device("cpu"))
    state.model.to(dtype).load_state_dict(params["sd"])
    global_batchnorm(state.model, mesh)
    shard_state(mesh, state)
    step = make_train_step(state.model, mesh=mesh)
    gen = torch.Generator().manual_seed(seed)
    x, t = (torch.tensor(a, dtype=dtype) for a in shard_batch(mesh, (imgs, targets)))
    metrics = []
    for _ in range(steps):
        state, m = step(state, x, t, gen)
        metrics.append({k: float(v) for k, v in m.items()})
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    return {"metrics": metrics, "sd": full_state_dict(state.model.state_dict()),
            "grads": full_state_dict(grads)}


def bcp_step(rank, world, shape, sds, batch, point_attention, compute_dtype=None):
    """One BCP step on this rank's rows from the given G and D weights: f64,
    or f32 weights under `compute_dtype`'s autocast; returns the metrics,
    G's gradients and both nets' weights after it."""
    from vaeplay_torch.models.bcp import ComposeNet, Discriminator
    from vaeplay_torch.ops.attention import RingRouting
    from vaeplay_torch.parallel.mesh import shard_batch
    from vaeplay_torch.train.state import GanState, TrainState
    from vaeplay_torch.train.steps_bcp import make_bcp_train_step

    mesh = _mesh(*shape)
    cfg = sds["cfg"]
    ring = RingRouting(mesh, min_n=cfg["min_n"]) if point_attention else None
    dtype = torch.float64 if compute_dtype is None else torch.float32
    g = ComposeNet(cfg["points"], point_attention, encoder_blocks=2,
                   encoder_out_size=cfg["out_size"], ring=ring).to(dtype)
    d = Discriminator(cfg["img"], cfg["points"]).to(dtype)
    g.load_state_dict(sds["g"])
    d.load_state_dict(sds["d"])
    gs = GanState(TrainState.create(g, 1e-3), TrainState.create(d, 1e-3))
    step = make_bcp_train_step(g, d, compute_dtype or torch.float32, mesh=mesh)
    rows = shard_batch(mesh, batch)
    args = [torch.from_numpy(rows[k]) for k in ("imgs", "labels", "points", "pmask")]
    args[0] = args[0].permute(0, 3, 1, 2).contiguous().to(dtype)
    args[2], args[3] = args[2].to(dtype), args[3].to(dtype)
    gs, m = step(gs, *args)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "g_grads": {n: p.grad for n, p in g.named_parameters()},
            "g": g.state_dict(), "d": d.state_dict()}


def bc_bridge_step(rank, world, shape, cfg, sd, batch, stride):
    """One BC step through the bridge (sync) on this rank's rows (f64);
    returns the metrics, the traced contours and the weights after it."""
    from vaeplay_torch.models.bc import ComposeNet
    from vaeplay_torch.parallel.mesh import global_batchnorm, shard_batch
    from vaeplay_torch.train.state import frozen_backbone_adam
    from vaeplay_torch.train.steps_bc import (BridgeTracer, make_bc_mask_step,
                                              make_bc_train_step)

    mesh = _mesh(*shape)
    max_points = cfg["points"]
    model = ComposeNet(max_points, backbone_layers=(1, 1, 1, 1),
                       backbone_width=cfg["width"]).double()
    model.load_state_dict(sd)
    global_batchnorm(model, mesh)
    state = frozen_backbone_adam(model, 1e-4)
    model.train()
    rows = shard_batch(mesh, batch)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().double()
    t = [nchw(rows["imgs"]), nchw(rows["bimgs"]), nchw(rows["eimgs"])] + [
        torch.from_numpy(np.ascontiguousarray(rows[k])).double()
        if rows[k].dtype.kind == "f" else torch.from_numpy(rows[k])
        for k in ("tgt_pts", "tgt_mask", "key_pts", "key_mask")]
    tracer = BridgeTracer(rows["imgs"].shape[1], stride, max_points)
    pts, counts = tracer.submit(make_bc_mask_step(model, stride)(state, t[0])).result()
    contours = (torch.from_numpy(pts).double(), torch.from_numpy(counts))
    state, m = make_bc_train_step(model, mesh=mesh)(state, *t, contours)
    return {"metrics": {k: float(v) for k, v in m.items()}, "pts": pts, "counts": counts,
            "sd": model.state_dict()}


def cli_run(rank, world, name, argv, slim=None):
    """The trainer CLI vaeplay_torch.cli.<name> on this rank, its
    ComposeNet built with the keyword arguments `slim` when given (the CLI
    tests' slim nets); returns its run dir."""
    import functools
    import importlib

    cli = importlib.import_module(f"vaeplay_torch.cli.{name}")
    if slim is not None:
        cli.ComposeNet = functools.partial(cli.ComposeNet, **slim)
    return cli.main(argv)
