"""The ("data", "model") device mesh -- port of vaeplay_tpu/parallel/mesh.py.

The JAX package shards by annotation and lets GSPMD insert the collectives.
Here every collective is explicit, over a `torch.distributed` world of one
process per device:

  world        `mesh_session(spec, device)` joins the world `torchrun`
               launched (RANK, WORLD_SIZE, LOCAL_RANK), or starts a world of
               1 itself for a D x M = 1 mesh with no launcher. nccl on the
               card, gloo on the CPU; there is no other backend and no
               fallback. A mesh the launched world cannot hold raises.
  mesh         `create_mesh` / `parse_mesh_arg`: a DeviceMesh of shape
               (D, M) with dims ("data", "model"), rank r at (r // M, r % M),
               the JAX package's row-major device grid.
  batch        `shard_batch`: each rank keeps the rows of its "data"
               coordinate; ranks along "model" hold the same rows
               (the JAX package's P("data")).
  gradients    `sync_grads`: the mean of every replicated parameter's
               gradient over all ranks, called by the steps before each
               optimizer step (a GAN step runs several phases, and BCP's G
               phase takes torch.autograd.grad, which DDP's hooks miss).
               Each rank's loss is a quantity whose mean over the ranks is
               the global batch's loss: a per-sample mean of equal slices as
               it is, a batch-wide sum or masked mean through `data_sum`.
  BatchNorm    `global_batchnorm`: train-mode statistics over the global
               batch (GSPMD's BatchNorm sees the global array): per-channel
               sums and sums of squares all-reduced over "data",
               differentiably, var = max(0, E[x^2] - E[x]^2) as flax computes it.
  model axis   `shard_state`: FSDP2 `fully_shard` of each top-level
               submodule on the 2-D mesh (HSDP: replicated over "data",
               sharded over "model"), its optimizer state with it. The JAX
               rule shards the output axis of kernels with >= 1024 outputs
               (and their Adam moments); FSDP2 shards every parameter, which
               gives the same numbers and holds no more memory per rank.
               FSDP2 reduces these gradients itself, so `sync_grads` skips
               them. DTensor tensor parallelism would follow the JAX rule
               more closely, but cannot shard a Conv2d's outputs.
  checkpoints  `full_state_dict`: a state's state_dict with every sharded
               tensor gathered whole, under the keys of a run without a
               mesh, so a checkpoint resumes on any mesh shape.
"""

import collections
import contextlib
import os
import re
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor

AXES = ("data", "model")


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """"DxM" (or "D*M") -> (D, M)."""
    m = re.fullmatch(r"\s*(\d+)\s*[xX*]\s*(\d+)\s*", spec)
    if not m or int(m.group(1)) < 1 or int(m.group(2)) < 1:
        raise ValueError(f"--mesh takes DATAxMODEL, e.g. 4x2; got {spec!r}")
    return int(m.group(1)), int(m.group(2))


def launched_world_size() -> int:
    """The ranks of the running world, or those a launcher announced."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def check_world(n_data: int, n_model: int) -> None:
    """Raise unless the launched world has exactly n_data x n_model ranks."""
    world = launched_world_size()
    if n_data * n_model != world:
        n = n_data * n_model
        raise ValueError(f"mesh {n_data}x{n_model} != {world} devices: a {n_data}x{n_model} "
                         f"mesh needs {n} ranks, one per device; launch them with "
                         f"`torchrun --nproc_per_node {n} -m vaeplay_torch.cli.<trainer> "
                         f"--mesh {n_data}x{n_model}`")


def init_distributed(device: torch.device) -> torch.device:
    """Join the running world, or the one `torchrun` announced, or start a
    world of 1; returns this rank's device (`cuda:LOCAL_RANK` under a
    launcher, else `device`). nccl for a CUDA device, gloo for the CPU."""
    local = os.environ.get("LOCAL_RANK")
    if device.type == "cuda" and local is not None:
        device = torch.device("cuda", int(local))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {"device_id": device} if device.type == "cuda" else {}
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    return device


def create_mesh(n_data: Optional[int] = None, n_model: int = 1,
                device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over the running world; n_data None puts
    every rank on "data" (JAX create_mesh's default)."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    check_world(n_data, n_model)
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=AXES)


def parse_mesh_arg(spec: Optional[str], device_type: str = "cuda") -> DeviceMesh:
    """The mesh of a CLI's "--mesh DxM"; None or "" puts every rank on "data"."""
    if not spec:
        return create_mesh(device_type=device_type)
    return create_mesh(*parse_mesh_spec(spec), device_type=device_type)


@contextlib.contextmanager
def mesh_session(spec: Optional[str], device: torch.device
                 ) -> Iterator[Tuple[Optional[DeviceMesh], torch.device]]:
    """(mesh, this rank's device) for a CLI's --mesh: (None, device) with no
    --mesh. The world is checked against the mesh before any process group
    starts; a world started here is destroyed on the way out."""
    if not spec:
        yield None, device
        return
    check_world(*parse_mesh_spec(spec))
    started = not dist.is_initialized()
    device = init_distributed(device)
    try:
        mesh = parse_mesh_arg(spec, device.type)
        if is_main(mesh):
            print(f"mesh data={mesh.size(0)} model={mesh.size(1)} over "
                  f"{dist.get_backend()} ({dist.get_world_size()} rank(s))")
        yield mesh, device
    finally:
        if started:
            dist.destroy_process_group()


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def is_main(mesh: Optional[DeviceMesh]) -> bool:
    """Whether this rank prints and writes: rank 0, or any run without a mesh."""
    return mesh is None or dist.get_rank() == 0


def main_print(mesh: Optional[DeviceMesh]) -> Callable:
    """`print` on the rank that prints (is_main), a no-op on the others."""
    return print if is_main(mesh) else (lambda *args, **kwargs: None)


def broadcast_object(obj: Any, mesh: Optional[DeviceMesh]) -> Any:
    """Rank 0's `obj` on every rank (a run dir's timestamp); obj without a mesh."""
    if mesh is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def shard_batch(mesh: Optional[DeviceMesh], batch: Any) -> Any:
    """The rows of this rank's "data" coordinate of every array or tensor in
    a tuple, list or dict (nested), the leading axis split evenly; `batch`
    itself without a mesh."""
    n = axis_size(mesh, "data")
    if n == 1:
        return batch
    i = mesh.get_local_rank("data")

    def rows(x):
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(rows(v) for v in x)
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} does not split over {n} data ranks")
        per = x.shape[0] // n
        return x[i * per:(i + 1) * per]

    return rows(batch)


def data_sum(t: torch.Tensor, mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """t summed over the "data" ranks, differentiably (the backward sums the
    ranks' gradients back); t itself without a mesh or on one data rank."""
    if axis_size(mesh, "data") == 1:
        return t
    return dist_nn.all_reduce(t, group=mesh.get_group("data"))


@torch.no_grad()
def sync_grads(params: Iterable[torch.Tensor], mesh: Optional[DeviceMesh]) -> None:
    """Replace each replicated parameter's .grad by its mean over every rank
    of the mesh, in one all-reduce per dtype (in the order the dtypes first
    appear, the same on every rank). FSDP2's sharded gradients (DTensors)
    are reduced by FSDP2 and left alone. No-op without a mesh."""
    if mesh is None:
        return
    grads = [p.grad for p in params if p.grad is not None and not isinstance(p.grad, DTensor)]
    world = dist.get_world_size()
    for dtype in dict.fromkeys(g.dtype for g in grads):
        same = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat)
        flat.div_(world)
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def all_mean(t: torch.Tensor, mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """t averaged over the "data" ranks (no gradient): a logged metric's
    global value."""
    n = axis_size(mesh, "data")
    if n == 1:
        return t
    t = t.clone()
    dist.all_reduce(t, group=mesh.get_group("data"))
    return t / n


def global_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                      group: dist.ProcessGroup) -> torch.Tensor:
    """bn's train-mode forward over the batch of every rank in `group`:
    per-channel sum, sum of squares and count all-reduced (differentiably),
    mean = S / n, var = max(0, SS / n - mean^2) as flax clamps it; the running statistics move as
    bn's own forward moves them on one rank (the unbiased variance for the
    running one, torch's rule, which the port keeps; ROADMAP queue 3)."""
    dims = [0] + list(range(2, x.dim()))
    c = x.shape[1]
    xc = x.to(torch.promote_types(x.dtype, torch.float32))
    local = torch.cat([xc.sum(dims), (xc * xc).sum(dims),
                       xc.new_full((1,), x.numel() // c)])
    stats = dist_nn.all_reduce(local, group=group)
    n = stats[-1]
    mean = stats[:c] / n
    var = (stats[c:2 * c] / n - mean * mean).clamp_min(0)  # flax's max(0, .)
    if bn.track_running_stats:
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(1 - m).add_(mean.to(bn.running_mean.dtype), alpha=m)
            bn.running_var.mul_(1 - m).add_((var * n / (n - 1)).to(bn.running_var.dtype),
                                            alpha=m)
            bn.num_batches_tracked.add_(1)
    shape = [1, c] + [1] * (x.dim() - 2)
    y = (xc - mean.view(shape)) * torch.rsqrt(var.view(shape) + bn.eps)
    if bn.affine:
        y = y * bn.weight.view(shape) + bn.bias.view(shape)
    return y.to(x.dtype)


class _GlobalStats:
    """Mixin of the DataBatchNorm classes: train mode normalizes with the
    global batch's statistics (global_batch_norm over `group`)."""

    group: Optional[dist.ProcessGroup] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.group is None:
            return super().forward(x)
        self._check_input_dim(x)
        return global_batch_norm(self, x, self.group)


class DataBatchNorm1d(_GlobalStats, nn.BatchNorm1d):
    pass


class DataBatchNorm2d(_GlobalStats, nn.BatchNorm2d):
    pass


_GLOBAL = {nn.BatchNorm1d: DataBatchNorm1d, nn.BatchNorm2d: DataBatchNorm2d}


def global_batchnorm(model: nn.Module, mesh: Optional[DeviceMesh]) -> int:
    """Give every BatchNorm1d/2d of `model` the global batch's statistics
    over the mesh's "data" ranks, in place (the same parameters, buffers and
    state_dict keys); returns how many. Nothing changes on one data rank."""
    if axis_size(mesh, "data") == 1:
        return 0
    group, n = mesh.get_group("data"), 0
    for m in model.modules():
        cls = _GLOBAL.get(type(m))
        if cls is not None:
            m.__class__, m.group = cls, group
            n += 1
    return n


def _optimizers(state: Any) -> Iterator[Tuple[nn.Module, torch.optim.Optimizer]]:
    if hasattr(state, "optimizers"):  # GroupedTrainState
        for opt in state.optimizers.values():
            yield state.model, opt
    elif hasattr(state, "optimizer"):  # TrainState
        yield state.model, state.optimizer
    else:  # a state of states (GanState, ...)
        for sub in vars(state).values():
            yield from _optimizers(sub)


def shard_state(mesh: Optional[DeviceMesh], state: Any) -> int:
    """FSDP2 on the "model" axis for every model of `state` (a TrainState,
    GroupedTrainState or a state of them): each top-level submodule that
    holds parameters is `fully_shard`ed on the 2-D mesh, and every optimizer
    is pointed at the sharded parameters with its state sharded alike (so a
    full checkpoint restored before this call resumes). Returns the number
    of submodules sharded; none with M = 1. Call before the first step."""
    if axis_size(mesh, "model") == 1:
        return 0
    from torch.distributed.fsdp import fully_shard

    pairs = list(_optimizers(state))
    sharded = 0
    for model in {id(m): m for m, _ in pairs}.values():
        names = {id(p): n for n, p in model.named_parameters()}
        for child in model.children():
            if next(child.parameters(), None) is not None:
                fully_shard(child, mesh=mesh)
                sharded += 1
        if next(model.parameters(recurse=False), None) is not None:
            raise ValueError("shard_state: parameters directly on the top-level module")
        now = dict(model.named_parameters())
        for m, opt in pairs:
            if m is not model:
                continue
            old_state = opt.state
            opt.state = collections.defaultdict(dict)
            for group in opt.param_groups:
                new = [now[names[id(p)]] for p in group["params"]]
                for p, q in zip(group["params"], new):
                    if p in old_state:
                        opt.state[q] = {k: distribute_tensor(v, q.device_mesh, q.placements)
                                        if torch.is_tensor(v) and v.shape == q.shape and v.dim()
                                        else v for k, v in old_state[p].items()}
                group["params"] = new
    return sharded


def full_state_dict(sd: Any) -> Any:
    """A state_dict (nested dicts and lists) with every DTensor gathered into
    a whole tensor: a collective, so every rank calls it."""
    if isinstance(sd, DTensor):
        return sd.full_tensor()
    if isinstance(sd, dict):
        return type(sd)((k, full_state_dict(v)) for k, v in sd.items())
    if isinstance(sd, list):
        return [full_state_dict(v) for v in sd]
    return sd
