"""The port's ("data", "model") mesh (vaeplay_torch.parallel.mesh) against
the JAX package's: the DxM spec, the mesh's shape, names and rank layout,
each rank's batch rows against the JAX per-device shards of a 4x2 virtual
mesh, the world-size refusal, and BatchNorm over the global batch."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn

import torch_dist_workers as W
from vaeplay_torch.parallel import mesh as M
from vaeplay_tpu.parallel.mesh import create_mesh, parse_mesh_arg, shard_batch


@pytest.mark.parametrize("spec", ["8x1", "4x2", "2*4", "1x8", " 2 x 4 "])
def test_spec_matches_jax_mesh(spec):
    mesh = parse_mesh_arg(spec.replace(" ", ""))
    assert M.parse_mesh_spec(spec) == (mesh.shape["data"], mesh.shape["model"])
    assert M.AXES == mesh.axis_names


@pytest.mark.parametrize("spec", ["4", "4x", "0x2", "ax2", "2x2x2"])
def test_bad_spec_raises(spec):
    with pytest.raises(ValueError, match="DATAxMODEL"):
        M.parse_mesh_spec(spec)


def test_shard_batch_matches_jax_shards_on_4x2():
    """Each of the 8 ranks of parse_mesh_arg's 4x2 mesh (torch's fake
    process group, one rank at a time in this process) sits where the JAX
    device of the same index does and keeps the rows it holds under
    P("data"); with no spec every rank is on "data", as in JAX."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    batch = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    jmesh = create_mesh(n_data=4, n_model=2)
    shards = {s.device.id: np.asarray(s.data) for s in shard_batch(jmesh, batch).addressable_shards}
    for rank, dev in enumerate(jmesh.devices.reshape(-1)):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=8)
        try:
            mesh = M.parse_mesh_arg("4x2", device_type="cpu")
            assert tuple(mesh.shape) == (4, 2) and mesh.mesh_dim_names == M.AXES
            default = M.parse_mesh_arg(None, device_type="cpu")  # every rank on "data"
            assert tuple(default.shape) == tuple(parse_mesh_arg(None).devices.shape) == (8, 1)
            coords = (mesh.get_local_rank("data"), mesh.get_local_rank("model"))
            assert coords == tuple(int(i) for i in np.argwhere(jmesh.devices == dev)[0])
            rows = M.shard_batch(mesh, {"x": batch, "t": (torch.from_numpy(batch),)})
        finally:
            dist.destroy_process_group()
        np.testing.assert_array_equal(rows["x"], shards[dev.id])
        np.testing.assert_array_equal(rows["t"][0].numpy(), shards[dev.id])


def test_gloo_world_layout_matches_jax(tmp_path):
    """A real 4-rank gloo world as a 2x2 mesh: shape, names, coordinates
    and rows against the JAX 2x2 mesh's devices and shards."""
    batch = np.arange(8 * 2, dtype=np.float32).reshape(8, 2)
    jmesh = create_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    shards = {s.device.id: np.asarray(s.data) for s in shard_batch(jmesh, batch).addressable_shards}
    ranks = W.run_world(W.mesh_layout, 4, tmp_path, (2, 2), batch)
    for rank, (r, dev) in enumerate(zip(ranks, jmesh.devices.reshape(-1))):
        assert r["shape"] == (2, 2) and r["names"] == ("data", "model")
        assert r["coords"] == (rank // 2, rank % 2)
        np.testing.assert_array_equal(r["rows"], shards[dev.id])


def test_world_refusal(monkeypatch):
    """A mesh the launched world cannot hold raises before any process
    group starts, naming torchrun; a launcher's WORLD_SIZE counts."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices: .*--nproc_per_node 2"):
        with M.mesh_session("2x1", torch.device("cpu")):
            pass
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match=r"mesh 1x1 != 4 devices"):
        M.check_world(1, 1)
    M.check_world(2, 2)
    with M.mesh_session(None, torch.device("cpu")) as (mesh, device):
        assert mesh is None and device == torch.device("cpu")


def test_mesh_1x1_starts_and_ends_a_world_of_one():
    with M.mesh_session("1x1", torch.device("cpu")) as (mesh, device):
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert tuple(mesh.shape) == (1, 1) and device.type == "cpu"
        x = np.arange(6).reshape(3, 2)
        assert M.shard_batch(mesh, x) is x
    assert not dist.is_initialized()


def test_global_batchnorm_equals_full_batch_f64(tmp_path):
    """DataBatchNorm2d on 2 data ranks, a loss summed over them (data_sum):
    the output, the running statistics (torch's unbiased running variance)
    and the input gradient (2x each rank's share: the ranks' gradients are
    averaged) are the full batch's nn.BatchNorm2d's; its weight gradient is
    the mean of the ranks'."""
    rng = np.random.default_rng(0)
    x, w = rng.normal(size=(4, 3, 5, 5)), rng.normal(size=(4, 3, 5, 5))
    bn = nn.BatchNorm2d(3, momentum=0.3).double()
    xt = torch.tensor(x, requires_grad=True)
    y = bn(xt)
    (y * torch.tensor(w)).sum().backward()
    ranks = W.run_world(W.data_bn_step, 2, tmp_path, x, w)
    tol = dict(rtol=0, atol=1e-12)
    torch.testing.assert_close(torch.cat([r["y"] for r in ranks]), y.detach(), **tol)
    torch.testing.assert_close(torch.cat([r["dx"] for r in ranks]) / 2, xt.grad, **tol)
    torch.testing.assert_close(sum(r["dw"] for r in ranks) / 2, bn.weight.grad, **tol)
    for r in ranks:
        torch.testing.assert_close(r["running_mean"], bn.running_mean, **tol)
        torch.testing.assert_close(r["running_var"], bn.running_var, **tol)
        assert int(r["n"]) == 1
