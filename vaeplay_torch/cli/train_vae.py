"""Circle VAE-GAN trainer CLI -- port of vaeplay_tpu/cli/train_vae.py (rebuild
of the reference train.py).

    python -m vaeplay_torch.cli.train_vae --gpu 0
    python -m vaeplay_torch.cli.train_vae --img_size 256 --batchsize 128 --dtype bfloat16 --gpu 0
    python -m vaeplay_torch.cli.train_vae --resume logs/VAE/<timestamp> --epoch 40 --gpu 0

Flags are the reference's (train.py:109-123) and the JAX CLI's. Runs on
`cuda:<--gpu>`; `--device cpu` runs on the CPU (it raises without a card
otherwise). Weights start from the port's seeded init (`--seed`). Without
`--path`, every step renders its circles and encodes their targets on the
device from (B, 3) parameters drawn on the host; with `--path`, images are
read from the reference's filename-encoded PNGs. One backward of the five
summed losses and four RMSprop steps per batch; `--dtype bfloat16` runs
them under bf16 autocast with f32 state (utils/amp.py). Each run writes
metrics.jsonl and one checkpoint per epoch into
<model_output>/VAE/<timestamp>/, and at every `--viz_freq` steps an
`input | reconstruction | render(decoded params)` grid
<res_output>/<epoch>_<i>.png; `--resume` loads the latest checkpoint of an
earlier run dir and goes on from the epoch after it, in a run dir of its own.

`--mesh DxM` trains on a ("data", "model") mesh of D x M ranks, one process
a card (parallel/mesh.py), launched as

    torchrun --standalone --nproc_per_node N -m vaeplay_torch.cli.train_vae --mesh Nx1

(`--mesh 1x1` runs on one card with no launcher; `--device cpu` runs the
ranks on the CPU over gloo). `--batchsize` is the global batch: each rank
takes its rows, the BatchNorms see the global batch's statistics and the
noise is the global batch's, so the run computes what a one-rank run does;
M > 1 shards the weights and RMSprop state over "model" (FSDP2). Rank 0
prints and writes; checkpoints are whole, with the keys of a run without
a mesh, and resume on any mesh.
"""

import argparse
import contextlib
import os
from datetime import datetime

import numpy as np
import torch

from vaeplay_torch.data.circles import CircleDataset, DiskCircleDataset, encode_targets
from vaeplay_torch.data.prefetch import epoch_iterator
from vaeplay_torch.device import resolve_device
from vaeplay_torch.models.vae_gan import VaeGan
from vaeplay_torch.ops.geometry import decode_circle_param, render_circle_batch
from vaeplay_torch.parallel.mesh import (axis_size, broadcast_object, global_batchnorm, is_main,
                                         main_print, mesh_session, shard_batch, shard_state)
from vaeplay_torch.train.checkpoint import Checkpointer, make_run_dir, restore_state, save_state
from vaeplay_torch.train.metrics import accumulating, fetch_averages
from vaeplay_torch.train.state import GroupedTrainState, torch_rmsprop
from vaeplay_torch.train.steps_vae import (GROUPS, make_circle_train_step, make_eval_step,
                                           make_train_step)
from vaeplay_torch.utils.amp import resolve_dtype
from vaeplay_torch.utils.metrics_log import MetricsLogger
from vaeplay_torch.utils.profiling import StepTimer, maybe_profile
from vaeplay_torch.utils.viz import makedirs, save_image_grid

AVG_KEYS = ("loss_recon", "loss_encoder", "loss_decoder", "loss_discriminator", "loss_aux")


def build_state(img_size: int, zdim: int, lr: float, seed: int,
                device: torch.device) -> GroupedTrainState:
    """The seeded VaeGan on `device` and one RMSprop(lr) per sub-network
    (train.py:136-146)."""
    model = VaeGan(img_size=img_size, z_size=zdim,
                   generator=torch.Generator().manual_seed(seed)).to(device)
    return GroupedTrainState.create(model, {g: torch_rmsprop(lr) for g in GROUPS})


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().cpu().numpy()


def save_comparison(path: str, eval_step, img_size: int, params: torch.Tensor,
                    generator: torch.Generator, write: bool = True) -> None:
    """input | reconstruction | render(decoded predicted params), one row
    each. On a mesh every rank computes it (the weights may be sharded, and
    the ranks' generators stay in step) and rank 0 writes (`write`)."""
    imgs = render_circle_batch(img_size, params[:, 0], params[:, 1], params[:, 2])
    x_tilde, pred = eval_step(imgs, generator)
    if not write:
        return
    dec = decode_circle_param(img_size, pred[:, 0], pred[:, 1], pred[:, 2])
    from_params = render_circle_batch(img_size, dec["radius"], dec["x"], dec["y"])
    grid = np.concatenate([_nhwc(imgs), _nhwc(x_tilde), _nhwc(from_params)], axis=0)
    save_image_grid(grid, path, nrow=params.shape[0], padding=2, pad_value=1.0)


def main(argv=None) -> str:
    """Run the trainer; returns its run dir (the checkpoints' directory)."""
    parser = argparse.ArgumentParser(description="circle VAE-GAN trainer, PyTorch/CUDA")
    parser.add_argument("--epoch", type=int, dest="epochs", default=20)
    parser.add_argument("--batchsize", type=int, dest="batchsize", default=16)
    parser.add_argument("--gpu", type=int, dest="gpu", default=0)
    parser.add_argument("--device", type=str, dest="device", default=None,
                        choices=["cpu"], help="run on the CPU instead of --gpu")
    parser.add_argument("--img_size", type=int, dest="img_size", default=128)
    parser.add_argument("--zdim", type=int, dest="zdim", default=128)
    parser.add_argument("--lr", type=float, dest="lr", default=1e-4)
    parser.add_argument("--res_output", type=str, dest="res_output", default="./results")
    parser.add_argument("--model_output", type=str, dest="model_output", default="./logs")
    parser.add_argument("--viz_freq", type=int, dest="viz_freq", default=16)
    parser.add_argument("--data_size", type=int, dest="data_size", default=4096)
    parser.add_argument("--workers", type=int, dest="workers", default=4,
                        help="loader threads for --path (reference train.py:150)")
    parser.add_argument("--path", type=str, dest="path", default=None,
                        help="directory of filename-encoded circle PNGs (reference CDataset "
                             "ifGen=False, dataset.py:35-48); default: on-device synthesis")
    parser.add_argument("--dtype", type=str, dest="dtype", default="float32",
                        choices=("float32", "f32", "bfloat16", "bf16"),
                        help="compute dtype of the forward and backward; parameters, "
                             "optimizer state, BN statistics and losses stay f32")
    parser.add_argument("--remat", action="store_true", dest="remat",
                        help="recompute the forward in the backward (torch.utils.checkpoint) "
                             "instead of keeping its activations; the same update")
    parser.add_argument("--seed", type=int, dest="seed", default=0)
    parser.add_argument("--resume", type=str, dest="resume", default=None,
                        help="run dir of a previous checkpoint to resume from")
    parser.add_argument("--mesh", type=str, dest="mesh", default=None,
                        help="device mesh DATAxMODEL, e.g. 4x2, one rank a card (launch "
                             "D x M ranks with torchrun; 1x1 needs none): the batch is split "
                             "over data, the weights and optimizer state shard over model")
    parser.add_argument("--profile", type=str, dest="profile", default=None,
                        help="directory for a torch.profiler trace")
    parser.add_argument("--profile_steps", type=int, dest="profile_steps", default=5,
                        help="trace only the first N steps")
    args = parser.parse_args(argv)
    with mesh_session(args.mesh, resolve_device(args.gpu, args.device)) as (mesh, device):
        return train(args, device, mesh)


def train(args, device: torch.device, mesh=None) -> str:
    """main's run on `device`, on this rank of `mesh` (None: no mesh)."""
    cdtype = resolve_dtype(args.dtype)
    main_rank = is_main(mesh)
    say = main_print(mesh)
    if main_rank:
        makedirs(args.res_output)
    run_dir = make_run_dir(args.model_output, "VAE",
                           broadcast_object(datetime.now().strftime("%Y%m%d-%H%M%S"), mesh))
    ckpt = Checkpointer(run_dir)
    mlog = MetricsLogger(run_dir)

    state = build_state(args.img_size, args.zdim, args.lr, args.seed, device)
    model = state.model
    start_epoch = 0
    if args.resume:
        state, tag = restore_state(args.resume, state)
        start_epoch = tag + 1
        say(f"resumed epoch {tag} from {args.resume}")
    if global_batchnorm(model, mesh):
        say("BatchNorm statistics over the global batch (all-reduced over data)")
    if shard_state(mesh, state):
        say(f"weights and RMSprop state sharded over {axis_size(mesh, 'model')} model ranks "
            "(FSDP2)")
    if args.path:
        ds = DiskCircleDataset(args.path, args.img_size)
        if not len(ds):
            raise ValueError(f"no filename-encoded circle files in {args.path}")
        say(f"disk mode: {len(ds)} circles from {args.path}")
        step = make_train_step(model, cdtype, args.remat, mesh)
    else:
        ds = CircleDataset(n=args.img_size, min_radius=10, data_size=args.data_size,
                           seed=args.seed)
        step = make_circle_train_step(model, args.img_size, cdtype, args.remat, mesh)
    generator = torch.Generator(device=device).manual_seed(args.seed + 2)
    eval_step = make_eval_step(model)
    astep = accumulating(step)

    model.train()
    with contextlib.ExitStack() as profiling:
        profiling.enter_context(maybe_profile(args.profile if main_rank else None))
        global_it = 0
        for epoch in range(start_epoch, args.epochs):
            acc, cnt, timer = None, 0, StepTimer()
            for i, batch in enumerate(epoch_iterator(ds, args.batchsize, epoch, args.workers)):
                if args.path:
                    imgs, pb = batch
                    targets = encode_targets(args.img_size, pb)
                    imgs, targets = shard_batch(mesh, (imgs, targets))
                    imgs = torch.from_numpy(imgs).permute(0, 3, 1, 2).to(device)
                    state, acc, cnt = astep(state, acc, cnt, imgs,
                                            torch.from_numpy(targets).to(device), generator)
                else:
                    pb = batch
                    state, acc, cnt = astep(state, acc, cnt,
                                            torch.from_numpy(shard_batch(mesh, pb)).to(device),
                                            generator)
                global_it += 1
                if args.profile and global_it == args.profile_steps:
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    profiling.close()
                    say(f"profile trace ({args.profile_steps} steps) -> {args.profile}")

                if (i + 1) % args.viz_freq == 0:
                    avg = fetch_averages(acc, cnt, mesh)  # waits for the device
                    timer.lap(args.viz_freq * args.batchsize)  # images since the last line
                    say(f"epoch {epoch} it {i + 1}: "
                        + " ".join(f"{k}={avg[k]:.6f}" for k in AVG_KEYS)
                        + f" | {timer.items_per_sec:.1f} img/s")
                    if main_rank:
                        mlog.log(state.step, avg, epoch=epoch,
                                 images_per_sec=timer.items_per_sec)
                    save_comparison(os.path.join(args.res_output, f"{epoch}_{i}.png"),
                                    eval_step, args.img_size,
                                    torch.from_numpy(pb).to(device), generator, main_rank)
            save_state(ckpt, epoch, state, mesh)
            say(f"epoch {epoch} done; checkpoint -> {ckpt.path(epoch)}")
    return run_dir

if __name__ == "__main__":
    main()
