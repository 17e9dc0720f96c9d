"""The BC train step -- port of vaeplay_tpu/train/steps_bc.py:make_bc_train_step
(reference train_BC.py:52-68).

Loss: (edge BCE + dice) + (mask BCE + dice) + the chamfer point regression
of the traced contours and their regressions against the target and RDP
key contours (ops/losses.py). One backward of their sum and one Adam step
over every parameter but the frozen backbone stem and layer1
(train/state.py:frozen_backbone_adam), with StepLR(10, 0.5) counted in
epochs (train/state.py:step_lr_by_epoch).

The contours are traced inside the forward (models/bc.py:trace_contours),
as the JAX package's callback mode does, or injected: the two-program bridge
(JAX :93-172) runs `make_bc_mask_step`, a train-mode forward to the
bit-packed mask, then `BridgeTracer` copies it to the host and traces it on
a worker thread, and the train step takes the traced (pts, counts). The BC
trainer takes the bridge on a mesh of more than one rank, where each rank
traces its own rows, as the JAX package does on a multi-device mesh.
"""

import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from vaeplay_torch.models.bc import ComposeNet, Contours
from vaeplay_torch.ops import losses as L
from vaeplay_torch.ops.bits import unpack_mask_bits
from vaeplay_torch.ops.contour import batch_find_contours
from vaeplay_torch.parallel.mesh import sync_grads
from vaeplay_torch.train.state import TrainState, running_stats_untouched
from vaeplay_torch.utils.amp import autocast

METRIC_KEYS = ("loss_edge", "loss_mask", "loss_regress")
TARGET_KEYS = ("bimgs", "eimgs", "tgt_pts", "tgt_mask", "key_pts", "key_mask")


def bc_losses(preds: Dict[str, torch.Tensor], bimgs: torch.Tensor, eimgs: torch.Tensor,
              tgt_pts: torch.Tensor, tgt_mask: torch.Tensor, key_pts: torch.Tensor,
              key_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The three losses of one forward's predictions (f32 or wider)."""
    counts = preds["contour_counts"]
    n = preds["contours"].shape[1]
    pred_mask = (torch.arange(n, device=counts.device)[None, :] < counts[:, None]).to(
        preds["contour_regressions"].dtype)
    return {"loss_edge": L.mask_edge_losses(preds["edges"], eimgs),
            "loss_mask": L.mask_edge_losses(preds["masks"], bimgs),
            "loss_regress": L.chamfer_pt_regression_loss(
                preds["contours"], pred_mask, preds["contour_regressions"],
                tgt_pts, tgt_mask, key_pts, key_mask)}


def make_bc_train_step(model: ComposeNet, compute_dtype: torch.dtype = torch.float32,
                       mesh: Optional[DeviceMesh] = None) -> Callable:
    """(state, imgs, bimgs, eimgs, tgt_pts, tgt_mask, key_pts, key_mask,
    contours=None) -> (state, metrics), updating state (frozen_backbone_adam
    over `model`) in place.

    imgs (B, 3, H, W), bimgs and eimgs (B, 1, H, W) binary targets, the
    target and key points and their masks (data/bc_data.py), all on the
    model's device; the model is in train mode. contours None traces the
    masks of this forward; (pts, counts) injects them. compute_dtype
    bfloat16 runs the convolution stages under bf16 autocast (the refine
    stage stays f32, its linear layers in the model's refine_fc_dtype); the
    losses are f32. metrics: METRIC_KEYS as detached 0-d tensors.

    With a mesh, the tensors are this rank's rows of the global batch: the
    losses are per-sample means of equal slices, so their mean over the
    ranks is the global loss, and the gradients are averaged over the ranks
    (sync_grads) before the update."""

    def train_step(state: TrainState, imgs: torch.Tensor, bimgs: torch.Tensor,
                   eimgs: torch.Tensor, tgt_pts: torch.Tensor, tgt_mask: torch.Tensor,
                   key_pts: torch.Tensor, key_mask: torch.Tensor,
                   contours: Optional[Contours] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with autocast(imgs.device, compute_dtype):
            preds = model(imgs, contours=contours)
        if compute_dtype == torch.bfloat16:
            preds = {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in preds.items()}
        m = bc_losses(preds, bimgs, eimgs, tgt_pts, tgt_mask, key_pts, key_mask)
        state.optimizer.zero_grad()
        (m["loss_edge"] + m["loss_mask"] + m["loss_regress"]).backward()
        sync_grads(state.model.parameters(), mesh)
        state.apply_gradients()
        return state, {k: v.detach() for k, v in m.items()}

    return train_step


def make_bc_mask_step(model: ComposeNet, stride: int = 1,
                      compute_dtype: torch.dtype = torch.float32) -> Callable:
    """The bridge's first program (JAX :93-118): (state, imgs) -> the
    thresholded, padded mask of a train-mode forward, every stride-th row
    and column, bit-packed along W ((B, H', ceil(W' / 8)) uint8 on the
    device, ComposeNet.mask_bits). The BatchNorms use the batch's statistics,
    as the train step's forward does, and their running-statistics updates
    are discarded; no gradient is kept. compute_dtype matches the train
    step's (the mask is thresholded at 0.5)."""

    @torch.no_grad()
    def mask_step(state: TrainState, imgs: torch.Tensor) -> torch.Tensor:
        with running_stats_untouched(model), autocast(imgs.device, compute_dtype):
            return model.mask_bits(imgs, stride)

    return mask_step


def strided_mask_width(img_size: int, stride: int) -> int:
    """Row width of the bridge's mask: the mask is padded by 1 on each side
    before the trace (networks_BC.py:217-219) and every stride-th column is
    kept, ceil((img_size + 2) / stride). The one source of the bridge's
    pack and unpack width."""
    return -(-(img_size + 2) // stride)


class BridgeTracer:
    """The host side of the bridge (JAX :136-172): one worker thread waits
    for the packed mask's copy to the host, unpacks it and traces its
    contours, so the caller's thread goes on dispatching device work
    meanwhile. Points are scaled back to full-resolution coordinates when
    stride > 1. `trace_seconds` counts the host seconds of the unpack and
    trace (models/bc.py:trace_contours' counter of the in-forward path)."""

    def __init__(self, img_size: int, stride: int, max_points: int):
        self.stride = max(stride, 1)
        self.max_points = max_points
        self.mask_w = strided_mask_width(img_size, self.stride)
        self.trace_seconds = 0.0
        self._pool = ThreadPoolExecutor(1)

    def trace(self, packed) -> Tuple[np.ndarray, np.ndarray]:
        """Copy, unpack and trace: (pts (B, max_points, 2) f32, counts (B,)
        int32) numpy arrays. `packed`: a uint8 tensor (any device) or array."""
        if torch.is_tensor(packed):
            packed = packed.cpu().numpy()
        t = time.perf_counter()
        pts, counts = batch_find_contours(unpack_mask_bits(packed, self.mask_w),
                                          self.max_points, threshold=0.5)
        self.trace_seconds += time.perf_counter() - t
        if self.stride > 1:
            pts = pts * np.float32(self.stride)
        return pts, counts

    def _trace_landed(self, host: torch.Tensor, landed: torch.cuda.Event):
        landed.synchronize()
        return self.trace(host.numpy())

    def submit(self, packed) -> Future:
        """trace(packed) on the worker thread. A CUDA tensor's copy into
        pinned host memory is queued here, on the caller's thread, right
        behind the mask program on its stream: queued from the worker, it
        could land behind device work the caller dispatches meanwhile (the
        previous train step), and wait for it, which the JAX package's
        copy of a finished array does not."""
        if not (torch.is_tensor(packed) and packed.is_cuda):
            return self._pool.submit(self.trace, packed)
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        landed = torch.cuda.Event()
        landed.record(torch.cuda.current_stream(packed.device))
        return self._pool.submit(self._trace_landed, host, landed)

    def close(self) -> None:
        self._pool.shutdown()
