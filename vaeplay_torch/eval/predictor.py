"""The BE / BE_GAN serving predictor -- port of
vaeplay_tpu/eval/predictor.py:make_packed_be_predict (:93-115), with the
uint8 upload of its `_cast_pad` (:25-40).

Crops go to the card as uint8 NHWC, 4x fewer bytes than f32, and are cast
to f32 / 255 and permuted to NCHW there: uint8 -> f32 / 255 is one IEEE
division either way, so the result equals the host conversion bit for bit.
The packed eval step (train/steps_be.py:make_be_eval_step_packed) sends back
one bit a pixel, 1/32 of the f32 maps.

The JAX package pads every request to a power-of-two bucket
(`BucketedPredictor`, `next_bucket`, :43-90) only to bound XLA's recompiles
per batch shape. Eager PyTorch compiles nothing per shape, and the model is
per sample in eval mode, so the padding would change no result: it is not
ported. Requests above `max_batch` are still split into chunks, which bounds
the device memory. Capturing the forward in CUDA graphs would need fixed
shapes again; buckets come back with such a change.
"""

import contextlib
from typing import Callable, Dict

import numpy as np
import torch

from vaeplay_torch.ops.bits import unpack_mask_bits
from vaeplay_torch.train.steps_be import make_be_eval_step_packed


def on_device(device: torch.device):
    """A context that makes `device` the current CUDA device (a no-op for the
    CPU). A new thread starts on device 0, so a predictor called from
    another thread, as serve_pages' dispatch thread calls it, enters this
    before it touches the card."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def make_packed_be_predict(model: torch.nn.Module, img_size: int, max_batch: int = 32,
                           compute_dtype: torch.dtype = torch.float32) -> Callable:
    """predict(imgs) -> {"masks", "edges"}, each (B, S, S, 1) float32 {0, 1}
    on the host, for uint8 NHWC crops (B, S, S, 3), divided by 255 on the
    card; S = img_size. The model runs on its own device in eval mode
    (compute_dtype as make_be_eval_step_packed's), in chunks of at most
    `max_batch`. An empty batch or another dtype raises. predict.copied
    counts the bytes copied to and from the device."""
    device = next(model.parameters()).device
    step = make_be_eval_step_packed(model, compute_dtype)
    copied = {"to_device": 0, "from_device": 0}

    def run(chunk: np.ndarray) -> Dict[str, np.ndarray]:
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
        copied["to_device"] += x.numel() * x.element_size()
        x = x.float() / 255.0
        out = {k: v.cpu().numpy() for k, v in step(x.permute(0, 3, 1, 2).contiguous()).items()}
        copied["from_device"] += sum(v.nbytes for v in out.values())
        return out

    def predict(imgs) -> Dict[str, np.ndarray]:
        imgs = np.asarray(imgs)
        if imgs.dtype != np.uint8:
            raise TypeError(f"crops must be uint8, got {imgs.dtype}")
        if imgs.shape[0] == 0:
            raise ValueError("empty batch")
        with on_device(device):
            chunks = [run(imgs[i:i + max_batch]) for i in range(0, imgs.shape[0], max_batch)]
        return {k: unpack_mask_bits(np.concatenate([c[k] for c in chunks]), img_size)[..., None]
                for k in ("masks", "edges")}

    predict.copied = copied
    return predict
