"""Checkpointing -- the port's counterpart of vaeplay_tpu/train/checkpoint.py,
on `torch.save` files in the reference's run layout
logs/<FAMILY>/<YYYYmmdd-HHMMSS>/<epoch>.ckpt (train_BE.py:100-105,136-143).

The reference saves whole pickled modules and no optimizer; here a
checkpoint is a train state's state_dict (the model's, with the reference's
key names, those of its optimizers and scheduler, and the step count), and
a run resumes from it. Files are written to a temporary name and renamed, so a
checkpoint on disk is always whole, and read with `weights_only=True`.
"""

import datetime
import os
from typing import Any, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vaeplay_torch.parallel.mesh import full_state_dict, is_main
from vaeplay_torch.train.state import (FontState, GanState, GroupedTrainState, StyleGanState,
                                       TrainState)

State = Union[TrainState, GroupedTrainState, GanState, FontState, StyleGanState]

SUFFIX = ".ckpt"


def make_run_dir(root: str, family: str, timestamp: Optional[str] = None) -> str:
    """<root>/<FAMILY>/<YYYYmmdd-HHMMSS>/, created (train_BE.py:100-105)."""
    ts = timestamp or datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    path = os.path.join(root, family, ts)
    os.makedirs(path, exist_ok=True)
    return path


class Checkpointer:
    """save(tag, obj) / restore(tag) / tags() / latest() over <run_dir>/<tag>.ckpt."""

    def __init__(self, run_dir: str):
        self.run_dir = os.path.abspath(run_dir)

    def path(self, tag) -> str:
        return os.path.join(self.run_dir, f"{tag}{SUFFIX}")

    def save(self, tag, obj: Any) -> str:
        os.makedirs(self.run_dir, exist_ok=True)
        p = self.path(tag)
        tmp = f"{p}.{os.getpid()}.tmp"
        torch.save(obj, tmp)
        os.replace(tmp, p)
        return p

    def restore(self, tag) -> Any:
        return torch.load(self.path(tag), map_location="cpu", weights_only=True)

    def tags(self) -> List[int]:
        if not os.path.isdir(self.run_dir):
            return []
        names = (n[:-len(SUFFIX)] for n in os.listdir(self.run_dir) if n.endswith(SUFFIX))
        return sorted(int(n) for n in names if n.isdigit())

    def latest(self) -> Optional[int]:
        tags = self.tags()
        return tags[-1] if tags else None


def load_model_path(model_path: str) -> Any:
    """What an inference CLI's --model_path names, loaded on the CPU: a run
    dir -> its latest checkpoint; `<run dir>/<epoch>` -> that epoch's
    checkpoint (the JAX package's rule, vaeplay_tpu/cli/test_be.py:33-35);
    any other path -> that file (a checkpoint, or a bare state_dict)."""
    if os.path.isdir(model_path):
        ckpt = Checkpointer(model_path)
        if ckpt.latest() is None:
            raise FileNotFoundError(f"no checkpoints found under {model_path}")
        return ckpt.restore(ckpt.latest())
    run_dir, tag = os.path.split(model_path)
    if tag.isdigit() and not os.path.exists(model_path):
        ckpt = Checkpointer(run_dir or ".")
        if not os.path.isfile(ckpt.path(tag)):
            raise FileNotFoundError(f"no checkpoint of epoch {tag}: {ckpt.path(tag)}")
        return ckpt.restore(tag)
    return torch.load(model_path, map_location="cpu", weights_only=True)


def save_state(ckpt: Checkpointer, tag, state: State, mesh: Optional[DeviceMesh] = None) -> str:
    """Save the state (model, optimizers, scheduler, step) under `tag`;
    returns the file's path. With a mesh every rank calls it: sharded
    tensors are gathered whole (full_state_dict, the keys of a run without a
    mesh), rank 0 writes, and the ranks wait for the file."""
    if mesh is None:
        return ckpt.save(tag, state.state_dict())
    sd = full_state_dict(state.state_dict())
    if is_main(mesh):
        ckpt.save(tag, sd)
    dist.barrier()
    return ckpt.path(tag)


def restore_state(run_dir: str, state: State, tag=None) -> Tuple[State, int]:
    """Load the checkpoint `tag` (default: the latest) of run_dir into a state
    of the same layout, in place; returns (state, tag). Raises when there is
    no checkpoint, and when the saved layout differs from state's (missing or
    extra keys, other shapes): a strict load."""
    ckpt = Checkpointer(run_dir)
    if tag is None:
        tag = ckpt.latest()
    if tag is None:
        raise FileNotFoundError(f"no checkpoints found under {run_dir}")
    saved = ckpt.restore(tag)
    want = set(state.state_dict())
    if set(saved) != want:
        raise ValueError(f"checkpoint {ckpt.path(tag)} holds {sorted(saved)}, "
                         f"not the state's {sorted(want)}")
    state.load_state_dict(saved)
    return state, int(tag)
