"""Checkpoints with torch.save: every parameter, the AdamW state and the
step, with resume (counterpart of owlvit_tpu/train/checkpoint.py: `save`,
`latest_step`, `restore`, `prune_steps`).

The layout is the JAX module's: one directory per save,
`<directory>/step_{step:08d}`, here holding `state.pt`. A save is written
under a temporary name and renamed into place, so that a run cut off
mid-save leaves no step directory behind. The state is a dict: "model" (the
detector's state_dict: every parameter the port trains or freezes, the
query bank and the text tower included), "optimizer" (the AdamW
state_dict) and "step" (updates done).

The JAX package's Orbax checkpoints are not read, and the JAX package does
not read these: the two packages share weights through the flat npz of
models/convert.py, not through checkpoints. `save_tree`/`restore_tree`,
which the JAX package uses for the EMA only, wait for the EMA's port.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

_FILE = "state.pt"


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}")


def save(directory: str, state: dict) -> str:
    """Write state ({"model", "optimizer", "step"}) as step_{step:08d},
    replacing a save of the same step."""
    step = int(state["step"])
    path = _ckpt_path(directory, step)
    tmp = f"{path}.tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    torch.save(state, os.path.join(tmp, _FILE))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and d.split("_")[1].isdigit()
    ]
    return max(steps) if steps else None


def prune_steps(directory: str, keep_step: int) -> None:
    """Delete step_* checkpoints other than keep_step (used by the
    best-checkpoint dir, which should hold exactly one step)."""
    if not os.path.isdir(directory):
        return
    for d in os.listdir(directory):
        if d.startswith("step_") and d[len("step_"):].isdigit():
            if int(d[len("step_"):]) != keep_step:
                shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def restore(directory: str) -> Optional[dict]:
    """The latest checkpoint's state, its tensors on the host (None when the
    directory holds none)."""
    step = latest_step(directory)
    if step is None:
        return None
    return torch.load(os.path.join(_ckpt_path(directory, step), _FILE),
                      map_location="cpu", weights_only=True)
