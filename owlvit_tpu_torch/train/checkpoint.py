"""Checkpoints with torch.save: every parameter, the AdamW state and the
step, with resume (counterpart of owlvit_tpu/train/checkpoint.py: `save`,
`latest_step`, `restore`, `save_tree`, `restore_tree`, `prune_steps`).

The layout is the JAX module's: one directory per save,
`<directory>/step_{step:08d}`, here holding `state.pt`. A save is written
under a temporary name and renamed into place, so that a run cut off
mid-save leaves no step directory behind. The state is a dict: "model" (the
detector's state_dict: every parameter the port trains or freezes, the
query bank and the text tower included), "optimizer" (the AdamW
state_dict), "step" (micro-steps done), "updates" (optimizer updates) and,
with grad_accum, the accumulation in progress ("mini_step", "grad_acc").
A bare list of tensors (the EMA of the trainable set) is saved beside it as
`<directory>/tree_{step:08d}/tree.pt` by `save_tree`.

The JAX package's Orbax checkpoints are not read, and the JAX package does
not read these: the two packages share weights through the flat npz of
models/convert.py, not through checkpoints.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

_FILE = "state.pt"
_TREE_FILE = "tree.pt"


def _ckpt_path(directory: str, step: int, prefix: str = "step_") -> str:
    return os.path.join(os.path.abspath(directory), f"{prefix}{step:08d}")


def _write(path: str, name: str, obj) -> str:
    """torch.save obj as path/name, written under a temporary directory and
    renamed into place (replacing an earlier save at path)."""
    tmp = f"{path}.tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    torch.save(obj, os.path.join(tmp, name))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def save(directory: str, state: dict) -> str:
    """Write state ({"model", "optimizer", "step", ...}) as
    step_{step:08d}, replacing a save of the same step."""
    return _write(_ckpt_path(directory, int(state["step"])), _FILE, state)


def save_tree(directory: str, step: int, tree: list) -> str:
    """Save a list of tensors (the EMA of the trainable set) beside the
    state checkpoints, keyed by the same step: tree_{step:08d}."""
    return _write(_ckpt_path(directory, step, "tree_"), _TREE_FILE, list(tree))


def restore_tree(directory: str, step: int) -> Optional[list]:
    """The list save_tree wrote at `step`, on the host (None if absent)."""
    path = os.path.join(_ckpt_path(directory, step, "tree_"), _TREE_FILE)
    if not os.path.isfile(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


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
    """Delete step_*/tree_* checkpoints other than keep_step (used by the
    best-checkpoint dir, which should hold exactly one step)."""
    if not os.path.isdir(directory):
        return
    for d in os.listdir(directory):
        for prefix in ("step_", "tree_"):
            if d.startswith(prefix) and d[len(prefix):].isdigit():
                if int(d[len(prefix):]) != keep_step:
                    shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def restore(directory: str) -> Optional[dict]:
    """The latest checkpoint's state, its tensors on the host (None when the
    directory holds none)."""
    step = latest_step(directory)
    if step is None:
        return None
    return torch.load(os.path.join(_ckpt_path(directory, step), _FILE),
                      map_location="cpu", weights_only=True)
