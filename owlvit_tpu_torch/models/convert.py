"""Weights: the JAX package's flat npz and the bridge from its parameter tree
to the port's modules.

`flatten`/`unflatten`/`load_params` copy owlvit_tpu/models/convert.py:119-150
(that module's package pulls in jax);
tests/test_torch_convert.py holds them equal. Keys look like
`vision/layers/attn/q/kernel`; kernels are [d_in, d_out] and the stacked
encoder layers carry a leading [L] axis.

`load_tree` maps such a tree onto a module by name: `kernel` -> `weight`
(transposed to nn.Linear's [d_out, d_in]), `scale` -> `weight`, and a
`layers` subtree with a leading [L] axis -> `layers.0`, `layers.1`, ...
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import owlvit
from .configs import OwlViTConfig

_SEP = "/"


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_params(path: str) -> dict:
    with np.load(path) as data:
        return unflatten({k: data[k] for k in data.files})


_LEAF = {"kernel": "weight", "scale": "weight"}


def _state_dict(tree: dict) -> dict:
    sd = {}
    for key, arr in flatten(tree).items():
        parts = key.split(_SEP)
        name = _LEAF.get(parts[-1], parts[-1])
        arr = np.asarray(arr, np.float32)
        if parts[-1] == "kernel":
            arr = np.swapaxes(arr, -1, -2)
        if "layers" in parts:
            i = parts.index("layers") + 1
            for n in range(arr.shape[0]):
                sd[".".join([*parts[:i], str(n), *parts[i:-1], name])] = arr[n]
        else:
            sd[".".join([*parts[:-1], name])] = arr
    return {k: torch.tensor(v) for k, v in sd.items()}  # copies: jax arrays are read-only


def load_tree(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Copy a JAX parameter (sub)tree of numpy arrays into `module`; every
    parameter of the module must be present and no key may be left over."""
    module.load_state_dict(_state_dict(tree), strict=True)
    return module


def from_jax_tree(tree: dict, cfg: OwlViTConfig,
                  device: Optional[torch.device] = None):
    """JAX detector params (numpy) -> (owlvit.OwlViT on `device`, skipped
    top-level keys). Every key is carried across, the text tower included,
    so `skipped` is empty; a key the module lacks raises."""
    queries = tree.get("queries")
    model = owlvit.OwlViT(
        cfg, None if queries is None else np.shape(queries)[0])
    load_tree(model, tree)
    return model.to(device), []
