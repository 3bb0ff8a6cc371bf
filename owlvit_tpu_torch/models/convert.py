"""Weights: the HF checkpoint converter, the JAX package's flat npz and the
bridge from its parameter tree to the port's modules.

`convert_state_dict`, `flatten`, `unflatten`, `save_params` and
`load_params` copy owlvit_tpu/models/convert.py:25-150 (that module's
package pulls in jax; its layer stacking uses jax.tree.map, here a numpy
recursion that orders keys as jax's dict flattening does);
tests/test_torch_convert.py and tests/test_torch_cli.py hold them equal.
Keys look like `vision/layers/attn/q/kernel`; kernels are [d_in, d_out] and
the stacked encoder layers carry a leading [L] axis.

`load_tree` maps such a tree onto a module by name: `kernel` -> `weight`
(transposed to nn.Linear's [d_out, d_in]), `scale` -> `weight`, and a
`layers` subtree with a leading [L] axis -> `layers.0`, `layers.1`, ...;
`to_jax_tree` maps a module back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import owlvit
from .configs import OwlViTConfig

_SEP = "/"


# --------------------------------------------------------------------------
# HF OwlViTForObjectDetection state_dict -> the JAX parameter tree (offline)
# --------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _linear(sd: dict, prefix: str) -> dict:
    p = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def _ln(sd: dict, prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _stack(trees: list):
    """Stack same-structured trees leaf by leaf along a new leading axis,
    keys sorted as jax.tree.map returns them."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in sorted(trees[0])}
    return np.stack(trees)


def _encoder(sd: dict, prefix: str, num_layers: int) -> dict:
    layers = []
    for i in range(num_layers):
        lp = f"{prefix}.layers.{i}"
        layers.append({
            "ln1": _ln(sd, f"{lp}.layer_norm1"),
            "attn": {
                "q": _linear(sd, f"{lp}.self_attn.q_proj"),
                "k": _linear(sd, f"{lp}.self_attn.k_proj"),
                "v": _linear(sd, f"{lp}.self_attn.v_proj"),
                "out": _linear(sd, f"{lp}.self_attn.out_proj"),
            },
            "ln2": _ln(sd, f"{lp}.layer_norm2"),
            "mlp": {
                "fc1": _linear(sd, f"{lp}.mlp.fc1"),
                "fc2": _linear(sd, f"{lp}.mlp.fc2"),
            },
        })
    return _stack(layers)


def convert_state_dict(sd: dict, cfg: OwlViTConfig) -> dict:
    """HF OwlViTForObjectDetection state_dict -> the parameter tree (numpy):
    nn.Linear weights [out, in] become kernels [in, out], the conv patch
    embedding [D, 3, ps, ps] becomes [ps*ps*3, D] in (py, px, c) order, and
    encoder layers stack along a leading axis."""
    ps = cfg.vision.patch_size
    conv_w = _np(sd["owlvit.vision_model.embeddings.patch_embedding.weight"])
    patch_kernel = conv_w.transpose(2, 3, 1, 0).reshape(ps * ps * 3, -1)
    return {
        "vision": {
            "patch_embedding": {"kernel": patch_kernel},
            "class_embedding": _np(
                sd["owlvit.vision_model.embeddings.class_embedding"]),
            "position_embedding": _np(
                sd["owlvit.vision_model.embeddings.position_embedding.weight"]),
            "pre_ln": _ln(sd, "owlvit.vision_model.pre_layernorm"),
            "layers": _encoder(sd, "owlvit.vision_model.encoder",
                               cfg.vision.num_layers),
            "post_ln": _ln(sd, "owlvit.vision_model.post_layernorm"),
        },
        "text": {
            "token_embedding": _np(
                sd["owlvit.text_model.embeddings.token_embedding.weight"]),
            "position_embedding": _np(
                sd["owlvit.text_model.embeddings.position_embedding.weight"]),
            "layers": _encoder(sd, "owlvit.text_model.encoder", cfg.text.num_layers),
            "final_ln": _ln(sd, "owlvit.text_model.final_layer_norm"),
            "projection": {"kernel": _np(sd["owlvit.text_projection.weight"]).T},
        },
        "merged_ln": _ln(sd, "layer_norm"),
        "box_head": {
            "dense0": _linear(sd, "box_head.dense0"),
            "dense1": _linear(sd, "box_head.dense1"),
            "dense2": _linear(sd, "box_head.dense2"),
        },
        "class_head": {
            "dense0": _linear(sd, "class_head.dense0"),
            "logit_shift": _linear(sd, "class_head.logit_shift"),
            "logit_scale": _linear(sd, "class_head.logit_scale"),
        },
    }


# --------------------------------------------------------------------------
# Flat npz (de)serialization
# --------------------------------------------------------------------------


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


def save_params(path: str, params: dict) -> None:
    np.savez(path, **flatten(params))


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


def to_jax_tree(module: torch.nn.Module) -> dict:
    """The inverse of `load_tree`: a module's parameters (its state_dict) as
    the JAX parameter tree of fp32 numpy arrays, `weight` -> `kernel`
    ([d_in, d_out]) on Linear layers and -> `scale` on LayerNorms, the
    `layers.N` entries stacked on a leading [L] axis."""
    from .layers import LayerNorm, Linear

    leaf = {Linear: "kernel", LayerNorm: "scale"}
    flat, stacks = {}, {}
    for key, t in module.state_dict().items():
        owner, name = key.rpartition(".")[::2]
        arr = t.detach().float().cpu().numpy()
        kind = leaf.get(type(module.get_submodule(owner))) if owner else None
        if kind and name == "weight":
            name = kind
            if kind == "kernel":
                arr = np.swapaxes(arr, -1, -2)
        parts = [*owner.split("."), name] if owner else [name]
        if "layers" in parts:
            i = parts.index("layers")
            path = _SEP.join([*parts[:i + 1], *parts[i + 2:]])
            stacks.setdefault(path, {})[int(parts[i + 1])] = arr
        else:
            flat[_SEP.join(parts)] = arr
    for path, rows in stacks.items():
        flat[path] = np.stack([rows[n] for n in range(len(rows))])
    return unflatten(flat)


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
