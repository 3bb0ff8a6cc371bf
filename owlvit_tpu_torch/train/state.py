"""Parameter partitioning (counterpart of owlvit_tpu/train/state.py:
`partition_params`).

The reference freezes everything except the last vision layers, the vision
post-LN, the merged LN, the box head, the class head's dense0 and the query
bank; its AdamW neither updates nor decays the frozen set. Here the freeze is
`requires_grad`: the optimizer is given the trainable parameters only, and
the frozen prefix of layers runs under no_grad (vit.forward_prefix).
"""

from __future__ import annotations

from typing import Optional

from torch import nn


def partition_params(model: nn.Module,
                     trainable_last_k: Optional[int] = 1) -> list:
    """Mark the detector's trainable set and return it, in a fixed order.

    Trainable: vision layers[L-k:], vision.post_ln, merged_ln, box_head,
    class_head.dense0 and queries (when the model has a query bank); k=None
    is a full fine-tune (every encoder layer; the embeddings and pre-LN stay
    frozen). Every other parameter gets requires_grad=False."""
    layers = model.vision.layers
    n_layers = len(layers)
    k = n_layers if trainable_last_k is None else trainable_last_k
    if not 0 <= k <= n_layers:
        raise ValueError(
            f"trainable_last_k={trainable_last_k} out of range [0, {n_layers}]")
    modules = [*layers[n_layers - k:], model.vision.post_ln, model.merged_ln,
               model.box_head, model.class_head.dense0]
    params = [p for m in modules for p in m.parameters()]
    if model.queries is not None:
        params.append(model.queries)
    for p in model.parameters():
        p.requires_grad_(False)
    for p in params:
        p.requires_grad_(True)
    return params
