"""OWL-ViT detector, query-bank path (counterpart of
owlvit_tpu/models/owlvit.py: `init`, `image_embedder`, `_merge_feats`,
`box_predictor`, `class_embeds`, `class_predictor_querybank`,
`forward_train`, `embed_prefix`, `forward_train_from_prefix`).

The parameters live in an `OwlViT` module whose attribute names follow the
JAX parameter tree; the functions below keep the JAX package's signatures
with that module in the place of the tree. The text tower, the zero-shot and
one-shot heads are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from owlvit_tpu_torch.ops import boxes as box_ops
from owlvit_tpu_torch.ops.box_bias import compute_box_bias

from . import vit
from .configs import OwlViTConfig
from .layers import LayerNorm, Linear, gelu, normal

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class BoxHead(nn.Module):
    def __init__(self, cfg: OwlViTConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D = cfg.vision.hidden_size
        self.dense0 = Linear(D, D, generator=generator)
        self.dense1 = Linear(D, D, generator=generator)
        self.dense2 = Linear(D, 4, generator=generator)
        grid = cfg.vision.grid
        # a constant of the geometry, moved with the module; not a parameter
        self.register_buffer(
            "box_bias", torch.from_numpy(compute_box_bias(grid, grid)),
            persistent=False)


class ClassHead(nn.Module):
    """dense0 projects image features for the query bank; logit_shift and
    logit_scale belong to the zero-shot head and are carried for it."""

    def __init__(self, cfg: OwlViTConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D, P = cfg.vision.hidden_size, cfg.projection_dim
        self.dense0 = Linear(D, P, generator=generator)
        self.logit_shift = Linear(D, 1, generator=generator)
        self.logit_scale = Linear(D, 1, generator=generator)


class OwlViT(nn.Module):
    def __init__(self, cfg: OwlViTConfig, num_queries: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vision = vit.init(cfg.vision, generator)
        self.merged_ln = LayerNorm(cfg.vision.hidden_size,
                                   cfg.vision.layer_norm_eps)
        self.box_head = BoxHead(cfg, generator=generator)
        self.class_head = ClassHead(cfg, generator=generator)
        self.queries = (
            None if num_queries is None
            else nn.Parameter(normal((num_queries, cfg.projection_dim), 0.02,
                                     generator))
        )


def init(cfg: OwlViTConfig, generator: torch.Generator,
         num_queries: Optional[int] = None,
         device: Optional[torch.device] = None) -> OwlViT:
    """Random-init detector on `device` (drawn on the CPU from `generator`).
    num_queries adds a query bank [num_queries, projection_dim]."""
    return OwlViT(cfg, num_queries, generator=generator).to(device)


def image_embedder(params: OwlViT, cfg: OwlViTConfig, pixel_values):
    """[B, H, W, 3] -> image_feats [B, P, D]."""
    last_hidden = vit.forward(
        params.vision, cfg.vision, pixel_values,
        dtype=DTYPES[cfg.dtype], attention_impl=cfg.attention_impl,
        trainable_last_k=cfg.trainable_last_k,
        static_softmax=cfg.static_softmax,
    )
    return _merge_feats(params, cfg, last_hidden)


def _merge_feats(params: OwlViT, cfg: OwlViTConfig, last_hidden):
    """post-LN over all tokens -> patches * CLS -> merged LN."""
    x = params.vision.post_ln(last_hidden)
    cls, patches = x[:, :1, :], x[:, 1:, :]
    return params.merged_ln(patches * cls)


def box_predictor(params: OwlViT, cfg: OwlViTConfig, image_feats):
    """[B, P, D] -> xyxy boxes in [0, 1], [B, P, 4]: gelu MLP, cast to fp32,
    + the per-patch grid bias, sigmoid cxcywh -> corners."""
    head = params.box_head
    h = gelu(head.dense0(image_feats))
    h = gelu(head.dense1(h))
    pred = head.dense2(h).float()
    return box_ops.cxcywh_to_xyxy(torch.sigmoid(pred + head.box_bias))


def class_embeds(params: OwlViT, image_feats):
    """dense0 projection of image feats: [B, P, D] -> [B, P, proj]."""
    return params.class_head.dense0(image_feats)


def class_predictor_querybank(params: OwlViT, cfg: OwlViTConfig, image_feats,
                              queries: Optional[torch.Tensor] = None,
                              prompts_per_class: int = 3):
    """Query-bank cosine-similarity head: [B, P, D] -> sims [B, P, C].

    Both sides L2-normalized in fp32; the query side keeps the reference's
    `q / ||q|| + 1e-6` unless cfg.fix_query_norm. Then the max over each
    class's `prompts_per_class` consecutive prompt variants."""
    if queries is None:
        queries = params.queries
    img = class_embeds(params, image_feats).float()
    img = img / (torch.linalg.vector_norm(img, dim=-1, keepdim=True) + 1e-6)
    q = queries.float()
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q = q / (qn + 1e-6) if cfg.fix_query_norm else q / qn + 1e-6
    sims = img @ q.T
    B, P, Q = sims.shape
    return sims.reshape(B, P, Q // prompts_per_class, prompts_per_class).amax(-1)


def forward_train(params: OwlViT, cfg: OwlViTConfig, pixel_values):
    """[B, H, W, 3] -> (pred_boxes xyxy [B, P, 4], sims [B, P, C])."""
    feats = image_embedder(params, cfg, pixel_values)
    return (box_predictor(params, cfg, feats),
            class_predictor_querybank(params, cfg, feats))


def embed_prefix(params: OwlViT, cfg: OwlViTConfig, pixel_values):
    """Frozen-backbone prefix activations [B, S, D], S = num_patches + 1:
    the embeddings and the frozen layers[0 : L-k] under no_grad. A pure
    function of (frozen parameters, pixels) when cfg.trainable_last_k is
    set, which the cached train step stores once per image. The JAX package
    returns the token axis padded to its attention block ([B, S_pad, D]);
    the port never pads it, so a pool row is [S, D] and there is no
    [:S_real] slice anywhere on the cached path."""
    if cfg.trainable_last_k is None:
        raise ValueError(
            "embed_prefix requires trainable_last_k (a frozen prefix); "
            "with full fine-tuning there is nothing constant to cache")
    return vit.forward_prefix(
        params.vision, cfg.vision, pixel_values, dtype=DTYPES[cfg.dtype],
        attention_impl=cfg.attention_impl,
        trainable_last_k=cfg.trainable_last_k,
        static_softmax=cfg.static_softmax)


def forward_train_from_prefix(params: OwlViT, cfg: OwlViTConfig, acts):
    """forward_train continued from embed_prefix activations [B, S, D]:
    bit-identical to forward_train on the same pixels, since vit.forward is
    itself forward_prefix + forward_tail."""
    last_hidden = vit.forward_tail(params.vision, cfg.vision, acts,
                                   attention_impl=cfg.attention_impl,
                                   trainable_last_k=cfg.trainable_last_k)
    feats = _merge_feats(params, cfg, last_hidden)
    return (box_predictor(params, cfg, feats),
            class_predictor_querybank(params, cfg, feats))
