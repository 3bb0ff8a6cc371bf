"""OWL-ViT detector (counterpart of owlvit_tpu/models/owlvit.py): the
query-bank path (`init`, `image_embedder`, `_merge_feats`, `box_predictor`,
`class_embeds`, `class_predictor_querybank`, `forward_train`,
`embed_prefix`, `forward_train_from_prefix`, `build_query_bank`) and the
open-vocabulary heads (`class_predictor`, `forward_zero_shot`,
`embed_image_query`, `forward_one_shot`).

The parameters live in an `OwlViT` module whose attribute names follow the
JAX parameter tree; the functions below keep the JAX package's signatures
with that module in the place of the tree.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from owlvit_tpu_torch.ops import boxes as box_ops
from owlvit_tpu_torch.ops.box_bias import compute_box_bias

from . import text as text_model
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
    """dense0 projects image features (both heads); logit_shift and
    logit_scale belong to the open-vocabulary head, `class_predictor`."""

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
        # drawn last, so that the draws of every other parameter are those
        # of a detector without it
        self.text = text_model.init(cfg.text, cfg.projection_dim, generator)


def init(cfg: OwlViTConfig, generator: torch.Generator,
         num_queries: Optional[int] = None,
         device: Optional[torch.device] = None) -> OwlViT:
    """Random-init detector on `device` (drawn on the CPU from `generator`).
    num_queries adds a query bank [num_queries, projection_dim]."""
    return OwlViT(cfg, num_queries, generator=generator).to(device)


def build_query_bank(params: OwlViT, cfg: OwlViTConfig, input_ids,
                     attention_mask=None) -> torch.Tensor:
    """Class-prompt token ids [Q, S] -> the L2-normalised projected text
    embeddings [Q, projection_dim], fp32: the query bank (the reference
    builds it once at model load, models.py:162-171)."""
    t = text_model.forward(params.text, cfg.text, input_ids, attention_mask)
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)


def image_embedder(params: OwlViT, cfg: OwlViTConfig, pixel_values):
    """[B, H, W, 3] -> image_feats [B, P, D]."""
    last_hidden = vit.forward(
        params.vision, cfg.vision, pixel_values,
        dtype=DTYPES[cfg.dtype], attention_impl=cfg.attention_impl,
        trainable_last_k=cfg.trainable_last_k,
        static_softmax=cfg.static_softmax, remat=cfg.remat,
        quant_backbone=cfg.quant_backbone,
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
        static_softmax=cfg.static_softmax, quant_backbone=cfg.quant_backbone)


def forward_train_from_prefix(params: OwlViT, cfg: OwlViTConfig, acts):
    """forward_train continued from embed_prefix activations [B, S, D]:
    bit-identical to forward_train on the same pixels, since vit.forward is
    itself forward_prefix + forward_tail."""
    last_hidden = vit.forward_tail(params.vision, cfg.vision, acts,
                                   attention_impl=cfg.attention_impl,
                                   trainable_last_k=cfg.trainable_last_k,
                                   remat=cfg.remat)
    feats = _merge_feats(params, cfg, last_hidden)
    return (box_predictor(params, cfg, feats),
            class_predictor_querybank(params, cfg, feats))


def class_predictor(params: OwlViT, cfg: OwlViTConfig, image_feats,
                    query_embeds, query_mask=None):
    """HF-style class head with the learned logit shift and scale (the
    zero-shot and one-shot head; modeling_owlvit.py:1144-1177).

    image_feats [B, P, D], query_embeds [B, Q, proj] -> logits [B, P, Q]
    fp32. Both sides L2-normalised (+1e-6); a query whose mask is 0 gets
    fp32's lowest value."""
    head = params.class_head
    img = class_embeds(params, image_feats).float()
    img = img / (torch.linalg.vector_norm(img, dim=-1, keepdim=True) + 1e-6)
    q = query_embeds.float()
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6)
    logits = img @ q.transpose(-1, -2)
    shift = head.logit_shift(image_feats).float()
    scale = F.elu(head.logit_scale(image_feats).float()) + 1.0
    logits = (logits + shift) * scale
    if query_mask is not None:
        logits = torch.where(query_mask[:, None, :] > 0, logits,
                             torch.finfo(torch.float32).min)
    return logits


def forward_zero_shot(params: OwlViT, cfg: OwlViTConfig, pixel_values,
                      input_ids, attention_mask=None):
    """Text-conditioned open-vocabulary detection (HF forward, :1560-1650).

    input_ids [Q, S]: one query set shared by the batch; a query whose first
    token id is 0 is masked. -> (pred_boxes xyxy [B, P, 4], logits
    [B, P, Q])."""
    feats = image_embedder(params, cfg, pixel_values)
    pred_boxes = box_predictor(params, cfg, feats)
    B, Q = feats.shape[0], input_ids.shape[0]
    # OwlViTModel.forward normalises the text embeddings (:1084)
    text = build_query_bank(params, cfg, input_ids, attention_mask)
    query_embeds = text[None].expand(B, *text.shape)
    query_mask = (input_ids[:, 0] > 0).int()[None].expand(B, Q)
    return pred_boxes, class_predictor(params, cfg, feats, query_embeds,
                                       query_mask)


def embed_image_query(params: OwlViT, cfg: OwlViTConfig, query_pixel_values):
    """One-shot (image-conditioned) queries, OWLv2 style: per query image,
    the predicted boxes within 80% of the best IoU with the whole image
    ([0, 0, 1, 1]; GIoU when every IoU is 0), and among them the embedding
    least similar to the mean patch embedding (the first index on ties).

    -> (query_embeds [B, proj], best_box_idx [B], pred_boxes [B, P, 4])."""
    feats = image_embedder(params, cfg, query_pixel_values)
    embeds = class_embeds(params, feats)  # [B, P, proj]
    pred_boxes = box_predictor(params, cfg, feats)  # xyxy [B, P, 4]
    full = pred_boxes.new_tensor([0.0, 0.0, 1.0, 1.0]).expand_as(pred_boxes)
    iou = box_ops.elementwise_iou(full, pred_boxes)  # [B, P]
    giou = box_ops.elementwise_giou(full, pred_boxes)
    # HF falls back to GIoU when nothing overlaps (torch.all(ious == 0))
    use_giou = (iou == 0.0).all(dim=-1, keepdim=True)
    score = torch.where(use_giou, giou, iou)
    selected = score >= score.amax(dim=-1, keepdim=True) * 0.8
    mean_embed = embeds.mean(dim=1, keepdim=True)  # [B, 1, proj]
    mean_sim = (embeds @ mean_embed.transpose(-1, -2))[..., 0]  # [B, P]
    masked = torch.where(selected, mean_sim, torch.full_like(mean_sim, float("inf")))
    best = torch.argmin(masked, dim=-1)  # the first minimal index
    query_embeds = torch.gather(
        embeds, 1, best[:, None, None].expand(-1, 1, embeds.shape[-1]))[:, 0]
    return query_embeds, best, pred_boxes


def forward_one_shot(params: OwlViT, cfg: OwlViTConfig, pixel_values,
                     query_pixel_values):
    """Image-guided detection (HF image_guided_detection, :1425+).

    -> (pred_boxes xyxy [B, P, 4], logits [B, P, 1])."""
    query_embeds, _, _ = embed_image_query(params, cfg, query_pixel_values)
    feats = image_embedder(params, cfg, pixel_values)
    pred_boxes = box_predictor(params, cfg, feats)
    return pred_boxes, class_predictor(params, cfg, feats, query_embeds[:, None, :])
