"""CLIP vision transformer (counterpart of owlvit_tpu/models/vit.py).

Patch embedding as reshape + one matmul, CLS token + learned position
embedding, pre-layernorm, N pre-LN encoder blocks, post-layernorm (applied by
the detector, see owlvit._merge_feats). NHWC images.

The token axis is not padded: the attention kernel masks ragged tiles itself,
so every token is real and the encoder passes no key mask.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from owlvit_tpu_torch.ops.flash_attention import resolve_static_max

from .configs import VisionConfig
from .layers import EncoderBlock, LayerNorm, Linear, encoder, normal


class ViT(nn.Module):
    def __init__(self, cfg: VisionConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D = cfg.hidden_size
        # weight [D, ps*ps*3], input flattened in (py, px, channel) order
        self.patch_embedding = Linear(cfg.patch_size * cfg.patch_size * 3, D,
                                      bias=False, std=0.02, generator=generator)
        self.class_embedding = nn.Parameter(normal((D,), 0.02, generator))
        self.position_embedding = nn.Parameter(
            normal((cfg.num_patches + 1, D), 0.02, generator))
        self.pre_ln = LayerNorm(D, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            EncoderBlock(D, cfg.mlp_dim, cfg.num_heads, cfg.layer_norm_eps,
                         generator=generator)
            for _ in range(cfg.num_layers)
        )
        self.post_ln = LayerNorm(D, cfg.layer_norm_eps)


def init(cfg: VisionConfig, generator: Optional[torch.Generator]) -> ViT:
    """Random-init ViT from `generator` (None: storage to load weights into)."""
    return ViT(cfg, generator=generator)


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, gh*gw, ps*ps*3] with (py, px, c) inner order."""
    B, H, W, C = pixel_values.shape
    gh, gw = H // patch_size, W // patch_size
    x = pixel_values.reshape(B, gh, patch_size, gw, patch_size, C)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, gh, gw, ps, ps, C]
    return x.reshape(B, gh * gw, patch_size * patch_size * C)


def _embed_tokens(params: ViT, cfg: VisionConfig, pixel_values, dtype):
    """Patch embed + CLS + position embed + pre-LN -> [B, 1+P, D]. The pixels
    are cast to the compute dtype before patchify, as in the JAX package."""
    x = params.patch_embedding(patchify(pixel_values.to(dtype), cfg.patch_size))
    cls = params.class_embedding.to(dtype).expand(x.shape[0], 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + params.position_embedding.to(dtype)
    return params.pre_ln(x)


def forward_prefix(params: ViT, cfg: VisionConfig, pixel_values, *,
                   dtype=torch.float32, attention_impl: str = "auto",
                   trainable_last_k: int, static_softmax: bool = False,
                   quant_backbone: bool = False):
    """Embeddings + the frozen layers[0 : L-k], under no_grad (the JAX
    package's stop_gradient). These layers never take a gradient, so three
    forward-only variants are allowed here, read as the JAX package reads
    them: the fixed-shift softmax (static_softmax, `resolve_static_max`),
    and, at call time, OWLVIT_FAST_SOFTMAX=1 (the attention kernel's
    softmax in the input dtype) and OWLVIT_QUANT_BACKBONE=1 or
    quant_backbone (every projection through the int8 `linear_q`)."""
    fast = os.environ.get("OWLVIT_FAST_SOFTMAX", "0") == "1"
    quant = quant_backbone or os.environ.get("OWLVIT_QUANT_BACKBONE") == "1"
    with torch.no_grad():
        x = _embed_tokens(params, cfg, pixel_values, dtype)
        return encoder(
            params.layers[: cfg.num_layers - trainable_last_k], x,
            impl=attention_impl,
            static_max=resolve_static_max(dtype, static_softmax),
            fast_softmax=fast, quantized=quant,
        )


def forward_tail(params: ViT, cfg: VisionConfig, acts, *,
                 attention_impl: str = "auto", trainable_last_k: int,
                 remat: bool = False):
    """The trainable layers[L-k :] over a forward_prefix output; remat
    recomputes each of them in the backward."""
    if trainable_last_k > 0:
        acts = encoder(params.layers[cfg.num_layers - trainable_last_k:], acts,
                       impl=attention_impl, remat=remat)
    return acts


def forward(params: ViT, cfg: VisionConfig, pixel_values, *,
            dtype=torch.float32, attention_impl: str = "auto",
            trainable_last_k: Optional[int] = None,
            static_softmax: bool = False, remat: bool = False,
            quant_backbone: bool = False):
    """[B, H, W, 3] -> last_hidden_state [B, 1+P, D] (before post-LN).

    trainable_last_k: if set, the first L-k layers run as a frozen prefix
    (forward_prefix) and the last k as the tail. remat: the layers that
    take a gradient are recomputed in the backward (layers.encoder)."""
    k = trainable_last_k
    if k is None or k >= cfg.num_layers:
        x = _embed_tokens(params, cfg, pixel_values, dtype)
        return encoder(params.layers, x, impl=attention_impl, remat=remat)
    acts = forward_prefix(params, cfg, pixel_values, dtype=dtype,
                          attention_impl=attention_impl, trainable_last_k=k,
                          static_softmax=static_softmax, quant_backbone=quant_backbone)
    return forward_tail(params, cfg, acts, attention_impl=attention_impl,
                        trainable_last_k=k, remat=remat)
