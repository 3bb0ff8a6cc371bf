"""CLIP text transformer (counterpart of owlvit_tpu/models/text.py).

Token + position embeddings, a causal pre-LN encoder (quick_gelu MLPs) with
an additive padding bias (-1e9 on padded keys), the final LayerNorm, EOT
pooling (the argmax of the token ids: EOT is the highest id of the CLIP
vocab) and the bias-free text projection. Used once, at set-up, to build
the query bank (owlvit.build_query_bank).

The JAX package runs this tower through its XLA attention, never through a
Pallas kernel (a biased or causal call takes that path, `attention_impl`
"xla" being its default), and so does the port: the encoder blocks take the
plain biased attention of models/layers.py. It runs in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .configs import TextConfig
from .layers import EncoderBlock, LayerNorm, Linear, normal


class TextTower(nn.Module):
    """Parameter names follow the JAX tree (`token_embedding`,
    `position_embedding`, `layers`, `final_ln`, `projection`)."""

    def __init__(self, cfg: TextConfig, projection_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H = cfg.hidden_size
        self.token_embedding = nn.Parameter(normal((cfg.vocab_size, H), 0.02, generator))
        self.position_embedding = nn.Parameter(normal((cfg.max_len, H), 0.02, generator))
        self.layers = nn.ModuleList(
            EncoderBlock(H, cfg.mlp_dim, cfg.num_heads, cfg.layer_norm_eps,
                         generator=generator)
            for _ in range(cfg.num_layers)
        )
        self.final_ln = LayerNorm(H, cfg.layer_norm_eps)
        self.projection = Linear(H, projection_dim, bias=False, generator=generator)


def init(cfg: TextConfig, projection_dim: int,
         generator: Optional[torch.Generator]) -> TextTower:
    """Random-init tower from `generator` (None: storage to load weights into)."""
    return TextTower(cfg, projection_dim, generator=generator)


def forward(params: TextTower, cfg: TextConfig, input_ids: torch.Tensor,
            attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """input_ids [N, S] -> projected pooled text embeds [N, projection_dim],
    unnormalised (callers normalise, as OwlViTModel.forward does).

    The causal mask enters the scores as fp32's lowest value on the keys
    after each query, the padding mask as -1e9 on padded keys: the same
    scores as the JAX package's `where` then `+ bias`, since adding a score
    to fp32's lowest value rounds to that value."""
    N, S = input_ids.shape
    ids = input_ids.long()
    x = params.token_embedding[ids] + params.position_embedding[:S]
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    bias = torch.zeros((S, S), device=x.device).masked_fill(
        ~causal, torch.finfo(torch.float32).min)[None, None]
    if attention_mask is not None:
        pad = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9)
        bias = bias + pad.to(device=x.device, dtype=torch.float32)
    for block in params.layers:
        x = block(x, bias=bias)
    x = params.final_ln(x)
    eot = ids.argmax(dim=-1)  # the first maximal index, as jnp.argmax
    pooled = x[torch.arange(N, device=x.device), eot]
    return params.projection(pooled)
