"""The attention backward's share of its roofline, in %: 2.5x the
forward's FLOPs (FlashAttention's count: the scores again, dV, dP, dQ, dK)
for every image and trained layer of the traced span, at the card's bf16
peak, over the summed device time of the backward's kernels (pk_dq,
pk_dkv, the fused pk_bwd and their helpers)."""

from gpubench import yardstick
from gpubench.metrics._device import ATTN_BWD, roofline_pct


def read(ctx):
    tr = ctx["traced"]
    flops = yardstick.attention_bwd_flops(ctx["config"], tr["images"], tr["attn_bwd_layers"])
    return roofline_pct(ctx, flops, ATTN_BWD)
