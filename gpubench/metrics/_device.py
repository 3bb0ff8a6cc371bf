"""Readings of the traced span that several metrics share."""

from gpubench import yardstick

# device kernels of the attention forward and of its backward (the split
# pair, the fused kernel, and their helpers), by a part of their names
ATTN_FWD = ("pk_fwd",)
ATTN_BWD = ("pk_dq", "pk_dkv", "pk_bwd", "scaled_bf16")


def kernel_s(ctx: dict, patterns) -> float:
    return sum(e - s for name, s, e in ctx["trace"]["device"]
               if any(p in name for p in patterns))


def roofline_pct(ctx: dict, flops: float, patterns):
    """The least time of `flops` at the card's peak over the summed device
    time of the kernels matching `patterns`, in %; None where none ran."""
    t = kernel_s(ctx, patterns)
    if not t or not flops:
        return None
    return 100.0 * flops / ctx["peak_flops"] / t


def idle_pct(ctx: dict):
    tr = ctx["trace"]
    if not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def attn_fwd_roofline(ctx: dict):
    n = ctx["traced"].get("computed_images", ctx["traced"]["images"])
    flops = yardstick.attention_fwd_flops(ctx["config"], n, ctx["traced"]["attn_fwd_layers"])
    return roofline_pct(ctx, flops, ATTN_FWD)
