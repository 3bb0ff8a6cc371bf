"""The attention forward's share of its roofline, in %: 4 B H S^2 hd FLOPs
for every image and layer the traced span ran through the kernel, at the
card's bf16 peak, over the summed device time of the pk_fwd kernels. Work
counted from the shapes, so it does not depend on which kernel or how many
launches do it."""

from gpubench.metrics._device import attn_fwd_roofline


def read(ctx):
    return attn_fwd_roofline(ctx)
