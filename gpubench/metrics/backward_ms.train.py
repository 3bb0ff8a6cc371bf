"""ms from the "loss" mark to the "backward" mark: the backward through the
trained layers and the heads; the median over the window's steps."""

from gpubench.metrics._phase import median_ms


def read(ctx):
    return median_ms(ctx, "backward")
