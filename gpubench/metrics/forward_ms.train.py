"""ms from the step's start to its "forward" mark: the forward of the tail
(cached) or of every layer (uncached) and the heads; the median over the
window's steps."""

from gpubench.metrics._phase import median_ms


def read(ctx):
    return median_ms(ctx, "forward")
