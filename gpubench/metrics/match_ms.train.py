"""ms from the "cost" mark to the "match" mark: the assignment and the
label propagation; the median over the window's steps."""

from gpubench.metrics._phase import median_ms


def read(ctx):
    return median_ms(ctx, "match")
