"""Host ms of `train.input` (the step's start to its "input" mark: the
ground truth's and the pixels' copies to the card); the median over the
window's steps."""

from gpubench.metrics._spans import reading


def read(ctx):
    return reading(ctx, "input_ms.train")
