"""ms of `serve.forward` on the card's stream (normalize, the ViT, the
heads) a batch, from the span's two CUDA events; the median over the
window's batches."""

from gpubench.metrics._spans import reading


def read(ctx):
    return reading(ctx, "forward_ms.bulk")
