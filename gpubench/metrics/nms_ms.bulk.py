"""ms of `serve.nms` on the card's stream (postprocess, NMS and pack) a
batch, from the span's two CUDA events, so the card's waits for NMS's
launches count; the median over the window's batches."""

from gpubench.metrics._spans import reading


def read(ctx):
    return reading(ctx, "nms_ms.bulk")
