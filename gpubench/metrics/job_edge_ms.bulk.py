"""ms a bulk job holds none of its work on the card: from `serve.bulk`'s
start to its first `serve.bulk.copy` plus from its last `serve.bulk.wait`'s
end to its own end (host clock); the median over the window's jobs."""

from gpubench.metrics._spans import reading


def read(ctx):
    return reading(ctx, "job_edge_ms.bulk")
