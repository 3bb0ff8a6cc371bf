"""The median over the window's steps of the time between two of the
trainer's phase marks (CUDA events the harness records)."""

import statistics


def median_ms(ctx: dict, phase: str):
    ms = ctx["window"].get("phase_ms", {}).get(phase)
    return statistics.median(ms) if ms else None
