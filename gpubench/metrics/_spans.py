"""Readings of the program's spans, which a `--trace 1` run records over its
window (the window dict's `spans`): gpubench/spans.py's READINGS."""

from gpubench import spans


def reading(ctx: dict, name: str):
    """spans.READINGS[name] of the window's spans; None where they do not
    hold it (a program without these spans, a run without the recorder)."""
    return spans.READINGS[name](ctx["window"].get("spans", []))
