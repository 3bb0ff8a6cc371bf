"""The share of the traced span, in %, in which no kernel, copy or memset
ran on the card: 1 - (the union of the device events' intervals) / (the
span from its first event to its last, host events included)."""

from gpubench.metrics._device import idle_pct


def read(ctx):
    return idle_pct(ctx)
