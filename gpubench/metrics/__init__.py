"""One reader per per-layer metric, found by the metric's name: <name>.py
with read(ctx) -> a number, or None where the run gives it nothing to
read."""
