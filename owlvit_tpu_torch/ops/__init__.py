from . import boxes, box_bias  # noqa: F401
