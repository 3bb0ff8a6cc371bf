from .configs import OwlViTConfig, TextConfig, VisionConfig, get_config  # noqa: F401
from . import owlvit, text  # noqa: F401
