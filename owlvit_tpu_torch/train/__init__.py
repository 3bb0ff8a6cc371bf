from . import checkpoint  # noqa: F401
from .state import partition_params  # noqa: F401
from .trainer import Trainer, lr_schedule  # noqa: F401
