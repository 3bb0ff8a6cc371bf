from .logging import JSONLLogger, LossAccumulator, ProgressFormatter  # noqa: F401
from .config import load_config  # noqa: F401
