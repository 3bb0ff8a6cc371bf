from .dataset import DetectionDataset, batch_iterator  # noqa: F401
from .loader import prefetch_to_device  # noqa: F401
