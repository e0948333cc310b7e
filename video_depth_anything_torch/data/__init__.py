"""Training data: VKITTI clips, Google Landmarks images, the loader."""
from .vkitti import VKITTIVideoDataset  # noqa: F401
from .landmarks import GoogleLandmarksDataset, CombinedDataset  # noqa: F401
from .loader import DataLoader  # noqa: F401
