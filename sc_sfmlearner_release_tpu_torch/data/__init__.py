"""Host data (dataset crawlers, the packed format, the batch loader, the
host transforms) and the device augmentation. The same exports as the JAX
package's ``data``; every module here is the port's own."""

from .datasets import SequenceSet, PairSet, ValidationSet
from .loader import BatchLoader
from .packed import PackedSequenceSet, pack_dataset
from . import transforms
from . import device_augment

__all__ = [
    "SequenceSet",
    "PairSet",
    "ValidationSet",
    "PackedSequenceSet",
    "pack_dataset",
    "BatchLoader",
    "transforms",
    "device_augment",
]
