from . import distributed
from .prefetch import device_prefetch

__all__ = ["device_prefetch", "distributed"]
