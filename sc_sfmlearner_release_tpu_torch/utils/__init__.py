from .viz import tensor2array, depth_visualizer
from .meters import AverageMeter, ProgressLogger, TermLogger, make_logger

__all__ = [
    "tensor2array",
    "depth_visualizer",
    "AverageMeter",
    "ProgressLogger",
    "TermLogger",
    "make_logger",
]
