from .viz import tensor2array, depth_visualizer
from .meters import AverageMeter, ProgressLogger, TermLogger, make_logger
from .profiling import trace, enable_nan_debugging

__all__ = [
    "tensor2array",
    "depth_visualizer",
    "AverageMeter",
    "ProgressLogger",
    "TermLogger",
    "make_logger",
    "trace",
    "enable_nan_debugging",
]
