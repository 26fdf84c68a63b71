"""Odometry evaluation: the port's copy of the JAX package's ``evaluation``."""

from .odometry import (
    KittiOdomEvaluator,
    load_poses_txt,
    umeyama_alignment,
    scale_lse_solver,
)

__all__ = [
    "KittiOdomEvaluator",
    "load_poses_txt",
    "umeyama_alignment",
    "scale_lse_solver",
]
