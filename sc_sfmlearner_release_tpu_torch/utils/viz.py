"""Visualization helpers: depth/disparity colormapping for TensorBoard and
image dumps. The port's own copy of the JAX package's ``utils/viz.py``
(matplotlib is imported only when a colormap is first built).

Reference behavior: the reference's utils.py:12-54 — a high-resolution
magma/bone colormap and an 'opencv_rainbow' map applied to normalized depth,
plus image de-normalization for logging.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_COLORMAP_RES = 1024


def _opencv_rainbow(resolution: int = _COLORMAP_RES) -> np.ndarray:
    """OpenCV-style rainbow (reference: utils.py:12-22) sampled to [R,3]."""
    try:
        from matplotlib.colors import LinearSegmentedColormap

        data = (
            (0.000, (1.00, 0.00, 0.00)),
            (0.400, (1.00, 1.00, 0.00)),
            (0.600, (0.00, 1.00, 0.00)),
            (0.800, (0.00, 0.00, 1.00)),
            (1.000, (0.60, 0.00, 1.00)),
        )
        cmap = LinearSegmentedColormap.from_list("opencv_rainbow", data, resolution)
        return cmap(np.linspace(0, 1, resolution))[:, :3].astype(np.float32)
    except ImportError:  # pragma: no cover
        ramp = np.linspace(0, 1, resolution, dtype=np.float32)
        return np.stack([1 - ramp, np.ones_like(ramp), ramp], axis=1)


def _mpl_map(name: str, resolution: int = _COLORMAP_RES) -> np.ndarray:
    import matplotlib.cm as cm

    return cm.get_cmap(name, resolution)(np.linspace(0, 1, resolution))[:, :3].astype(
        np.float32
    )


_CMAPS = {}


def _get_cmap(name: str) -> np.ndarray:
    if name not in _CMAPS:
        _CMAPS[name] = (
            _opencv_rainbow() if name == "rainbow" else _mpl_map(name)
        )
    return _CMAPS[name]


def tensor2array(
    tensor: np.ndarray,
    max_value: Optional[float] = None,
    colormap: str = "rainbow",
) -> np.ndarray:
    """Scalar map [H,W] (or [H,W,1]) -> RGB [H,W,3] float in [0,1];
    3-channel image -> de-normalized RGB (reference: utils.py:42-54)."""
    tensor = np.asarray(tensor)
    tensor = np.squeeze(tensor)
    if tensor.ndim == 2:
        if max_value is None:
            max_value = float(tensor.max()) or 1.0
        norm = np.clip(tensor / max_value, 0.0, 1.0)
        cmap = _get_cmap(colormap)
        idx = (norm * (len(cmap) - 1)).astype(np.int32)
        return cmap[idx]
    if tensor.ndim == 3:
        if tensor.shape[0] == 3:  # CHW -> HWC
            tensor = np.transpose(tensor, (1, 2, 0))
        return np.clip(0.45 + tensor * 0.225, 0.0, 1.0)
    raise ValueError(f"unsupported tensor shape: {tensor.shape}")


def depth_visualizer(depth: np.ndarray, colormap: str = "plasma") -> np.ndarray:
    """Inverse-depth percentile-normalized visualization
    (reference: eval_depth.py:124-141)."""
    inv = 1.0 / np.maximum(depth, 1e-6)
    vmax = np.percentile(inv, 95)
    vmin = inv.min()
    norm = np.clip((inv - vmin) / max(vmax - vmin, 1e-6), 0, 1)
    cmap = _get_cmap(colormap)
    idx = (norm * (len(cmap) - 1)).astype(np.int32)
    return (cmap[idx] * 255).astype(np.uint8)
