"""Visualization helpers: depth/disparity colormapping for TensorBoard and
image dumps. The port's own copy of the JAX package's ``utils/viz.py``.

Reference behavior: the reference's utils.py:12-54 — a high-resolution
magma/bone colormap and an 'opencv_rainbow' map applied to normalized depth,
plus image de-normalization for logging.

``bone`` and ``rainbow`` are built in numpy from their segment data, as
matplotlib's ``LinearSegmentedColormap`` builds its lookup table (linear
interpolation at ``linspace(0, 1, N)``), so the CLIs that use them need no
matplotlib. Every other map (``magma``, ``plasma``) is matplotlib's own and
raises ``ImportError`` where matplotlib is not installed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_COLORMAP_RES = 1024

# (x, value) stops per channel: matplotlib's ``_cm.py`` ``_bone_data``.
_BONE = (
    ((0.0, 0.0), (0.746032, 0.652778), (1.0, 1.0)),
    ((0.0, 0.0), (0.365079, 0.319444), (0.746032, 0.777778), (1.0, 1.0)),
    ((0.0, 0.0), (0.365079, 0.444444), (1.0, 1.0)),
)
# OpenCV-style rainbow (reference: utils.py:12-22): (x, (r, g, b)) stops.
_RAINBOW = (
    (0.000, (1.00, 0.00, 0.00)),
    (0.400, (1.00, 1.00, 0.00)),
    (0.600, (0.00, 1.00, 0.00)),
    (0.800, (0.00, 0.00, 1.00)),
    (1.000, (0.60, 0.00, 1.00)),
)


def _segments(channels, resolution: int = _COLORMAP_RES) -> np.ndarray:
    """``[resolution, 3]`` float32 table of per-channel ``(x, value)`` stops."""
    x = np.linspace(0, 1, resolution)
    return np.stack([np.interp(x, *np.asarray(stops).T) for stops in channels],
                    axis=1).astype(np.float32)


def _opencv_rainbow(resolution: int = _COLORMAP_RES) -> np.ndarray:
    return _segments([[(x, rgb[i]) for x, rgb in _RAINBOW] for i in range(3)], resolution)


def _bone(resolution: int = _COLORMAP_RES) -> np.ndarray:
    return _segments(_BONE, resolution)


def _mpl_map(name: str, resolution: int = _COLORMAP_RES) -> np.ndarray:
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            f"the {name!r} colormap is matplotlib's, which is not installed; "
            "'bone' and 'rainbow' need no matplotlib") from exc
    cmap = matplotlib.colormaps[name].resampled(resolution)
    return cmap(np.linspace(0, 1, resolution))[:, :3].astype(np.float32)


_CMAPS = {}


def _get_cmap(name: str) -> np.ndarray:
    if name not in _CMAPS:
        numpy_tables = {"rainbow": _opencv_rainbow, "bone": _bone}
        _CMAPS[name] = numpy_tables[name]() if name in numpy_tables else _mpl_map(name)
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
