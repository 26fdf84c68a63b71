"""Image IO for the dataset crawlers.

The port's own copy of the JAX package's ``data/native_io.py`` without its
C++ fast path: the port has no build of ``native/scdepth_io.cpp`` yet, so
every decode goes through ``imageio`` (and ``cv2`` for a resize), as the
JAX module does when its extension is not built. Where neither is
installed, train from a packed dataset (``--packed``): it was decoded once,
at pack time, and needs no decoder.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

NO_DECODER = (
    "reading JPEG frames needs imageio (and cv2 to resize), which are not "
    "installed; pack the dataset once where they are (python -m "
    "sc_sfmlearner_release_tpu_torch.data.packed DIR) and train with --packed"
)


def _imageio():
    try:
        import imageio.v2 as imageio
    except ImportError as exc:
        raise ImportError(NO_DECODER) from exc
    return imageio


def imread_f32(path: str, height: Optional[int] = None,
               width: Optional[int] = None) -> np.ndarray:
    """Load an RGB image as float32 [0, 255] HWC, optionally resized."""
    img = np.asarray(_imageio().imread(path)).astype(np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    img = img[..., :3]
    if height is not None and (img.shape[0] != height or img.shape[1] != width):
        try:
            import cv2
        except ImportError as exc:
            raise ImportError(NO_DECODER) from exc

        interp = (
            cv2.INTER_AREA
            if img.shape[0] > height or img.shape[1] > width
            else cv2.INTER_LINEAR
        )
        img = cv2.resize(img, (width, height), interpolation=interp)
    return img


def imread_u8(path: str) -> np.ndarray:
    """Load an RGB image as uint8 HWC at native resolution (packed ETL)."""
    img = np.asarray(_imageio().imread(path))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3].astype(np.uint8)

