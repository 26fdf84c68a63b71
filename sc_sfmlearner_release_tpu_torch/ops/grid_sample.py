"""Plain bilinear grid sampling on NHWC tensors.

Semantics of ``torch.nn.functional.grid_sample`` with ``mode='bilinear'``
and ``align_corners=False``, written as the gather formulation of the JAX
package's ``ops/grid_sample.py``: unnormalize, clip (border), floor, mask
the zero-padded taps, clamp the indices, weighted sum of four taps. It is
the plain version of the warp kernel (``ops/warp.py``), which computes the
same arithmetic in the same order.

Coordinates: ``coords[..., 0]`` is x (width), ``coords[..., 1]`` is y
(height), both normalized to [-1, 1] over the source image.
"""

from __future__ import annotations

import torch


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    # align_corners=False: -1 maps to -0.5, +1 maps to size - 0.5.
    return ((coord + 1.0) * size - 1.0) / 2.0


def grid_sample(
    img: torch.Tensor, coords: torch.Tensor, padding_mode: str = "zeros"
) -> torch.Tensor:
    """Sample ``img`` ``[B, H, W, C]`` at ``coords`` ``[B, Ho, Wo, 2]``.

    Returns ``[B, Ho, Wo, C]``. ``padding_mode`` is ``"zeros"`` or
    ``"border"``.
    """
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    b, h, w, c = img.shape
    x = _unnormalize(coords[..., 0], w)
    y = _unnormalize(coords[..., 1], h)
    if padding_mode == "border":
        x = x.clamp(0.0, w - 1.0)
        y = y.clamp(0.0, h - 1.0)

    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = x - x0f  # weight of the x1 tap
    wy = y - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    x1 = x0 + 1
    y1 = y0 + 1

    w00 = (1.0 - wy) * (1.0 - wx)
    w01 = (1.0 - wy) * wx
    w10 = wy * (1.0 - wx)
    w11 = wy * wx
    if padding_mode == "zeros":
        vx0 = (x0 >= 0) & (x0 <= w - 1)
        vx1 = (x1 >= 0) & (x1 <= w - 1)
        vy0 = (y0 >= 0) & (y0 <= h - 1)
        vy1 = (y1 >= 0) & (y1 <= h - 1)
        zero = torch.zeros((), dtype=w00.dtype, device=w00.device)
        w00 = torch.where(vy0 & vx0, w00, zero)
        w01 = torch.where(vy0 & vx1, w01, zero)
        w10 = torch.where(vy1 & vx0, w10, zero)
        w11 = torch.where(vy1 & vx1, w11, zero)

    x0c, x1c = x0.clamp(0, w - 1), x1.clamp(0, w - 1)
    y0c, y1c = y0.clamp(0, h - 1), y1.clamp(0, h - 1)
    flat = img.reshape(b, h * w, c)

    def gather(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(yi.shape + (c,))

    out = (
        w00[..., None] * gather(y0c, x0c)
        + w01[..., None] * gather(y0c, x1c)
        + w10[..., None] * gather(y1c, x0c)
        + w11[..., None] * gather(y1c, x1c)
    )
    return out.to(img.dtype)
