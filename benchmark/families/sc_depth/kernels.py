"""The ``sc_depth`` family's kernels at a cell's shapes: the launch shapes
that ``run.records`` hands the readers, and the bytes of one launch of each
of the port's kernels as a function of them (``yardstick.roofline_pct``).
Each input is read once and each output written once, float32. F = 2 N B
directed pairs of H x W pixels, one scale; the warp samples a 4-channel
source (depth and RGB) and its backward returns the coordinates' gradient
and the depth channel's.
"""

from __future__ import annotations

F32 = 4


def shapes(cfg: dict, traffic: dict) -> dict:
    """One card's launch shapes: ``pairs`` (F), ``height``, ``width``."""
    n = cfg["sequence_length"] - 1
    return {"pairs": 2 * n * cfg["batch_size"], "height": cfg["height"], "width": cfg["width"]}


def _pixels(s: dict) -> int:
    return s["pairs"] * s["height"] * s["width"]


def warp_sample_bytes(s: dict, c: int = 4) -> int:
    src, coords, out = _pixels(s) * c, _pixels(s) * 2, _pixels(s) * c
    return F32 * (src + coords + out)


def warp_sample_bwd_bytes(s: dict, c: int = 4, grad_channels: int = 1) -> int:
    src, coords, dout = _pixels(s) * c, _pixels(s) * 2, _pixels(s) * c
    dcoords, dsrc = _pixels(s) * 2, _pixels(s) * grad_channels
    return F32 * (src + coords + dout + dcoords + dsrc)


def ssim_bytes(s: dict, c: int = 3) -> int:
    return F32 * 3 * c * _pixels(s)  # x, y read; the map written


def ssim_bwd_bytes(s: dict, c: int = 3) -> int:
    return F32 * 4 * c * _pixels(s)  # x, y, the map's gradient read; d/dy written


KERNEL_BYTES = {
    "warp_sample": warp_sample_bytes,
    "warp_sample_bwd": warp_sample_bwd_bytes,
    "ssim": ssim_bytes,
    "ssim_bwd": ssim_bwd_bytes,
}
