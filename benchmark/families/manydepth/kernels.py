"""The ``manydepth`` family's kernels at a cell's shapes: the launch shapes
that ``run.records`` hands the readers, and the bytes of one launch of each
of the port's kernels as a function of them (``yardstick.roofline_pct``),
each input read once and each output written once, float32.

The losses' launches: F = 2 B pairs (each reference against frame 0) of
H x W pixels, every scale upsampled to the full size, so each SSIM and
warp launch of a step has the same shape; the warp samples the 3 RGB
channels and its backward returns the coordinates' gradient alone. The
cost volume: B current and B lookup feature maps of C channels at a
quarter of the size, D bins; it writes the volume, the lowest-cost
disparity and the confidence mask.
"""

from __future__ import annotations

F32 = 4

# The cost volume's kernel, in a group of its own (``yardstick.group_of``).
GROUPS = (("cost_volume", ("cost_volume_kernel",)),)


def shapes(cfg: dict, traffic: dict) -> dict:
    """One card's launch shapes: ``pairs`` (F), ``height``, ``width`` of the
    losses, and ``batch``, ``channels``, ``bins``, ``match_height``,
    ``match_width`` of the cost volume."""
    b = cfg["batch_size"]
    return {"pairs": 2 * b, "height": cfg["height"], "width": cfg["width"], "batch": b,
            "channels": cfg["matching_channels"], "bins": cfg["num_depth_bins"],
            "match_height": cfg["height"] // 4, "match_width": cfg["width"] // 4}


def _pixels(s: dict) -> int:
    return s["pairs"] * s["height"] * s["width"]


def warp_sample_bytes(s: dict, c: int = 3) -> int:
    return F32 * _pixels(s) * (c + 2 + c)  # source, coordinates read; samples written


def warp_sample_bwd_bytes(s: dict, c: int = 3) -> int:
    return F32 * _pixels(s) * (c + 2 + c + 2)  # source, coordinates, d(out) read; d(coords)


def ssim_bytes(s: dict, c: int = 3) -> int:
    return F32 * 3 * c * _pixels(s)  # x, y read; the map written


def ssim_bwd_bytes(s: dict, c: int = 3) -> int:
    return F32 * 4 * c * _pixels(s)  # x, y, the map's gradient read; d/dy written


def cost_volume_bytes(s: dict) -> int:
    plane = s["batch"] * s["match_height"] * s["match_width"]
    features = 2 * s["channels"] * plane  # current and lookup read
    written = (s["bins"] + 2) * plane  # the volume, the lowest cost, the confidence
    return F32 * (features + written + s["batch"] * (12 + 9) + s["bins"])


KERNEL_BYTES = {
    "warp_sample": warp_sample_bytes,
    "warp_sample_bwd": warp_sample_bwd_bytes,
    "ssim": ssim_bytes,
    "ssim_bwd": ssim_bwd_bytes,
    "cost_volume": cost_volume_bytes,
}
