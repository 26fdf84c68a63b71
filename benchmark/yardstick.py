"""Frozen yardsticks: the card's peaks, the kernels' bytes as functions of
their shapes, the kernel-name groups of a device trace, and interval
arithmetic. Imports nothing of the port, so no later change to the program
can move them.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

# NVIDIA's H100 SXM data sheet, dense (no sparsity): bf16 tensor-core peak and
# HBM3 bandwidth.
PEAK_BF16_FLOPS = 989.4e12
PEAK_HBM_BYTES_PER_S = 3.35e12
F32 = 4

# First match wins: the backward kernels before the forwards, cuDNN's
# BatchNorm and layout kernels before its convolutions (the port's
# tools/profile_step.py groups, frozen here), NCCL before everything.
KERNEL_GROUPS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("nccl", ("nccl",)),
    ("warp_sample_bwd", ("warp_sample_bwd",)),
    ("warp_sample", ("warp_sample",)),
    ("ssim_bwd", ("ssim_bwd_kernel",)),
    ("ssim", ("ssim_kernel",)),
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("layout", ("nchwtonhwc", "nhwctonchw")),
    ("conv/gemm", ("conv", "xmma", "cudnn", "gemm", "implicit", "winograd", "fft", "dgrad",
                   "wgrad")),
    ("optimizer", ("multi_tensor", "adam")),
    ("copy/cast", ("copy", "memcpy", "memset", "catarray")),
    ("reduce", ("reduce",)),
    ("pad/pool/upsample", ("reflection", "pool", "upsample")),
    ("elementwise", ("elementwise",)),
)
NETWORK_GROUPS = ("conv/gemm", "batch_norm", "layout")


def group_of(kernel: str) -> str:
    key = kernel.lower()
    return next((g for g, pats in KERNEL_GROUPS if any(p in key for p in pats)), "other")


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def gaps(intervals: Iterable[Tuple[float, float]]):
    """The holes ``(start, end)`` between the union's pieces, in order."""
    out, reach = [], None
    for start, end in sorted(intervals):
        if reach is not None and start > reach:
            out.append((reach, start))
        reach = end if reach is None else max(reach, end)
    return out


def group_us(kernels, steps: int) -> Dict[str, float]:
    """Device us per step by group from ``(name, start_us, end_us)`` records."""
    out: Dict[str, float] = {}
    for name, start, end in kernels:
        g = group_of(name)
        out[g] = out.get(g, 0.0) + (end - start) / steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


# Bytes of one launch of each kernel of the port at one scale: each input
# read once and each output written once, float32. F = 2 N B directed pairs
# of H x W pixels; the warp samples a 4-channel source (depth and RGB) and
# its backward returns the coordinates' gradient and the depth channel's.
def warp_sample_bytes(f: int, h: int, w: int, c: int = 4) -> int:
    src, coords, out = f * h * w * c, f * h * w * 2, f * h * w * c
    return F32 * (src + coords + out)


def warp_sample_bwd_bytes(f: int, h: int, w: int, c: int = 4, grad_channels: int = 1) -> int:
    src, coords, dout = f * h * w * c, f * h * w * 2, f * h * w * c
    dcoords, dsrc = f * h * w * 2, f * h * w * grad_channels
    return F32 * (src + coords + dout + dcoords + dsrc)


def ssim_bytes(f: int, h: int, w: int, c: int = 3) -> int:
    return F32 * 3 * f * c * h * w  # x, y read; the map written


def ssim_bwd_bytes(f: int, h: int, w: int, c: int = 3) -> int:
    return F32 * 4 * f * c * h * w  # x, y, the map's gradient read; d/dy written


KERNEL_BYTES = {
    "warp_sample": warp_sample_bytes,
    "warp_sample_bwd": warp_sample_bwd_bytes,
    "ssim": ssim_bytes,
    "ssim_bwd": ssim_bwd_bytes,
}


def roofline_pct(kernel: str, rec: dict):
    """The share of ``kernel``'s bandwidth bound in its traced device time
    per launch (every launch of a step and scale has the cell's shapes),
    %; None where the trace holds none of it. Per launch, so a record the
    profiler dropped cannot raise the share."""
    trace = rec.get("trace")
    if not trace:
        return None
    spans = [end - start for name, start, end in trace["kernels"] if group_of(name) == kernel]
    if not spans or sum(spans) <= 0:
        return None
    s = rec["shapes"]
    bound_s = KERNEL_BYTES[kernel](s["pairs"], s["height"], s["width"]) / PEAK_HBM_BYTES_PER_S
    return 100.0 * bound_s / (sum(spans) * 1e-6 / len(spans))
