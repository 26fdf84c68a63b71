"""Frozen yardsticks: the card's peaks, the kernel-name groups of a device
trace, interval arithmetic, and a kernel's share of its bandwidth bound
(the bytes of its launches come from the family: ``families/<family>/
kernels.py``). Imports nothing of the port, so no later change to the
program can move them.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

# NVIDIA's H100 SXM data sheet, dense (no sparsity): bf16 tensor-core peak and
# HBM3 bandwidth.
PEAK_BF16_FLOPS = 989.4e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# First match wins: the backward kernels before the forwards, cuDNN's
# BatchNorm and layout kernels before its convolutions (the port's
# tools/profile_step.py groups, frozen here), NCCL before everything. A
# family's own groups (``kernels.GROUPS``) take only what none of these
# holds, so the shared per-layer metrics count the same kernels in every
# cell.
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


def group_of(kernel: str, groups=()) -> str:
    """The group of a kernel's name: the first of ``KERNEL_GROUPS`` and
    then of ``groups`` (a family's own, ``kernels.GROUPS``) whose patterns
    it holds."""
    key = kernel.lower()
    return next((g for g, pats in KERNEL_GROUPS + tuple(groups)
                 if any(p in key for p in pats)), "other")


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


def group_us(kernels, steps: int, groups=()) -> Dict[str, float]:
    """Device us per step by group from ``(name, start_us, end_us)`` records."""
    out: Dict[str, float] = {}
    for name, start, end in kernels:
        g = group_of(name, groups)
        out[g] = out.get(g, 0.0) + (end - start) / steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def roofline_pct(kernel: str, rec: dict):
    """The share of ``kernel``'s bandwidth bound in its traced device time
    per launch (every launch of a step and scale has the cell's shapes),
    %; None where the trace holds none of it. The bytes of one launch are
    ``rec["kernel_bytes"][kernel]`` (the family's, at the cell's shapes).
    Per launch, so a record the profiler dropped cannot raise the share."""
    trace = rec.get("trace")
    if not trace:
        return None
    groups = rec.get("groups", ())
    spans = [end - start for name, start, end in trace["kernels"]
             if group_of(name, groups) == kernel]
    if not spans or sum(spans) <= 0:
        return None
    bound_s = rec["kernel_bytes"][kernel] / PEAK_HBM_BYTES_PER_S
    return 100.0 * bound_s / (sum(spans) * 1e-6 / len(spans))
