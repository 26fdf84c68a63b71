"""Device time of the train step by kernel group, from a torch.profiler trace.

The counterpart of the repository's ``tools/profile_step.py``: it traces
``--steps`` warm dispatches of the train step at B4 N2 832x256 (ResNet-18,
bf16 convolutions, Adam, SSIM and both masks, the device augmentation of
uint8 frames unless ``--no-augment``) as ``make_train_step(fused_steps=K)``,
one CUDA-graph replay of K steps (``--fused``, default 16), or with
``--eager`` as eager steps, and prints the device ms per optimizer step by
group (:data:`KERNEL_GROUPS`: convolutions, each of the port's four
kernels, BatchNorm, elementwise, pad/pool/upsample, cuDNN's layout
transposes, copies and casts, reductions, Adam, other), the device's
window per step from each dispatch's first record to its last and the
idle time between records in it, then the top ``--top`` kernels. On a
torch build whose profiler records no kernel of a graph replay it exits
non-zero and says so.

The grouping and the trace summaries here are also what ``chip_smoke.py``
prints for its ``--profile`` windows and its ``--profile-dir`` traces.

    python -m sc_sfmlearner_release_tpu_torch.tools.profile_step [--fused 16] [--eager]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import cli_device
from ..utils.profiling import card_line
from .ablate_step import build

# First match wins: the backward kernels before the forwards, cuDNN's
# BatchNorm and layout kernels before its convolutions.
KERNEL_GROUPS = (
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
PORT_KERNELS = ("warp_sample_bwd", "warp_sample", "ssim_bwd_kernel", "ssim_kernel")
Rows = List[Tuple[float, int, str]]


def group_of(kernel: str) -> str:
    key = kernel.lower()
    return next((g for g, pats in KERNEL_GROUPS if any(p in key for p in pats)), "other")


def group_ms(rows: Rows, steps: int) -> Dict[str, float]:
    """Device ms per step by group from (device us, count, kernel) rows."""
    groups: Dict[str, float] = {}
    for us, _, key in rows:
        g = group_of(key)
        groups[g] = groups.get(g, 0.0) + us / 1e3 / steps
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


CALL_GAP_US = 500.0  # device idle longer than this separates two calls' work


def call_windows_ms(intervals) -> float:
    """The device's time from the first to the last record of each call,
    summed over the calls, ms: ``(start_us, end_us)`` records of calls that
    each end in a synchronize, split where the device idles longer than
    CALL_GAP_US (the host's turn between calls)."""
    total, first, reach = 0.0, None, None
    for start, end in sorted(intervals):
        if reach is not None and start - reach > CALL_GAP_US:
            total += reach - first
            first = None
        first = start if first is None else first
        reach = end if reach is None else max(reach, end)
    return (total + (reach - first if reach is not None else 0.0)) / 1e3


def profile_window(step, batch, calls: int):
    """One profiled window of ``calls`` calls of ``step``: (rows of (device
    us, count, kernel) without the annotation ranges
    ("Optimizer.step#Adam.step"), which span kernels counted on their own;
    wall ms; the device's windows of the calls, ms (:func:`call_windows_ms`:
    busy, and idle between the records); whether the device recorded every
    launch, copy and fill the host asked for, and for graph replays the
    same kernels in every one)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            step(batch)
            torch.cuda.synchronize()  # fewer device records outstanding at once
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    rows = [(e.self_device_time_total, e.count, e.key) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and "#" not in e.key]
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    launches = sum(e.count for e in host if e.key.startswith(
        ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")))
    replays = sum(e.count for e in host if "GraphLaunch" in e.key)
    complete = sum(r[1] for r in rows) >= launches and (
        not replays or all(r[1] % replays == 0 for r in rows))
    window_ms = call_windows_ms(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and "#" not in e.key)
    return sorted(rows, reverse=True), wall_ms, window_ms, complete


def profile_phase(step, batch, label: str, steps: int = 3, tries: int = 3, per_call: int = 1,
                  top: int = 20, log=print):
    """Device time by kernel group over ``steps`` calls (torch.profiler)
    after one unprofiled call, each call ``per_call`` optimizer steps, and
    the device's busy share of the window. The profiler can drop device
    events: a window whose records fall short is taken again, up to
    ``tries`` times, and otherwise reported as a lower bound. Prints the
    groups and the ``top`` kernels. Returns a dict of the ms per optimizer
    step by group (``groups``), the ``rows``, the device's ``window_ms``
    and ``busy_ms`` per optimizer step, ``kernels_per_step`` and
    ``complete``, or None when the profiler recorded no device time."""
    step(batch)
    torch.cuda.synchronize()
    for _ in range(tries):
        rows, wall_ms, window_ms, complete = profile_window(step, batch, steps)
        if complete:
            break
    if not rows:
        log("[profile] the profiler recorded no device time: not measured")
        return None
    n = steps * per_call
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"[profile] {label}: wall {wall_ms / n:.4f} ms/step, device busy "
        f"{busy_ms / n:.4f} ms/step ({100 * busy_ms / wall_ms:.1f}% of the window); the device's "
        f"window from each call's first record to its last {window_ms / n:.4f} ms/step, busy "
        f"{100 * busy_ms / window_ms:.1f}% of it; "
        + ("every launch recorded" if complete else
           f"events were dropped in {tries} windows, busy is a lower bound"))
    groups = group_ms(rows, n)
    log("[profile] ms/step by group: " + ", ".join(f"{g} {ms:.4f}" for g, ms in groups.items()))
    for us, count, key in rows[:top]:
        log(f"  {us / 1e3 / n:9.4f} ms/step  x{count // n:<4d} {key[:100]}")
    return {"groups": groups, "rows": rows, "window_ms": window_ms / n, "busy_ms": busy_ms / n,
            "kernels_per_step": sum(r[1] for r in rows) / n, "complete": complete}


def union_ms(intervals) -> float:
    """Total length of the union of ``(start_us, end_us)`` intervals, ms."""
    total, reach = 0.0, -np.inf
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def trace_summary(trace_dir: str) -> dict:
    """What a ``--profile-dir`` trace (``*.pt.trace.json``) holds: the
    window, the device's kernels (the port's by name), busy time and share,
    and the host's launches."""
    (path,) = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    window_ms = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
    busy_ms = union_ms((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    ours: Dict[str, int] = {}
    for e in kernels:
        name = next((n for n in PORT_KERNELS if n in e["name"]), None)
        if name:
            ours[name] = ours.get(name, 0) + 1
    launch_calls = [e for e in runtime if "LaunchKernel" in e["name"]]
    return {"window_ms": window_ms, "device_kernels": len(kernels), "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / window_ms if window_ms else None,
            "port_kernels": ours, "host_kernel_launches": len(launch_calls),
            "host_launch_ms": sum(e["dur"] for e in launch_calls) / 1e3,
            "graph_launches": sum("GraphLaunch" in e["name"] for e in runtime),
            "threads_with_cpu_ops": len({e["tid"] for e in events if e.get("cat") == "cpu_op"}),
            "trace_mb": os.path.getsize(path) / 1e6}


def profile(batch_size: int = 4, fused: int = 16, eager: bool = False, augment: bool = True,
            remat: bool = False, layers: int = 18, steps: int = 4, top: int = 40, log=print):
    """Profile the step on CUDA card 0 and print its groups and top kernels;
    returns :func:`profile_phase`'s dict. Raises when the profiler records
    no kernel of a graph replay."""
    k = 1 if eager else fused
    variant = {"batch": batch_size, "augment": augment, "remat": remat, "layers": layers}
    step, batch, k, _ = build(variant, "cuda", k)
    for _ in range(2 if k > 1 else 0):  # the warm-up, and the capture
        step(batch)
    label = f"b{batch_size} " + ("eager" if k == 1 else f"K={k} graph replays")
    out = profile_phase(step, batch, label, steps, per_call=k, top=0, log=log)
    if out is None:
        raise RuntimeError("the profiler recorded no device kernel"
                           + (" of the graph replays on this torch build" if k > 1 else ""))
    rows, n, total = out["rows"], steps * k, out["busy_ms"]
    log(f"device busy: {total:.4f} ms per optimizer step over {n} steps, "
        f"{out['kernels_per_step']:.0f} records per step; the device's window "
        f"{out['window_ms']:.4f} ms per step, idle between records "
        f"{out['window_ms'] - total:.4f} ms | {card_line()}")
    log(f"{'ms/step':>9}  {'%':>5}  calls/step  kernel")
    shown = 0.0
    for us, count, key in rows[:top]:
        log(f"{us / 1e3 / n:9.4f}  {100 * us / 1e3 / n / total:5.1f}  {count / n:10.2f}  "
            f"{key[:110]}")
        shown += us / 1e3 / n
    log(f"(top {top} = {100 * shown / total:.1f}% of device busy time)")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fused", type=int, default=16, help="steps per graph replay")
    p.add_argument("--eager", action="store_true", help="profile eager steps instead")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--layers", type=int, default=18, help="DispNet encoder depth (pose stays 18)")
    p.add_argument("--steps", type=int, default=4,
                   help="traced dispatches (each --fused optimizer steps)")
    p.add_argument("--no-augment", dest="augment", action="store_false")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--top", type=int, default=40)
    args = p.parse_args(argv)
    cli_device("cuda")
    try:
        profile(args.batch, max(args.fused, 1), args.eager, args.augment, args.remat,
                args.layers, args.steps, args.top, log=lambda s: print(s, flush=True))
    except RuntimeError as exc:
        print(f"profile_step: {exc}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
