"""The traced dispatches: ``torch.profiler`` over a few dispatches after the
window has closed, reduced to plain records for the per-layer readers."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from . import yardstick

WAIT, DISPATCH = "bench.data_wait", "bench.dispatch"


def profile(step, feed, dispatches: int, steps_per_dispatch: int, device) -> Dict:
    """Run ``dispatches`` more dispatches under the profiler. Returns the
    device's records ``kernels`` ``[(name, start_us, end_us)]``, the host's
    ``host`` records (the harness's two labels and every CPU op), the
    optimizer ``steps`` they ran, the host's ``wall_s`` from the first
    batch's fetch to the card's end of the last dispatch, and ``busy_s``,
    the seconds in which a kernel ran on the card."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(dispatches):
            with record_function(WAIT):
                batch = next(feed)
            with record_function(DISPATCH):
                step(batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    kernels: List[Tuple[str, float, float]] = []
    host: List[Tuple[str, float, float]] = []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # The labels' and annotations' device ranges span kernels.
            if "#" not in e.name and e.name not in (WAIT, DISPATCH) and span[2] > span[1]:
                kernels.append(span)
        else:
            host.append(span)
    return {"kernels": kernels, "host": host, "steps": dispatches * steps_per_dispatch,
            "wall_s": wall, "busy_s": busy_and_span_us(kernels)[0] * 1e-6}


def busy_and_span_us(kernels) -> Tuple[float, float]:
    intervals = [(s, e) for _, s, e in kernels]
    if not intervals:
        return 0.0, 0.0
    return yardstick.union_us(intervals), max(e for _, e in intervals) - min(s for s, _ in intervals)


def _gap_name(gap, host) -> str:
    """What the host was doing across an idle ``gap``: the harness's label
    that covers most of it, and inside it the shortest op covering half."""
    start, end = gap
    over = lambda s, e: max(0.0, min(e, end) - max(s, start))
    labels = [(over(s, e), n) for n, s, e in host if n in (WAIT, DISPATCH)]
    outer = max(labels)[1] if labels and max(labels)[0] > 0 else "between dispatches"
    inner = [(e - s, n) for n, s, e in host
             if n not in (WAIT, DISPATCH) and over(s, e) >= 0.5 * (end - start)]
    return f"{outer} > {min(inner)[1]}" if inner else outer


def breakdown(records: Dict, groups=(), top: int = 10) -> Dict:
    """The device's top kernel groups (a family's own ``groups`` for what
    the shared groups leave) and its longest idle gaps, seconds over the
    traced dispatches."""
    kernels = records["kernels"]
    groups = yardstick.group_us(kernels, 1, groups)
    holes = sorted(yardstick.gaps((s, e) for _, s, e in kernels), key=lambda g: g[0] - g[1])
    return {"device_ops": [[g, us * 1e-6] for g, us in list(groups.items())[:top]],
            "idle_gaps": [[_gap_name(g, records["host"]), (g[1] - g[0]) * 1e-6]
                          for g in holes[:top]]}
