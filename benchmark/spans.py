"""The program's own spans and counters, as the per-layer readers take
them: the port's ``utils/profiling.py`` records spans while the traced
dispatches run under the profiler and puts them on the profiler's clock
(``aligned``), and keeps counters from its set-up. Everything here returns
None where the program records nothing of the kind (a program without the
recorder, a CPU run, an eager step), and raises nothing for it.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from . import trace, yardstick

# Host CUDA calls that put work on the card's queue.
ENQUEUE = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpy",
           "cuMemcpy", "cudaMemset", "cuMemset")


def _profiling():
    try:
        from sc_sfmlearner_release_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def aligned(rec: dict) -> Optional[list]:
    """The program's spans of the traced dispatches, microseconds on the
    trace's host clock (``name``, ``start``, ``end``, ``thread``, ...): those
    that the trace record carries from the rank that recorded them
    (``carry``), else this process's."""
    t = rec.get("trace")
    if t and "spans" in t:
        return t["spans"]
    read = getattr(_profiling(), "aligned", None)
    if not t or read is None:
        return None
    return read(t["host"])


def counter(name: str, rec: Optional[dict] = None):
    """The program's counter ``name``: the one that ``rec``'s trace record
    carries from its rank (``carry``), else this process's."""
    t = (rec or {}).get("trace") or {}
    if "counters" in t:
        return t["counters"].get(name)
    read = getattr(_profiling(), "counters", None)
    return None if read is None else read().get(name)


def carry(rec: dict) -> None:
    """Put this process's spans of ``rec``'s traced dispatches and its
    counters into the trace record, for a reader in another process (a
    rank's, read where ``ranks.run`` returns)."""
    read = getattr(_profiling(), "counters", None)
    rec["trace"].update(spans=aligned(rec), counters=read() if read else {})


def window_us(rec: dict) -> Tuple[float, float]:
    """The traced dispatches' host window: first host record to last."""
    host = rec["trace"]["host"]
    return min(s for _, s, _ in host), max(e for _, _, e in host)


def named(rec: dict, name: str) -> Optional[List[Tuple[int, float, float]]]:
    """``(thread, start, end)`` of each span called ``name``, cut to the
    window (spans go on recording after the profile stops); None where the
    program recorded none."""
    spans = aligned(rec)
    if not spans:
        return None
    lo, hi = window_us(rec)
    out = [(s.thread, max(s.start, lo), min(s.end, hi)) for s in spans if s.name == name]
    out = [(t, s, e) for t, s, e in out if e > s]
    return out or None


def ms_per_step(rec: dict, name: str) -> Optional[float]:
    """The spans called ``name``, summed over threads, ms per optimizer step."""
    spans = named(rec, name)
    if spans is None:
        return None
    return sum(e - s for _, s, e in spans) / 1e3 / rec["trace"]["steps"]


def host_gaps(rec: dict) -> Optional[List[Tuple[float, float]]]:
    """The device's idle gaps in the traced dispatches that the host caused:
    those inside which a host call that enqueues work begins or returns.
    With nothing queued, the work that ends a gap is enqueued inside it. A
    call that merely spans a gap does not count: ``cudaGraphLaunch`` can
    block for a whole replay while the card runs the graph before it."""
    t = rec.get("trace")
    if not t or not t["kernels"]:
        return None
    edges = sorted(x for n, s, e in t["host"] if n.startswith(ENQUEUE) for x in (s, e))
    out = []
    for lo, hi in yardstick.gaps((s, e) for _, s, e in t["kernels"]):
        i = bisect.bisect_right(edges, lo)
        if i < len(edges) and edges[i] < hi:
            out.append((lo, hi))
    return out


def device_span_us(rec: dict) -> float:
    return trace.busy_and_span_us(rec["trace"]["kernels"])[1]


def overlap_us(a, b) -> float:
    """Length of the overlap of two sets of disjoint intervals."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for lo, hi in a for s, e in b)
