"""Profiling and debugging hooks.

The counterpart of the JAX package's ``utils/profiling.py``, and the port's
own spans and counters:

* ``trace(log_dir)``: a ``torch.profiler`` context (CPU, and CUDA where a
  card is present) that writes a Chrome/TensorBoard trace
  (``*.pt.trace.json``) into ``log_dir``, the port's spans of the traced
  region in it; nothing when ``log_dir`` is None.
* ``span(name, batch)``: one piece of the program's work (a sample loaded, a
  wait on the loader's queue, a dispatch's staging), recorded only while a
  ``torch.profiler`` runs. ``aligned(host_records)`` puts the recorded spans
  on the profiler's clock.
* ``counter(name, value)`` / ``counters()``: plain values the program sets
  at most once a dispatch (the set-up's seconds, the captured graph's
  kernels), always on.
* ``graph_kernel_nodes(raw_graph)``: the kernel nodes of a captured CUDA
  graph.
* ``enable_nan_debugging()``: ``torch.autograd.set_detect_anomaly(True)``,
  the reference's anomaly detection, opt-in (the reference leaves it on
  globally, its train.py:67, a large slowdown).
* ``card_line()``: the card's name and power limit as ``nvidia-smi`` gives
  them, which every time measured on the card is printed beside.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import json
import os
import socket
import statistics
import subprocess
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

# The prefix of a span's copy in the profiler's host records. The ``#``
# keeps the copy's device-side range out of a trace's device records.
COPY = "sc#"
# The category of the spans written into a ``trace`` file.
SPAN_CATEGORY = "sc_span"


class Span(NamedTuple):
    """One recorded span. ``start``/``end``: ``time.perf_counter_ns()`` as
    recorded; microseconds on the profiler's clock from ``aligned``."""

    name: str
    start: float
    end: float
    thread: int  # threading.get_native_id(): the thread id a trace shows
    id: int
    parent: Optional[int]  # the enclosing span on the same thread
    batch: Optional[int]  # the batch index, or a dispatch's first optimizer step
    copied: bool  # a profiler copy was opened (the profiling thread's spans)


_OFF = contextlib.nullcontext()  # a site's span while nothing records


class _Stacks(threading.local):
    def __init__(self):
        self.stack: list = []  # each thread's open spans


class _Open:
    """A span being recorded."""

    __slots__ = ("rec", "name", "batch", "id", "parent", "copy", "start")

    def __init__(self, rec: "Recorder", name: str, batch: Optional[int]):
        self.rec, self.name, self.batch = rec, name, batch

    def __enter__(self):
        rec = self.rec
        if not rec.on:
            rec._turn_on()
        stack = rec._local.stack
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer is not None else None
        if self.batch is None and outer is not None:
            self.batch = outer.batch
        self.id = next(rec._ids)
        stack.append(self)
        # Only the thread that started the profiler records a range.
        self.copy = (_autograd_profiler.record_function(COPY + self.name)
                     if torch._C._autograd._profiler_enabled() else None)
        self.start = time.perf_counter_ns()
        if self.copy is not None:
            self.copy.__enter__()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()  # as the start: just before the copy's call
        if self.copy is not None:
            self.copy.__exit__(*exc)
        self.rec._local.stack.pop()
        self.rec.spans.append(Span(self.name, self.start, end, threading.get_native_id(),
                                   self.id, self.parent, self.batch, self.copy is not None))
        return False


class Recorder:
    """Spans and counters, kept in memory.

    A span is recorded only while a ``torch.profiler`` runs (torch's global
    flag, which every thread reads): a site then costs two attribute reads
    when nothing records. The store empties when a site sees recording on
    after a site saw it off, so after a profile it holds the profiled
    region's spans; where no site ran between two profiles (the loader's
    threads blocked on a full queue), ``aligned`` leaves the earlier
    profile's spans out. On the thread that started the profiler, each span
    also opens ``record_function(COPY + name)``, which ``aligned`` finds in
    the host records. Counters are set whether or not anything records."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}
        self.on = False
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._local = _Stacks()

    def span(self, name: str, batch: Optional[int] = None):
        """A context manager around one piece of work; ``batch`` names the
        batch or dispatch (None: the enclosing span's)."""
        if not _autograd_profiler._is_profiler_enabled:
            if self.on:
                self._turn_off()
            return _OFF
        return _Open(self, name, batch)

    def counter(self, name: str, value: float) -> None:
        self.counters[name] = value

    def _turn_on(self) -> None:
        with self._lock:
            if not self.on:
                self.spans = []
                self.on = True

    def _turn_off(self) -> None:
        with self._lock:
            if not _autograd_profiler._is_profiler_enabled:
                self.on = False

    def aligned(self, host_records: Sequence[Tuple[str, float, float]]) -> Optional[List[Span]]:
        """The spans of the profile that ``host_records`` (``(name,
        start_us, end_us)``, its host records) come from, start and end in
        microseconds on their clock: shifted by the median of (copy's start
        - span's start) over the spans that have a copy, the last k spans
        of a name paired with its last k copies. Spans that end before the
        first record are an earlier profile's and are left out. None where
        no copy is found."""
        spans = list(self.spans)
        copies: Dict[str, List[float]] = {}
        for name, start, _ in host_records:
            if name.startswith(COPY):
                copies.setdefault(name[len(COPY):], []).append(start)
        shifts = []
        for name, starts in copies.items():
            mine = sorted(s.start for s in spans if s.copied and s.name == name)
            shifts += [c - s / 1e3 for c, s in zip(sorted(starts)[::-1], mine[::-1])]
        if not shifts:
            return None
        shift = statistics.median(shifts)
        first = min(start for _, start, _ in host_records)
        return [s._replace(start=s.start / 1e3 + shift, end=s.end / 1e3 + shift) for s in spans
                if s.end / 1e3 + shift >= first]


RECORDER = Recorder()
span = RECORDER.span
counter = RECORDER.counter
aligned = RECORDER.aligned


def counters() -> Dict[str, float]:
    return dict(RECORDER.counters)


def _write_spans(path: str, recorder: Recorder = RECORDER) -> None:
    """Add the recorded spans to the Chrome trace at ``path`` (written by
    ``export_chrome_trace``) as complete events on its own clock, each on
    its thread's track."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    host = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and not e.get("cat", "").startswith(("kernel", "gpu"))]
    spans = recorder.aligned(host)
    if spans is None:
        return
    last = max(end for _, _, end in host)  # spans go on after the profile stops
    pid = os.getpid()
    events += [{"ph": "X", "cat": SPAN_CATEGORY, "name": s.name, "pid": pid, "tid": s.thread,
                "ts": s.start, "dur": min(s.end, last) - s.start,
                "args": {"id": s.id, "parent": s.parent, "batch": s.batch}}
               for s in spans if s.start < last]
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the host and the card into ``log_dir`` (no-op when None), with
    the port's spans of the traced region (category ``SPAN_CATEGORY``, one
    track per thread: the loader's threads beside the kernels). The
    device's records are collected when the context ends: synchronize
    before, so the traced work has finished."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    # tensorboard_trace_handler's file name, which TensorBoard's plugin reads.
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    _write_spans(path)


def _cudart() -> ctypes.CDLL:
    """The CUDA runtime this process mapped (torch's); OSError without one."""
    with open("/proc/self/maps") as maps:
        paths = sorted({line.split()[-1] for line in maps if "libcudart.so" in line})
    if not paths:
        raise OSError("no CUDA runtime (libcudart) is mapped into this process")
    rt = ctypes.CDLL(paths[0])
    rt.cudaGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    rt.cudaGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    rt.cudaGraphGetNodes.restype = rt.cudaGraphNodeGetType.restype = ctypes.c_int
    return rt


def graph_kernel_nodes(raw_graph: int) -> int:
    """The kernel nodes of a captured graph (``cudaGraph_t``, as
    ``torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()`` gives it),
    through the CUDA runtime this process mapped."""
    rt = _cudart()

    def check(err: int, call: str) -> None:
        if err:
            raise RuntimeError(f"{call} failed: CUDA error {err}")

    graph = ctypes.c_void_p(raw_graph)
    n = ctypes.c_size_t(0)
    check(rt.cudaGraphGetNodes(graph, None, ctypes.byref(n)), "cudaGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(rt.cudaGraphGetNodes(graph, nodes, ctypes.byref(n)), "cudaGraphGetNodes")
    kind = ctypes.c_int()
    kernels = 0
    for node in nodes[:n.value]:
        check(rt.cudaGraphNodeGetType(node, ctypes.byref(kind)), "cudaGraphNodeGetType")
        kernels += kind.value == 0  # cudaGraphNodeTypeKernel
    return kernels


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def enable_nan_debugging() -> None:
    torch.autograd.set_detect_anomaly(True)
