"""Profiling and debugging hooks.

The counterpart of the JAX package's ``utils/profiling.py``:

* ``trace(log_dir)``: a ``torch.profiler`` context (CPU, and CUDA where a
  card is present) that writes a Chrome/TensorBoard trace
  (``*.pt.trace.json``) into ``log_dir``; nothing when ``log_dir`` is None.
* ``StepTimer``: wall-clock per-step statistics with warm-up steps left out.
* ``enable_nan_debugging()``: ``torch.autograd.set_detect_anomaly(True)``,
  the reference's anomaly detection, opt-in (the reference leaves it on
  globally, its train.py:67, a large slowdown).
* ``card_line()``: the card's name and power limit as ``nvidia-smi`` gives
  them, which every time measured on the card is printed beside.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the host and the card into ``log_dir`` (no-op when None). The
    device's records are collected when the context ends: synchronize
    before, so the traced work has finished."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def enable_nan_debugging() -> None:
    torch.autograd.set_detect_anomaly(True)


class StepTimer:
    """Per-step wall-clock stats; the first ``skip`` steps (warm-up, graph
    capture) are excluded from aggregates."""

    def __init__(self, skip: int = 1):
        self.skip = skip
        self.times = []
        self._t0 = None
        self._seen = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.skip:
            self.times.append(dt)
        return False

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    @property
    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0

    @property
    def p99(self) -> float:
        return float(np.percentile(self.times, 99)) if self.times else 0.0

    def summary(self) -> str:
        return (
            f"steps={len(self.times)} mean={self.mean * 1e3:.1f}ms "
            f"p50={self.p50 * 1e3:.1f}ms p99={self.p99 * 1e3:.1f}ms"
        )
