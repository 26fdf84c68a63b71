"""Running-average meters and terminal progress loggers.

Reference behavior: the reference's logger.py — a multi-valued AverageMeter
and a fixed-position 3-bar terminal UI (epoch / train / valid bars pinned to
the bottom of the screen, logger.py:6-39). :class:`TermLogger` reproduces
that UI with raw ANSI escapes (no blessings/progressbar2 dependency);
:class:`ProgressLogger` is the plain single-line fallback for non-TTY
output (log files, CI). :func:`make_logger` picks automatically. The
port's own copy of the JAX package's ``utils/meters.py``.
"""

from __future__ import annotations

import shutil
import sys
import time
from typing import Sequence, TextIO, Union


class AverageMeter:
    """Tracks ``i`` simultaneous values (reference: logger.py:66-93)."""

    def __init__(self, i: int = 1, precision: int = 3):
        self.meters = i
        self.precision = precision
        self.reset()

    def reset(self) -> None:
        self.val = [0.0] * self.meters
        self.avg = [0.0] * self.meters
        self.sum = [0.0] * self.meters
        self.count = 0

    def update(self, val: Union[float, Sequence[float]], n: int = 1) -> None:
        if not isinstance(val, (list, tuple)):
            val = [val]
        assert len(val) == self.meters
        self.count += n
        self.val = [float(v) for v in val]
        self.sum = [s + v * n for s, v in zip(self.sum, self.val)]
        self.avg = [s / self.count for s in self.sum]

    def __repr__(self) -> str:
        val = " ".join(f"{v:.{self.precision}f}" for v in self.val)
        avg = " ".join(f"{a:.{self.precision}f}" for a in self.avg)
        return f"{val} ({avg})"


class ProgressLogger:
    """Minimal epoch/train/valid progress printer."""

    def __init__(self, n_epochs: int, train_size: int, valid_size: int):
        self.n_epochs = n_epochs
        self.train_size = train_size
        self.valid_size = valid_size
        self.epoch = 0
        self._t0 = time.time()

    def start_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        print(f"=> epoch {epoch + 1}/{self.n_epochs}", flush=True)

    def train_update(self, i: int, msg: str = "") -> None:
        self._line("train", i, self.train_size, msg)

    def valid_update(self, i: int, msg: str = "") -> None:
        self._line("valid", i, self.valid_size, msg)

    def _line(self, phase: str, i: int, total: int, msg: str) -> None:
        el = time.time() - self._t0
        sys.stdout.write(f"\r[{phase} {i}/{total}] {el:7.1f}s {msg}   ")
        if i >= total:
            sys.stdout.write("\n")
        sys.stdout.flush()

    def write(self, msg: str) -> None:
        print(msg, flush=True)

    def finish(self) -> None:
        pass


def _render_bar(label: str, i: int, total: int, width: int, t0: float) -> str:
    """One progress-bar line: ``label:  42% |████----| 84/200 [12s<17s]``."""
    total = max(total, 1)
    i = min(i, total)
    frac = i / total
    fill = int(frac * width)
    elapsed = time.time() - t0
    eta = elapsed / frac - elapsed if frac > 0 else 0.0
    return (
        f"{label}: {frac:4.0%} |{'#' * fill}{'-' * (width - fill)}| "
        f"{i}/{total} [{elapsed:.0f}s<{eta:.0f}s]"
    )


class TermLogger:
    """Fixed-position epoch/train/valid bars (reference: logger.py:6-39).

    Reserves the bottom ``_BLOCK`` terminal rows and renders three progress
    bars plus a message row per phase at pinned positions, exactly like the
    reference's blessings+progressbar2 UI — implemented with bare ANSI
    cursor save/move/restore so it needs no dependencies. Row offsets within
    the block match the reference (epoch 1, train 3-4, valid 6-7).
    """

    _BLOCK = 10

    def __init__(self, n_epochs: int, train_size: int, valid_size: int,
                 stream: TextIO = None):
        self.n_epochs = max(n_epochs, 1)
        self.train_size = train_size
        self.valid_size = valid_size
        self.out = stream if stream is not None else sys.stdout
        self.height = shutil.get_terminal_size().lines
        self.width = max(20, min(shutil.get_terminal_size().columns - 40, 60))
        self.epoch = 0
        self._t0 = time.time()
        self._train_t0 = self._t0
        self._valid_t0 = self._t0
        # Push existing content up so the reserved block starts blank.
        self.out.write("\n" * self._BLOCK)
        self.out.flush()

    def _row(self, offset: int) -> int:
        # Re-read the terminal size on every render (handles resizes
        # without a SIGWINCH handler) and clamp to row 1 so terminals
        # shorter than the reserved block never get non-positive ANSI row
        # numbers (which scramble output).
        self.height = shutil.get_terminal_size().lines
        return max(1, self.height - self._BLOCK + offset)

    def _put(self, offset: int, text: str) -> None:
        # Save cursor, jump to the pinned row, clear it, write, restore.
        self.out.write(f"\0337\033[{self._row(offset)};1H\033[2K{text}\0338")
        self.out.flush()

    def start_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self._train_t0 = time.time()
        self._valid_t0 = time.time()
        self._put(1, _render_bar("epoch", epoch, self.n_epochs,
                                 self.width, self._t0))
        self._put(4, _render_bar("train", 0, self.train_size,
                                 self.width, self._train_t0))
        self._put(7, _render_bar("valid", 0, self.valid_size,
                                 self.width, self._valid_t0))

    def train_update(self, i: int, msg: str = "") -> None:
        if msg:
            self._put(3, msg)
        self._put(4, _render_bar("train", i, self.train_size,
                                 self.width, self._train_t0))

    def valid_update(self, i: int, msg: str = "") -> None:
        if i <= 1:
            self._valid_t0 = time.time()
        if msg:
            self._put(6, msg)
        self._put(7, _render_bar("valid", i, self.valid_size,
                                 self.width, self._valid_t0))

    def write(self, msg: str) -> None:
        # Epoch summaries land on the train message row, matching the
        # reference's logger.train_writer.write (train.py:197).
        self._put(3, msg)

    def finish(self) -> None:
        self._put(1, _render_bar("epoch", self.n_epochs, self.n_epochs,
                                 self.width, self._t0))
        self.out.write(f"\033[{self.height};1H\n")
        self.out.flush()


def make_logger(n_epochs: int, train_size: int, valid_size: int,
                style: str = "auto", is_main: bool = True):
    """Pick the terminal UI: fixed-position bars on a TTY, plain lines
    otherwise (or force with ``style`` = "bars" / "line").

    Non-main processes (multi-host runs) always get the plain logger:
    several TermLoggers writing pinned ANSI rows to one shared TTY would
    scramble each other.
    """
    if not is_main:
        return ProgressLogger(n_epochs, train_size, valid_size)
    if style == "bars" or (style == "auto" and sys.stdout.isatty()):
        return TermLogger(n_epochs, train_size, valid_size)
    return ProgressLogger(n_epochs, train_size, valid_size)
