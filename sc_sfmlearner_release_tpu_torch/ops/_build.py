"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so``
at the repository root and loaded with ``ctypes``. The hash covers the
source and the flags, so an edited source is rebuilt. A failed build raises
with the compiler's output: there is no fallback.

``-fmad=false`` keeps the compiler from contracting a multiply and an add
into one rounding, so the kernels round as their plain PyTorch versions do.
``-cudart shared`` links the kernels against the shared CUDA runtime, so
the process holds one runtime: the one PyTorch has already loaded.

The wrappers in ``ops/`` share the checks every kernel needs of its
tensors (``check_tensors``) and the stream they launch on (``stream``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-cudart", "shared", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, the ``PATH`` or ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str], verbose: bool = False, force: bool = False) -> float:
    """Compile every library in ``names`` that is not built yet (all of them
    with ``force``), one ``nvcc`` per source, all started together. Returns
    the wall seconds taken. ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report."""
    t0 = time.perf_counter()
    todo = [(n, library_path(n)) for n in names]
    todo = [(n, so) for n, so in todo if force or not so.exists()]
    if not todo:
        return time.perf_counter() - t0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for name, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            continue
        if verbose and out.strip():
            print(f"[nvcc {name}.cu]\n{out.strip()}")
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            so = library_path(name)
            if not so.exists():
                build([name])
            lib = ctypes.CDLL(str(so))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def check_tensors(name: str, tensors: Sequence[torch.Tensor]) -> None:
    """What every kernel takes: one CUDA device, float32, contiguous, fewer
    than 2^31 elements (the kernels index with 32-bit sizes)."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{name}: tensors on {[str(t.device) for t in tensors]}; all must be "
            "on one CUDA device (or all on the CPU)"
        )
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: needs float32, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if any(t.numel() >= 2**31 for t in tensors):
        raise ValueError(f"{name}: tensors must hold fewer than 2^31 elements")


def stream(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device: kernels
    launch there, in order with PyTorch's own work."""
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream
