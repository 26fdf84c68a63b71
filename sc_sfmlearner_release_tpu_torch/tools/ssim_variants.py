"""Time variants of the SSIM kernels on one CUDA card: a tuning aid.

    python3 -m sc_sfmlearner_release_tpu_torch.tools.ssim_variants [NAME ...]

Each variant is ``csrc/ssim.cu`` (``VARIANTS``) or ``csrc/ssim_bwd.cu``
(``BWD_VARIANTS``, names starting ``bwd_``) with a few lines replaced. For
the forward: the ring depth, the warps per block, the halo copy, the zero
fill of the lanes past the image. For the backward: one column per lane
at every shape, the ring depth, the warps per block, the rows per warp.
Each table has a ``memory_only`` twin, which keeps every load and store and
drops the arithmetic; the backward's also comes with other strip layouts
and without the halo rows. All are built with the port's nvcc flags into
``build/variants/`` (the registers and spills of each build printed),
checked at the main path's shape against ``ssim_nchw_plain`` or, for the
backward's d/dy (the main path's call), ``ssim_nchw_bwd_plain`` (except
the ``memory_only`` twins), and timed by torch.profiler in turns (a CUDA
graph of the calls where the profiler drops launches), beside one
PyTorch kernel that moves the same bytes: ``torch.add(x, y, out=z)`` for
the forward, ``torch.addcmul(x, y, g, out=z)`` for the backward. With no
names it runs both tables. Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops.ssim import ssim_nchw_bwd_plain, ssim_nchw_plain

SHAPE = (16, 3, 256, 832)
ITERS = 50
ROUNDS = 4
VARIANT_DIR = _build.BUILD_DIR.parent / "variants"

_HALO_COPY = """      cp_async<4 * V>(halo, s_hx + at, gx + off + hoff);
      cp_async<4 * V>(halo, s_hy + at, gy + off + hoff);"""
_ZERO_FILL = "  if (!active) {\n#pragma unroll\n    for (int i = 0; i < STAGES; ++i)"

# name -> (what it tries, [(text in ssim.cu, replacement)])
VARIANTS = {
    "kernel": ("csrc/ssim.cu as it is", []),
    "stages_2": ("1 row in flight per warp", [("STAGES = 3;", "STAGES = 2;")]),
    "stages_4": ("3 rows in flight per warp", [("STAGES = 3;", "STAGES = 4;")]),
    "warps_4": ("4 warps per block, 4 blocks per SM",
                [("WARPS = 8;", "WARPS = 4;"), ("(WARPS * 32, 2)", "(WARPS * 32, 4)")]),
    "halo_4_bytes": ("the halo as one 4-byte cp.async.ca per array", [(_HALO_COPY, """\
      cp_async<4>(halo, s_hx + at + hcol * 4, gx + off + hoff + hcol);
      cp_async<4>(halo, s_hy + at + hcol * 4, gy + off + hoff + hcol);""")]),
    "no_zero_fill": ("lanes past the image read stale shared memory",
                     [(_ZERO_FILL, "  if (false) {\n#pragma unroll\n    for (int i = 0; i < STAGES; ++i)")]),
    "memory_only": ("the same loads and stores (x's row as output), no arithmetic",
                    [("    float u[5][V + 2];",
                      "    if (k >= 2 && active) store_cols(go + (r0 + k - 2) * W, a);\n"
                      "    if (k >= 0) continue;\n    float u[5][V + 2];")]),
}

# The backward's memory-only twin: the same loads (x and y of the output
# row, g of the window row, the taps' row) and store, no arithmetic.
_BWD_MEMORY_ONLY = [("    float u[5][V + 2];", """\
    if (k >= 4) {
      float o[V], p[V], q[V];
      load_cols(stage(prev2)->x + lane * V, o);
      load_cols(stage(prev2)->y + lane * V, p);
      load_cols(stage(prev)->g + lane * V, q);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = ((o[j] + p[j]) + q[j]) + (a[j] + b[j]);
      if (writer) store_cols(gdy + (r0 + k - 4) * W, o);
    }
    if (k >= 0) continue;
    float u[5][V + 2];""")]
_C0 = "  const int c0 = ((32 - 2 * L) * strip + lane) * V;"

# name -> (what it tries, [(text in ssim_bwd.cu, replacement)]); the
# memory_only_* twins, whose output is not the gradient, say what the
# memory traffic of a layout costs.
BWD_VARIANTS = {
    "bwd_kernel": ("csrc/ssim_bwd.cu as it is", []),
    "bwd_v1": ("one column per lane (V = 1), 28-column strips",
               [("  return W % 4 == 0 &&", "  return false && W % 4 == 0 &&")]),
    "bwd_stages_4": ("1 row in flight per warp", [("STAGES = 5;", "STAGES = 4;")]),
    "bwd_stages_6": ("3 rows in flight per warp", [("STAGES = 5;", "STAGES = 6;")]),
    "bwd_warps_2": ("2 warps per block, 8 blocks per SM",
                    [("WARPS = 4;", "WARPS = 2;"), ("MIN_BLOCKS = 4;", "MIN_BLOCKS = 8;")]),
    "bwd_rows_x2": ("twice the rows per warp at 8 warps per SM, 4 rows in flight",
                    [("SM_WARPS = 16;", "SM_WARPS = 8;"), ("STAGES = 5;", "STAGES = 7;")]),
    "bwd_memory_only": ("the same loads and stores (x + y + g as d/dy), no arithmetic",
                        _BWD_MEMORY_ONLY),
    "bwd_memory_only_unaligned": (
        "memory_only with each strip's loads 16 B off the 32-B sectors",
        _BWD_MEMORY_ONLY + [(_C0, "  const int c0 = ((32 - 2 * L) * strip + lane - L) * V;")]),
    "bwd_memory_only_no_overlap": (
        "memory_only with 128-column strips that do not overlap",
        _BWD_MEMORY_ONLY + [("IDLE_LANES = V > 1 ? 1 : 2;", "IDLE_LANES = V > 1 ? 0 : 2;")]),
    "bwd_memory_only_no_halo_rows": (
        "memory_only without the 4 extra input rows of each warp",
        _BWD_MEMORY_ONLY + [("  const int n_in = min(rows, H - r0) + 4;",
                             "  const int n_in = min(rows, H - r0);")]),
}

# source -> (its variants, the kernel's name in the profiler)
TABLES = {"ssim.cu": (VARIANTS, "ssim_kernel"), "ssim_bwd.cu": (BWD_VARIANTS, "ssim_bwd_kernel")}


def variant_sources() -> dict:
    """name -> (source file, CUDA source) for both tables; raises if a
    replacement no longer applies."""
    out = {}
    for source, (table, _) in TABLES.items():
        base = (_build.CSRC_DIR / source).read_text()
        for name, (_, edits) in table.items():
            src = base
            for old, new in edits:
                if src.count(old) != 1:
                    raise ValueError(f"variant {name}: {old!r} is not once in {source}")
                src = src.replace(old, new)
            out[name] = (source, src)
    return out


def _build_all(names) -> dict:
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for name, (_, src) in variant_sources().items():
        if name not in names:
            continue
        cu, so = VARIANT_DIR / f"{name}.cu", VARIANT_DIR / f"{name}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        report = [ln.split("Used")[1].strip() if "Used" in ln else ln.strip()
                  for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        print(f"[build] {name}: {report}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _device_us(fn, kernel: str, tries: int = 3) -> float:
    """Device us per call of ``fn``'s ``kernel`` over ITERS calls: the
    profiler, taken again where it dropped launches, then a CUDA graph of
    the calls replayed under CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
        launches = sum(e.count for e in hits)
        if launches == ITERS:
            return sum(e.self_device_time_total for e in hits) / launches
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(ITERS):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    print(f"  {kernel}: the profiler dropped launches {tries} times; CUDA-graph time",
          flush=True)
    return start.elapsed_time(end) * 1e3 / ITERS


def main(argv=None) -> int:
    sources = variant_sources()
    names = (argv if argv is not None else sys.argv[1:]) or list(sources)
    unknown = set(names) - set(sources)
    if unknown:
        print(f"ssim_variants: unknown variants {sorted(unknown)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ssim_variants: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[device] {smi}", flush=True)
    libs = _build_all(names)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(*SHAPE).astype(np.float32)).cuda()
    noise = torch.from_numpy((rng.randn(*SHAPE) * 0.05).astype(np.float32)).cuda()
    y = (x + noise).clamp(0.0, 1.0)
    g = torch.from_numpy(rng.randn(*SHAPE).astype(np.float32)).cuda()
    out = torch.empty_like(x)
    f, c, h, w = SHAPE
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def launcher(name, lib):
        if sources[name][0] == "ssim.cu":
            lib.ssim_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            call = lambda: lib.ssim_fwd(x.data_ptr(), y.data_ptr(), out.data_ptr(), f * c, h, w,
                                        stream())
        else:
            lib.ssim_bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            call = lambda: lib.ssim_bwd(x.data_ptr(), y.data_ptr(), g.data_ptr(), None,
                                        out.data_ptr(), f * c, h, w, stream())

        def run():
            code = call()
            if code:
                raise RuntimeError(f"{name} returned CUDA error {code}")
        return run

    want = {"ssim.cu": ssim_nchw_plain(x, y), "ssim_bwd.cu": ssim_nchw_bwd_plain(x, y, g)[1]}
    runs = {name: launcher(name, lib) for name, lib in libs.items()}
    for name, run in runs.items():
        if "memory_only" not in name:
            run()
            ref = want[sources[name][0]]
            err = ((out - ref).abs().max() / ref.abs().max()).item()
            print(f"[check] {name}: max|err|/max|ref| {err:.3e}", flush=True)
            if not err <= 1e-5:
                raise AssertionError(f"{name} disagrees with its plain version")
    yardsticks = {"ssim.cu": ("torch.add", lambda: torch.add(x, y, out=out)),
                  "ssim_bwd.cu": ("torch.addcmul", lambda: torch.addcmul(x, y, g, out=out))}
    for source, (table, kernel) in TABLES.items():
        mine = [name for name in runs if sources[name][0] == source]
        if not mine:
            continue
        stick, stick_run = yardsticks[source]
        times = {name: [] for name in [*mine, stick]}
        for r in range(ROUNDS):
            for name in mine if r % 2 == 0 else mine[::-1]:
                times[name].append(_device_us(runs[name], kernel))
            times[stick].append(_device_us(stick_run, "elementwise_kernel"))
        print(f"[{source}] {SHAPE}")
        for name, us in times.items():
            what = table[name][0] if name in table else "one PyTorch kernel, the same bytes"
            print(f"{name:16s} {np.median(us):8.2f} us median of {ROUNDS} "
                  f"{[round(u, 2) for u in us]}  ({what})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
