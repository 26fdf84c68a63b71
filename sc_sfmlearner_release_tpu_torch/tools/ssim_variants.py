"""Time variants of the SSIM kernel on one CUDA card: a tuning aid.

    python3 -m sc_sfmlearner_release_tpu_torch.tools.ssim_variants [NAME ...]

Each variant is ``csrc/ssim.cu`` with a few lines replaced: the ring depth,
the warps per block, the halo copy, the zero fill of the lanes past the
image, and ``memory_only``, which keeps every load and store and drops the
arithmetic. All are built with the port's nvcc flags into
``build/variants/``, checked against ``ssim_nchw_plain`` at the main path's
shape (except ``memory_only``), and timed by torch.profiler in turns,
beside ``torch.add(x, y, out=z)``, one PyTorch kernel that moves the same
bytes. Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops.ssim import ssim_nchw_plain

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


def variant_sources() -> dict:
    """name -> CUDA source; raises if a replacement no longer applies."""
    base = (_build.CSRC_DIR / "ssim.cu").read_text()
    out = {}
    for name, (_, edits) in VARIANTS.items():
        src = base
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"variant {name}: {old!r} is not once in ssim.cu")
            src = src.replace(old, new)
        out[name] = src
    return out


def _build_all(names) -> dict:
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for name, src in variant_sources().items():
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
        regs = [ln.split("Used")[1].strip() for ln in log.splitlines() if "Used" in ln]
        print(f"[build] {name}: {regs}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.ssim_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        libs[name] = lib
    return libs


def _device_us(fn, kernel: str) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    launches = sum(e.count for e in hits)
    if launches != ITERS:
        raise RuntimeError(f"the profiler recorded {launches} of {ITERS} {kernel} launches")
    return sum(e.self_device_time_total for e in hits) / launches


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
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
    out = torch.empty_like(x)
    want = ssim_nchw_plain(x, y)
    f, c, h, w = SHAPE

    def launcher(lib):
        def run():
            code = lib.ssim_fwd(x.data_ptr(), y.data_ptr(), out.data_ptr(), f * c, h, w,
                                torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"ssim_fwd returned CUDA error {code}")
        return run

    runs = {name: launcher(lib) for name, lib in libs.items()}
    for name, run in runs.items():
        if name != "memory_only":
            run()
            err = (out - want).abs().max().item()
            print(f"[check] {name}: max|err| {err:.3e}", flush=True)
            if not err <= 1e-5:
                raise AssertionError(f"{name} disagrees with ssim_nchw_plain")
    times = {name: [] for name in [*runs, "torch.add"]}
    for r in range(ROUNDS):
        order = list(runs) if r % 2 == 0 else list(runs)[::-1]
        for name in order:
            times[name].append(_device_us(runs[name], "ssim_kernel"))
        times["torch.add"].append(
            _device_us(lambda: torch.add(x, y, out=out), "elementwise_kernel"))
    for name, us in times.items():
        what = VARIANTS[name][0] if name in VARIANTS else "one PyTorch kernel, the same bytes"
        print(f"{name:13s} {np.median(us):8.2f} us median of {ROUNDS} "
              f"{[round(u, 2) for u in us]}  ({what})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
