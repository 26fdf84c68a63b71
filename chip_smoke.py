#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--profile]

``--profile`` adds the validation step's device time by kernel group
(torch.profiler) after phase 4. Phases, each of which fails the run (non-zero exit) when it fails:

1. Device: the card's name and power limit (nvidia-smi); TF32 off.
2. Build: every CUDA kernel of the forward path, compiled from ``csrc/``
   for sm_90a, all sources in parallel; then every CUDA runtime the process
   has mapped once both libraries are loaded.
3. Kernels against their plain PyTorch versions, at the main path's
   shapes (SSIM also at shapes that reach every edge of its tiling), with
   the tolerance stated; kernel, plain and library times. ``ms`` is CUDA
   events around back-to-back wrapper calls; ``device_ms`` is the kernel's
   own device time per launch (torch.profiler, or a CUDA graph of the
   launches replayed under CUDA events where the profiler records none).
4. The slice at full width: ResNet-18 DispNet and PoseNet from a seeded
   ``torch.Generator``, depth inference on [4, 256, 832, 3], then the
   photometric validation step on a B=4, N=2 snippet at 832x256. Both
   kernels must launch during it. The same step in fp32 (TF32 off) must
   match the CPU run of the plain versions; the bf16 default is timed.
5. Output: a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Without a card it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from sc_sfmlearner_release_tpu_torch import disable_tf32
from sc_sfmlearner_release_tpu_torch.models import DispNet, PoseNet
from sc_sfmlearner_release_tpu_torch.ops import _build
from sc_sfmlearner_release_tpu_torch.ops.geometry import project_pixel_coords
from sc_sfmlearner_release_tpu_torch.ops.ssim import ssim_nchw, ssim_nchw_plain
from sc_sfmlearner_release_tpu_torch.ops.warp import warp_sample, warp_sample_plain
from sc_sfmlearner_release_tpu_torch.training import (
    LossConfig, make_eval_step, make_inference_fn,
)

DEVICE = "cuda"
B, N, H, W = 4, 2, 256, 832
PAIRS = 2 * N * B
KERNEL_TOL = 1e-5   # abs: the same fp32 arithmetic, rounded in another order
STEP_RTOL = 1e-3    # rel: cuDNN and the CPU sum the convolutions in another order
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
METRICS = ("loss", "photo_loss", "geometry_loss", "smooth_loss")
KERNEL_ITERS = 50   # timed launches per kernel
STEP_ITERS = 10     # timed steps per entry point


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` from CUDA events over ``iters`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int = KERNEL_ITERS):
    """(ms, how): the device time per launch of the kernel whose name holds
    ``kernel``, over ``iters`` back-to-back calls of ``fn`` (one launch
    each). torch.profiler first; where it records no such launches, a CUDA
    graph of the calls replayed under CUDA events, which leaves the host out
    too."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    launches = sum(e.count for e in hits)
    us = sum(e.self_device_time_total for e in hits)
    if launches == iters and us > 0:
        return us / launches / 1e3, "profiler"
    log(f"  {kernel}: the profiler recorded {launches} of {iters} launches; "
        "timing a CUDA graph of them instead")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, "cuda_graph"


def bound(n_bytes: float, n_flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the fp32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def kitti_intrinsics(b: int) -> np.ndarray:
    """KITTI's camera scaled from 1242x375 to 832x256."""
    k = np.array([[718.856 * W / 1242, 0.0, 607.193 * W / 1242],
                  [0.0, 718.856 * H / 375, 185.216 * H / 375],
                  [0.0, 0.0, 1.0]], np.float32)
    return np.broadcast_to(k, (b, 3, 3)).copy()


def device_phase() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    disable_tf32()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def build_phase() -> None:
    names = ("warp_sample", "ssim")
    secs = _build.build(names, verbose=True, force=True)
    log(f"[build] warp_sample.cu + ssim.cu for sm_90a in {secs:.1f} s (parallel nvcc)")
    for name in names:
        _build.load(name)
    with open("/proc/self/maps") as maps:
        runtimes = sorted({line.split()[-1] for line in maps if "libcudart" in line})
    log(f"[build] CUDA runtimes mapped with both kernel libraries loaded: {runtimes}")
    for name in names:
        try:
            ldd = subprocess.run(["ldd", str(_build.library_path(name))], capture_output=True,
                                 text=True, timeout=60).stdout
            linked = [ln.strip() for ln in ldd.splitlines() if "libcudart" in ln]
        except FileNotFoundError:
            linked = ["ldd not found: not measured"]
        log(f"[build] {name}: libcudart needed {linked or ['none (linked statically)']}")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got - want).abs().max().item()
    log(f"  {name}: max|err| {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{name}: max|err| {err:.3e} > {tol:.0e}")
    return err


def warp_phase(rng: np.random.RandomState) -> dict:
    dev = torch.device(DEVICE)
    depth = rng.uniform(1.0, 80.0, (PAIRS, H, W, 1)).astype(np.float32)
    rgb = rng.rand(PAIRS, H, W, 3).astype(np.float32)
    src = torch.from_numpy(np.concatenate([depth, rgb], -1)).to(dev)
    # The slice's own projection: smooth target depth, small motions.
    tgt_depth = torch.from_numpy(
        np.repeat(np.linspace(4.0, 60.0, H, dtype=np.float32)[None, :, None, None], W, 2)
        .repeat(PAIRS, 0)).to(dev)
    pose = torch.from_numpy(
        (rng.randn(PAIRS, 6) * [0.3, 0.05, 0.8, 0.005, 0.02, 0.005]).astype(np.float32)).to(dev)
    intr = torch.from_numpy(kitti_intrinsics(PAIRS)).to(dev)
    rand = rng.uniform(-1.3, 1.3, (PAIRS, H, W, 2)).astype(np.float32)
    rand[:, ::7, :, 0] = 2.0
    rand[:, :, ::11, 1] = 2.0
    rand[:, 1, :, :] = 1.0
    rand[:, 2, :, :] = -1.0
    rand_coords = torch.from_numpy(rand).to(dev)

    err = 0.0
    for mode in ("zeros", "border"):
        proj_coords, _ = project_pixel_coords(tgt_depth, pose, intr, mode)
        for label, coords in (("projected", proj_coords.contiguous()), ("random", rand_coords)):
            got = warp_sample(src, coords, mode)
            want = warp_sample_plain(src, coords, mode)
            torch.cuda.synchronize()
            err = max(err, check_close(f"warp_sample {mode}/{label}", got, want, KERNEL_TOL))

    coords, _ = project_pixel_coords(tgt_depth, pose, intr, "zeros")
    coords = coords.contiguous()
    src_nchw = src.permute(0, 3, 1, 2).contiguous()
    lib_out = F.grid_sample(src_nchw, coords, mode="bilinear", padding_mode="zeros",
                            align_corners=False)
    lib_err = (lib_out.permute(0, 2, 3, 1) - warp_sample(src, coords, "zeros")).abs().max().item()
    log(f"  warp_sample vs F.grid_sample (yardstick only): max|err| {lib_err:.3e}")

    ms = cuda_ms(lambda: warp_sample(src, coords, "zeros"), KERNEL_ITERS)
    dev_ms, dev_by = device_ms(lambda: warp_sample(src, coords, "zeros"), "warp_sample")
    plain_ms = cuda_ms(lambda: warp_sample_plain(src, coords, "zeros"), KERNEL_ITERS // 5)
    library_ms = cuda_ms(lambda: F.grid_sample(src_nchw, coords, mode="bilinear",
                                               padding_mode="zeros", align_corners=False),
                         KERNEL_ITERS)
    pixels = PAIRS * H * W
    n_bytes = coords.numel() * 4 + src.numel() * 4 + pixels * 4 * 4
    bound_ms, bound_by = bound(n_bytes, pixels * (30 + 4 * 7))
    log(f"  warp_sample [{PAIRS},{H},{W},4]: kernel {ms:.4f} ms (events), device "
        f"{dev_ms:.4f} ms ({dev_by}, {100 * bound_ms / dev_ms:.0f}% of bound), plain "
        f"{plain_ms:.4f} ms, F.grid_sample {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by})")
    return {"name": "warp_sample", "route": "cuda",
            "source": "sc_sfmlearner_release_tpu_torch/csrc/warp_sample.cu",
            "replaces": "tools/bench_pallas_warp.py:45",
            "max_abs_err": err, "tolerance": KERNEL_TOL, "ms": ms, "device_ms": dev_ms,
            "device_ms_by": dev_by, "bound_share": bound_ms / dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3, "bound_by": bound_by,
            "library_ms": library_ms}


# Shapes that reach every edge of the SSIM kernel's tiling, beside the main
# path's: W % 4 != 0 (one column per lane), W narrower than one strip, a
# ragged last strip, H = W = 2; H is not a multiple of the rows per warp at
# the main shape and at [1,3,256,834]. ssim_phase adds an input that is not
# 16-byte aligned.
SSIM_EDGE_SHAPES = ((2, 3, 37, 53), (1, 3, 256, 834), (2, 3, 40, 64), (3, 3, 100, 200),
                    (1, 3, 2, 2), (1, 1, 2, 4))


def ssim_plan(x: torch.Tensor, y: torch.Tensor) -> str:
    """The SSIM launch's geometry for these inputs, as ``ssim_fwd`` makes it."""
    lib = _build.load("ssim")
    lib.ssim_plan.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.ssim_plan.restype = ctypes.c_int
    plan = (ctypes.c_int * 5)()
    f, c, h, w = x.shape
    # The output is a fresh allocation, aligned as the wrapper's is (0 stands for it).
    code = lib.ssim_plan(x.data_ptr(), y.data_ptr(), 0, f * c, h, w, plan)
    _build.check(lib, code, "ssim_plan")
    return (f"{plan[0]} column(s) per lane, {plan[1]} warps per block, {plan[2]} strip(s) "
            f"per row, {plan[3]} rows per warp, {plan[4]} blocks")


def ssim_phase(rng: np.random.RandomState) -> dict:
    dev = torch.device(DEVICE)
    shape = (PAIRS, 3, H, W)
    err = 0.0
    offset = (1, 2, 64, 128)
    cases = [(shape, False), *((s, False) for s in SSIM_EDGE_SHAPES), (offset, True)]
    for case, misaligned in cases:
        n = int(np.prod(case))
        x = torch.from_numpy(rng.rand(n + 1).astype(np.float32)).to(dev)
        x = x[1:].view(case) if misaligned else x[:n].view(case)
        noise = torch.from_numpy((rng.randn(*case) * 0.05).astype(np.float32)).to(dev)
        indep = torch.from_numpy(rng.rand(*case).astype(np.float32)).to(dev)
        tag = f"[{','.join(map(str, case))}]{' offset by 4 B' if misaligned else ''}"
        log(f"  ssim_nchw {tag}: {ssim_plan(x, indep)}")
        for label, y in (("independent", indep), ("correlated", (x + noise).clamp(0.0, 1.0))):
            got = ssim_nchw(x, y)
            want = ssim_nchw_plain(x, y)
            torch.cuda.synchronize()
            err = max(err, check_close(f"ssim_nchw {tag} {label}", got, want, KERNEL_TOL))

    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev)
    noise = torch.from_numpy((rng.randn(*shape) * 0.05).astype(np.float32)).to(dev)
    y = (x + noise).clamp(0.0, 1.0)
    ms = cuda_ms(lambda: ssim_nchw(x, y), KERNEL_ITERS)
    dev_ms, dev_by = device_ms(lambda: ssim_nchw(x, y), "ssim_kernel")
    plain_ms = cuda_ms(lambda: ssim_nchw_plain(x, y), KERNEL_ITERS // 5)
    # What one PyTorch kernel takes to stream the same bytes: a yardstick of
    # the memory rate a kernel reaches here, not the same function.
    z = torch.empty_like(x)
    stream_ms, _ = device_ms(lambda: torch.add(x, y, out=z), "elementwise_kernel")
    n = x.numel()
    bound_ms, bound_by = bound(3 * n * 4, n * (9 * 8 + 20))
    log(f"  ssim_nchw [{PAIRS},3,{H},{W}]: kernel {ms:.4f} ms (events), device "
        f"{dev_ms:.4f} ms ({dev_by}, {100 * bound_ms / dev_ms:.0f}% of bound), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); torch.add of x and y "
        f"(the same bytes) {stream_ms:.4f} ms")
    return {"name": "ssim_nchw", "route": "cuda",
            "source": "sc_sfmlearner_release_tpu_torch/csrc/ssim.cu",
            "replaces": "sc_sfmlearner_release_tpu/ops/pallas_ssim.py:47",
            "max_abs_err": err, "tolerance": KERNEL_TOL, "ms": ms, "device_ms": dev_ms,
            "device_ms_by": dev_by, "bound_share": bound_ms / dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3, "bound_by": bound_by,
            "library_ms": None, "stream_ms": stream_ms}


def make_batch(rng: np.random.RandomState) -> dict:
    return {"tgt": rng.rand(B, H, W, 3).astype(np.float32),
            "refs": rng.rand(B, N, H, W, 3).astype(np.float32),
            "intrinsics": kitti_intrinsics(B)}


# First match wins: cuDNN's BatchNorm and layout kernels before its convolutions.
KERNEL_GROUPS = (
    ("warp_sample", ("warp_sample",)),
    ("ssim", ("ssim_kernel",)),
    ("batch_norm", ("batch_norm", "bn_fw")),
    ("layout", ("nchwtonhwc", "nhwctonchw")),
    ("conv/gemm", ("conv", "xmma", "cudnn", "gemm", "implicit", "winograd", "fft")),
    ("copy/cast", ("copy", "memcpy", "memset", "catarray")),
    ("reduce", ("reduce",)),
    ("pad/pool/upsample", ("reflection", "pool", "upsample")),
    ("elementwise", ("elementwise",)),
)


def profile_phase(step, batch, steps: int = 3) -> None:
    """Device time by kernel over a few steps (torch.profiler) and the
    device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        log("[profile] the profiler recorded no device time: not measured")
        return
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"[profile] bf16 eval step: wall {wall_ms / steps:.4f} ms/step, device busy "
        f"{busy_ms / steps:.4f} ms/step ({100 * busy_ms / wall_ms:.1f}% of the window)")
    groups = {}
    for us, _, key in rows:
        name = next((g for g, pats in KERNEL_GROUPS if any(p in key.lower() for p in pats)), "other")
        groups[name] = groups.get(name, 0.0) + us / 1e3 / steps
    log("[profile] ms/step by group: " + ", ".join(
        f"{g} {ms:.4f}" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    for us, n, key in rows[:20]:
        log(f"  {us / 1e3 / steps:9.4f} ms/step  x{n // steps:<4d} {key[:100]}")


def slice_phase(seed: int, rng: np.random.RandomState, profile: bool) -> dict:
    disp_net = DispNet(18, generator=torch.Generator().manual_seed(seed))
    pose_net = PoseNet(18, generator=torch.Generator().manual_seed(seed + 1))
    batch = make_batch(rng)
    cfg = LossConfig()
    infer = make_inference_fn(disp_net, device=DEVICE)
    eval_step = make_eval_step(disp_net, pose_net, cfg, device=DEVICE)

    # The main path, with every launch count at 0 just before it.
    warp_sample.launches = 0
    ssim_nchw.launches = 0
    disp, depth = infer(batch["tgt"])
    metrics = eval_step(batch)
    torch.cuda.synchronize()
    launches = {"warp_sample": warp_sample.launches, "ssim_nchw": ssim_nchw.launches}
    log(f"[slice] launches on the main path: {launches}")
    if disp.shape != (B, H, W, 1) or not torch.isfinite(depth).all():
        raise AssertionError(f"inference: shape {tuple(disp.shape)} or non-finite depth")
    if not (disp.min().item() >= 0.01 and disp.max().item() <= 10.01):
        raise AssertionError("inference: disparity outside [0.01, 10.01]")
    vals = {k: metrics[k].item() for k in METRICS}
    log(f"[slice] bf16 eval step: {vals}")
    if not all(np.isfinite(v) for v in vals.values()) or vals["photo_loss"] <= 0:
        raise AssertionError(f"eval step: bad losses {vals}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the main path")

    # fp32 on the card (TF32 off) against the plain versions on the CPU.
    step32 = make_eval_step(disp_net, pose_net, cfg, device=DEVICE, precision="fp32")
    gpu = {k: v.item() for k, v in step32(batch).items()}
    cpu_step = make_eval_step(copy.deepcopy(disp_net), copy.deepcopy(pose_net), cfg,
                              device="cpu", precision="fp32")
    cpu = {k: v.item() for k, v in cpu_step(batch).items()}
    for k in METRICS:
        rel = abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-12)
        log(f"  fp32 {k}: card {gpu[k]:.7f} cpu {cpu[k]:.7f} rel {rel:.2e} (tol {STEP_RTOL:.0e})")
        if not rel <= STEP_RTOL:
            raise AssertionError(f"fp32 eval {k}: card {gpu[k]} vs CPU {cpu[k]}, rel {rel:.2e}")

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(STEP_ITERS):
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t) / STEP_ITERS * 1e3

    on_card = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    times = {
        "eval_step_bf16_ms": host_ms(lambda: eval_step(batch)),
        "eval_step_bf16_batch_on_card_ms": host_ms(lambda: eval_step(on_card)),
        "eval_step_fp32_ms": host_ms(lambda: step32(batch)),
        "inference_bf16_ms": host_ms(lambda: infer(batch["tgt"])),
    }
    log(f"[slice] times (host clock, each step ends in synchronize): {times}")
    log(f"[slice] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_phase(eval_step, on_card)
    return launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="also print the eval step's device time by kernel (torch.profiler)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    smi = device_phase()
    build_phase()
    rng = np.random.RandomState(args.seed)
    log("[kernels] against their plain versions at the main path's shapes")
    kernels = [warp_phase(rng), ssim_phase(rng)]
    launches = slice_phase(args.seed, rng, args.profile)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
