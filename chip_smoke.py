#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--profile] [--graph-seeds N]

``--profile`` adds the validation and train steps' device time by kernel
group (torch.profiler); ``--graph-seeds N`` repeats phase 7's fp32
graph-against-eager check from N more seeds. Phases, each of which fails
the run (non-zero exit) when it fails:

1. Device: the card's name and power limit (nvidia-smi); TF32 off.
2. Build: every CUDA kernel of the port, compiled from ``csrc/`` for
   sm_90a, one nvcc per source, all started together; then every CUDA
   runtime the process has mapped once the libraries are loaded.
3. Kernels against their plain PyTorch versions at the main path's shapes,
   with the tolerance stated: the warp and SSIM forwards (SSIM also at
   shapes that reach every edge of its tiling), and the two backward
   kernels against autograd through the plain versions (the warp's
   d(coords) and d(source depth) in both padding modes on projected and
   random coordinates; SSIM's d/dy and d/dx at every SSIM shape, also
   against its own plain version, with each launch's geometry). Kernel,
   plain and library or stream times. ``ms`` is CUDA events around
   back-to-back wrapper calls; ``device_ms`` is the kernel's own device time
   per call (torch.profiler, or a CUDA graph of the calls replayed under
   CUDA events where the profiler records none).
4. Slices 1-2's paths at full width: ResNet-18 DispNet and PoseNet from a
   seeded ``torch.Generator``, depth inference on [4, 256, 832, 3] and the
   photometric validation step on a B=4, N=2 snippet at 832x256, each with
   the launch counts at 0 just before it; the fp32 validation step against
   the CPU; times.
5. The main path, the train step at full width (B=4, N=2, 832x256, bf16
   convolutions, Adam): one step with the launch counts at 0, in which all
   four kernels must launch; then 8 more steps with finite losses; median
   step time fed a numpy batch and with the batch on the card; peak memory.
   Then the fp32 train step on the card against the CPU's plain step at
   B2 N2 128x416 (full-width ResNet-18): losses and every gradient.
6. This slice's main path, the train CLI from disk: a packed dataset written
   from ``--seed`` (two train scenes of 24 frames and a val scene of 12 at
   832x256), ``python -m sc_sfmlearner_release_tpu_torch.train`` through
   its ``main`` for 2 epochs of 10 steps (B4 N2, ``--packed
   --device-augment``, bf16) with the launch counts at 0 just before it:
   every kernel launches in every train step, 20 finite loss rows, the
   checkpoints load into fresh networks; the restored Adam state equals the
   saved one and a ``--resume`` epoch continues at step 21. The
   augmentation on the card against the CPU with the same draws, one fp32
   ``remat`` step against a plain one (losses, BatchNorm statistics), and
   times: the CLI's steady step and data wait, its loader alone, the same
   step on a batch on the card, the augmentation, and the pinned uint8 copy
   against a pageable fp32 one.
7. The train step as CUDA-graph replays of K steps
   (``make_train_step(fused_steps=K)``, capturable Adam, device
   augmentation on uint8 frames) at full width: fp32 (TF32 off) K = 3
   through three calls (an eager warm-up, a capture and replay, a replay),
   each call against K eager steps on a deep copy of the same nets and
   optimizer put in the graph's state before the call, with the same
   batches, without and with ``remat`` (per-step losses, parameters as the
   JAX package's fused test bounds them, BatchNorm statistics; each loss
   term's error relative to the total loss); two more eager copies
   measure the eager step's own run-to-run noise (the warp backward's
   atomics, which Adam amplifies from step to step), and each bound is
   the larger of its fixed value and 4x that noise; the
   graphed step's launches over two replays with the counts at 0; then
   bf16 K = 5: its device time per step, the host time of a call that
   waits for its result, and peak memory.
8. This slice's main path, the train CLI with ``--fused-steps 5`` on the
   same packed dataset, 2 epochs of 10 steps (2 dispatches each) with the
   launch counts at 0 just before it: launches that count the replays, 20
   finite loss rows, checkpoints that load into fresh networks, a
   ``--resume`` run without ``--fused-steps`` (a capturable Adam's state
   into a plain one) that continues at step 21; its step per optimizer
   step and data wait, peak memory. Then ``--profile-dir`` traces of one
   eager CLI dispatch and one fused one, each summarized (kernels
   recorded, device busy time, launches on the host).
9. Output: a ``{"kernels": [...]}`` line (``launches``: the fused CLI
   run's, with every path's in ``launches_by_path``), the nvidia-smi line,
   and last ``{"ok": true, "device": {...}}``.

Without a card it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import ctypes
import glob
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from sc_sfmlearner_release_tpu_torch import disable_tf32
from sc_sfmlearner_release_tpu_torch import train as train_cli
from sc_sfmlearner_release_tpu_torch.data import BatchLoader, PackedSequenceSet, device_augment
from sc_sfmlearner_release_tpu_torch.models import DispNet, PoseNet
from sc_sfmlearner_release_tpu_torch.models.convert import load_torch_state_dict
from sc_sfmlearner_release_tpu_torch.ops import KERNEL_WRAPPERS, _build
from sc_sfmlearner_release_tpu_torch.ops.geometry import project_pixel_coords
from sc_sfmlearner_release_tpu_torch.ops.ssim import (
    ssim_nchw, ssim_nchw_bwd, ssim_nchw_bwd_plain, ssim_nchw_plain,
)
from sc_sfmlearner_release_tpu_torch.ops.warp import (
    warp_sample, warp_sample_bwd, warp_sample_plain,
)
from sc_sfmlearner_release_tpu_torch.parallel import device_prefetch
from sc_sfmlearner_release_tpu_torch.training import (
    LossConfig, create_train_state, make_eval_step, make_inference_fn, make_optimizer,
    make_train_step,
)
from sc_sfmlearner_release_tpu_torch.training.checkpoint import restore_train_state

DEVICE = "cuda"
B, N, H, W = 4, 2, 256, 832
PAIRS = 2 * N * B
KERNEL_TOL = 1e-5   # abs: the same fp32 arithmetic, rounded in another order
# Backward kernels, max|err| over max|ref|: the same derivative as autograd
# through the plain version, summed in another order (the warp's d(source)
# with atomics, in an order that changes from run to run).
GRAD_TOL = 1e-5
STEP_RTOL = 1e-3    # rel: cuDNN and the CPU sum the convolutions in another order
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
METRICS = ("loss", "photo_loss", "geometry_loss", "smooth_loss")
KERNEL_ITERS = 50   # timed launches per kernel
STEP_ITERS = 10     # timed steps per entry point
TRAIN_STEPS = 8     # bf16 train steps whose losses must stay finite
CHECK_SHAPE = (2, 2, 128, 416)  # B, N, H, W of the fp32 card-vs-CPU train step
# Gradients of the fp32 card step against the CPU's, relative L2 per tensor.
# At random init they are kinky: BatchNorm on batch statistics spreads every
# ReLU kink and mask flip over a channel, and the loss's masks flip pixels.
# On the CPU alone, perturbing the frames by 1e-6 moves them at this shape
# by up to 1.8e-2 (encoders) and 7.9e-3 (decoders and heads), two trials;
# the tolerances are about twice that.
GRAD_RTOL = {"encoders": 3e-2, "decoders": 1.5e-2}


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


def device_ms(fn, kernel, iters: int = KERNEL_ITERS):
    """(ms, how): the device time per call of the kernels whose names hold
    ``kernel`` (a string, or a tuple of them: each must run once per call),
    over ``iters`` back-to-back calls of ``fn``. torch.profiler first; where
    it records no such launches, a CUDA graph of the calls replayed under
    CUDA events, which leaves the host out too."""
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    counts = [sum(e.count for e in events if n in e.key) for n in names]
    us = sum(e.self_device_time_total for e in events if any(n in e.key for n in names))
    if all(c == iters for c in counts) and us > 0:
        return us / iters / 1e3, "profiler"
    log(f"  {names}: the profiler recorded {counts} of {iters} launches each; "
        "timing a CUDA graph of them instead")
    return graph_ms(fn, iters), "cuda_graph"


def graph_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph (after three on a side stream), replayed under CUDA events. The
    host's dispatch stays out, so this is the device's own time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
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
    return start.elapsed_time(end) / iters


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
    names = ("warp_sample", "ssim", "ssim_bwd")
    secs = _build.build(names, verbose=True, force=True)
    log(f"[build] {' + '.join(n + '.cu' for n in names)} for sm_90a in {secs:.1f} s "
        "(parallel nvcc)")
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


def check_rel(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """max|got - want| over max|want|: for gradients, whose scale follows
    the inputs (d(coords) is ~W/2 times a source difference)."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item() / max(scale, 1e-30)
    log(f"  {name}: max|err|/max|ref| {err:.3e} (tol {tol:.0e}, max|ref| {scale:.3e})")
    if not (err <= tol and torch.isfinite(got).all().item()):
        raise AssertionError(f"{name}: max|err|/max|ref| {err:.3e} > {tol:.0e}")
    return err


def warp_inputs(rng: np.random.RandomState) -> dict:
    """The warp's inputs at the main path's shapes: a packed [depth, RGB]
    source, and per padding mode the slice's own projection (smooth target
    depth, small motions) beside random coordinates with out-of-range
    values, exact 2.0 and +-1."""
    dev = torch.device(DEVICE)
    depth = rng.uniform(1.0, 80.0, (PAIRS, H, W, 1)).astype(np.float32)
    rgb = rng.rand(PAIRS, H, W, 3).astype(np.float32)
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
    cases = []
    for mode in ("zeros", "border"):
        proj_coords, _ = project_pixel_coords(tgt_depth, pose, intr, mode)
        cases += [(mode, "projected", proj_coords.contiguous()), (mode, "random", rand_coords)]
    return {"depth": torch.from_numpy(depth).to(dev), "rgb": torch.from_numpy(rgb).to(dev),
            "src": torch.from_numpy(np.concatenate([depth, rgb], -1)).to(dev), "cases": cases}


def warp_phase(inputs: dict) -> dict:
    src = inputs["src"]
    err = 0.0
    for mode, label, coords in inputs["cases"]:
        got = warp_sample(src, coords, mode)
        want = warp_sample_plain(src, coords, mode)
        torch.cuda.synchronize()
        err = max(err, check_close(f"warp_sample {mode}/{label}", got, want, KERNEL_TOL))

    coords = inputs["cases"][0][2]
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


def plain_grads(fn, inputs, dout):
    """Autograd through a plain version: ``(grads, again)``, where ``again()``
    reruns only the backward of the same graph (for timing)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    return grads, lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def warp_bwd_check(inputs: dict, rng: np.random.RandomState) -> float:
    """The backward kernel against autograd through the plain version, for
    d(coords) and d(source depth), and once through the autograd Function."""
    depth, rgb, src = inputs["depth"], inputs["rgb"], inputs["src"]
    dout = torch.from_numpy(rng.randn(PAIRS, H, W, 4).astype(np.float32)).to(DEVICE)
    err = 0.0
    for mode, label, coords in inputs["cases"]:
        dsrc, dcoords = warp_sample_bwd(src, coords, dout, mode, 1, True)
        (want_d, want_c), _ = plain_grads(
            lambda d, c: warp_sample_plain(d, c, mode, frozen=rgb), (depth, coords), dout)
        torch.cuda.synchronize()
        err = max(err, check_rel(f"warp_sample_bwd {mode}/{label} d(coords)", dcoords, want_c,
                                 GRAD_TOL))
        err = max(err, check_rel(f"warp_sample_bwd {mode}/{label} d(depth)", dsrc, want_d,
                                 GRAD_TOL))
    mode, label, coords = inputs["cases"][0]
    d = depth.clone().requires_grad_(True)
    c = coords.clone().requires_grad_(True)
    got_d, got_c = torch.autograd.grad(warp_sample(d, c, mode, frozen=rgb), (d, c), dout)
    (want_d, want_c), _ = plain_grads(
        lambda d, c: warp_sample_plain(d, c, mode, frozen=rgb), (depth, coords), dout)
    err = max(err, check_rel(f"warp_sample autograd Function {mode}/{label} d(coords)",
                             got_c, want_c, GRAD_TOL))
    err = max(err, check_rel(f"warp_sample autograd Function {mode}/{label} d(depth)",
                             got_d, want_d, GRAD_TOL))
    return err


def warp_bwd_phase(inputs: dict, rng: np.random.RandomState) -> dict:
    err = warp_bwd_check(inputs, rng)
    src, rgb, depth = inputs["src"], inputs["rgb"], inputs["depth"]
    coords = inputs["cases"][0][2]
    dout = torch.from_numpy(rng.randn(PAIRS, H, W, 4).astype(np.float32)).to(DEVICE)
    call = lambda: warp_sample_bwd(src, coords, dout, "zeros", 1, True)
    ms = cuda_ms(call, KERNEL_ITERS)
    dev_ms, dev_by = device_ms(call, ("warp_sample_bwd", "Memset"))
    _, plain = plain_grads(lambda d, c: warp_sample_plain(d, c, "zeros", frozen=rgb),
                           (depth, coords), dout)
    plain_ms = cuda_ms(plain, KERNEL_ITERS // 5)
    # Yardstick: F.grid_sample's backward for its input (all 4 channels) and grid.
    _, library = plain_grads(
        lambda s, c: F.grid_sample(s, c, mode="bilinear", padding_mode="zeros",
                                   align_corners=False),
        (src.permute(0, 3, 1, 2).contiguous(), coords), dout.permute(0, 3, 1, 2))
    library_ms = cuda_ms(library, KERNEL_ITERS)
    pixels = PAIRS * H * W
    # Read dout, coords and the source once; write d(coords) and d(depth) once.
    n_bytes = pixels * (4 * 4 + 8 + 4 * 4 + 8 + 4)
    bound_ms, bound_by = bound(n_bytes, pixels * (30 + 4 * 8 + 20 + 4 * 2))
    log(f"  warp_sample_bwd [{PAIRS},{H},{W},4] -> d(coords), d(depth): kernel {ms:.4f} ms "
        f"(events), device {dev_ms:.4f} ms with its zero fill ({dev_by}, "
        f"{100 * bound_ms / dev_ms:.0f}% of bound), plain (autograd) {plain_ms:.4f} ms, "
        f"F.grid_sample backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "warp_sample_bwd", "route": "cuda",
            "source": "sc_sfmlearner_release_tpu_torch/csrc/warp_sample.cu",
            "replaces": "sc_sfmlearner_release_tpu/ops/warp_band.py:438",
            "max_abs_err": err, "max_err_is": "relative to max|ref|", "tolerance": GRAD_TOL,
            "ms": ms, "device_ms": dev_ms, "device_ms_by": dev_by,
            "bound_share": bound_ms / dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_us": bound_ms * 1e3, "bound_by": bound_by, "library_ms": library_ms}


# Shapes that reach every edge of the SSIM kernels' tilings, beside the main
# path's: W % 4 != 0 (one column per lane), W narrower than one strip, a
# ragged last strip, H = W = 2; H is not a multiple of the rows per warp at
# the main shape and at [1,3,256,834]. The backward's strips write 120
# columns (28 at one column per lane) after a first strip of 124 (30): widths
# 244 and 248, 57 and 59 lie on either side of a strip boundary, and H = 3 is
# below its rows per warp plus the 4 halo rows. ssim_cases adds an input that
# is not 16-byte aligned.
SSIM_EDGE_SHAPES = ((2, 3, 37, 53), (1, 3, 256, 834), (2, 3, 40, 64), (3, 3, 100, 200),
                    (1, 3, 2, 2), (1, 1, 2, 4), (1, 3, 9, 244), (1, 3, 3, 248), (1, 2, 6, 57),
                    (1, 2, 6, 59))


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


def ssim_bwd_plan(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> str:
    """The SSIM backward launch's geometry for these inputs, as ``ssim_bwd``
    makes it."""
    lib = _build.load("ssim_bwd")
    lib.ssim_bwd_plan.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.ssim_bwd_plan.restype = ctypes.c_int
    plan = (ctypes.c_int * 5)()
    f, c, h, w = x.shape
    # The gradients are fresh allocations, aligned as the wrapper's are (0 stands for them).
    code = lib.ssim_bwd_plan(x.data_ptr(), y.data_ptr(), g.data_ptr(), 0, 0, f * c, h, w, plan)
    _build.check(lib, code, "ssim_bwd_plan")
    return (f"{plan[0]} column(s) per lane, {plan[1]} warps per block, {plan[2]} strip(s) "
            f"per row, {plan[3]} rows per warp, {plan[4]} blocks")


def ssim_cases(rng: np.random.RandomState):
    """(tag, x, [(label, y), ...]) at the main path's shape, the edge shapes
    and an input 4 bytes off alignment; y independent of x, and correlated."""
    dev = torch.device(DEVICE)
    offset = (1, 2, 64, 128)
    cases = [((PAIRS, 3, H, W), False), *((s, False) for s in SSIM_EDGE_SHAPES), (offset, True)]
    for case, misaligned in cases:
        n = int(np.prod(case))
        x = torch.from_numpy(rng.rand(n + 1).astype(np.float32)).to(dev)
        x = x[1:].view(case) if misaligned else x[:n].view(case)
        noise = torch.from_numpy((rng.randn(*case) * 0.05).astype(np.float32)).to(dev)
        indep = torch.from_numpy(rng.rand(*case).astype(np.float32)).to(dev)
        tag = f"[{','.join(map(str, case))}]{' offset by 4 B' if misaligned else ''}"
        yield tag, x, (("independent", indep), ("correlated", (x + noise).clamp(0.0, 1.0)))


def ssim_phase(rng: np.random.RandomState) -> dict:
    dev = torch.device(DEVICE)
    shape = (PAIRS, 3, H, W)
    err = 0.0
    for tag, x, ys in ssim_cases(rng):
        log(f"  ssim_nchw {tag}: {ssim_plan(x, ys[0][1])}")
        for label, y in ys:
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


def ssim_bwd_check(rng: np.random.RandomState) -> float:
    """The backward kernel against autograd through the plain forward and
    against its own plain version ``ssim_nchw_bwd_plain``, for d/dy alone
    (the main path's call) and d/dx with d/dy, at every SSIM case; and once
    through the autograd Function."""
    err = 0.0
    for tag, x, ys in ssim_cases(rng):
        g = torch.from_numpy(rng.randn(*x.shape).astype(np.float32)).to(DEVICE)
        log(f"  ssim_nchw_bwd {tag}: {ssim_bwd_plan(x, ys[0][1], g)}")
        for label, y in ys:
            (want_x, want_y), _ = plain_grads(ssim_nchw_plain, (x, y), g)
            plain_x, plain_y = ssim_nchw_bwd_plain(x, y, g, need_x=True)
            _, dy_only = ssim_nchw_bwd(x, y, g)
            dx, dy = ssim_nchw_bwd(x, y, g, need_x=True)
            torch.cuda.synchronize()
            name = f"ssim_nchw_bwd {tag} {label}"
            for ref, want in (("autograd", (want_x, want_y)), ("plain", (plain_x, plain_y))):
                err = max(err, check_rel(f"{name} d/dy alone vs {ref}", dy_only, want[1],
                                         GRAD_TOL))
                err = max(err, check_rel(f"{name} d/dy vs {ref}", dy, want[1], GRAD_TOL))
                err = max(err, check_rel(f"{name} d/dx vs {ref}", dx, want[0], GRAD_TOL))
    y = ys[1][1].clone().requires_grad_(True)
    got_y, = torch.autograd.grad(ssim_nchw(x, y), (y,), g)
    (_, want_y), _ = plain_grads(ssim_nchw_plain, (x, y), g)
    return max(err, check_rel(f"ssim_nchw autograd Function {tag} d/dy", got_y, want_y, GRAD_TOL))


def ssim_bwd_phase(rng: np.random.RandomState) -> dict:
    err = ssim_bwd_check(rng)
    shape = (PAIRS, 3, H, W)
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(DEVICE)
    noise = torch.from_numpy((rng.randn(*shape) * 0.05).astype(np.float32)).to(DEVICE)
    y = (x + noise).clamp(0.0, 1.0)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(DEVICE)
    call = lambda: ssim_nchw_bwd(x, y, g)
    ms = cuda_ms(call, KERNEL_ITERS)
    dev_ms, dev_by = device_ms(call, "ssim_bwd_kernel")
    dx_ms, _ = device_ms(lambda: ssim_nchw_bwd(x, y, g, need_x=True), "ssim_bwd_kernel")
    plain_ms = cuda_ms(lambda: ssim_nchw_bwd_plain(x, y, g), KERNEL_ITERS // 5)
    _, autograd = plain_grads(lambda b: ssim_nchw_plain(x, b), (y,), g)
    autograd_ms = cuda_ms(autograd, KERNEL_ITERS // 5)
    # The same bytes through one PyTorch kernel: read x, y, g, write one map.
    z = torch.empty_like(x)
    stream_ms, _ = device_ms(lambda: torch.addcmul(x, y, g, out=z), "elementwise")
    n = x.numel()
    bound_ms, bound_by = bound(4 * n * 4, n * (9 * 8 + 60 + 3 * 18 + 6))
    dx_bound_ms, _ = bound(5 * n * 4, n * (9 * 8 + 70 + 4 * 18 + 12))
    log(f"  ssim_nchw_bwd [{PAIRS},3,{H},{W}] -> d/dy: kernel {ms:.4f} ms (events), device "
        f"{dev_ms:.4f} ms ({dev_by}, {100 * bound_ms / dev_ms:.0f}% of bound), with d/dx "
        f"too {dx_ms:.4f} ms ({100 * dx_bound_ms / dx_ms:.0f}% of its {dx_bound_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, autograd of the plain forward {autograd_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); torch.addcmul of x, y, g (the same bytes) "
        f"{stream_ms:.4f} ms")
    return {"name": "ssim_nchw_bwd", "route": "cuda",
            "source": "sc_sfmlearner_release_tpu_torch/csrc/ssim_bwd.cu",
            "replaces": "sc_sfmlearner_release_tpu/ops/pallas_ssim.py:150",
            "max_abs_err": err, "max_err_is": "relative to max|ref|", "tolerance": GRAD_TOL,
            "ms": ms, "device_ms": dev_ms, "device_ms_by": dev_by,
            "bound_share": bound_ms / dev_ms, "dx_dy_device_ms": dx_ms,
            "dx_dy_bound_ms": dx_bound_ms, "plain_ms": plain_ms, "autograd_ms": autograd_ms,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3, "bound_by": bound_by,
            "library_ms": None, "stream_ms": stream_ms}


def make_batch(rng: np.random.RandomState) -> dict:
    return {"tgt": rng.rand(B, H, W, 3).astype(np.float32),
            "refs": rng.rand(B, N, H, W, 3).astype(np.float32),
            "intrinsics": kitti_intrinsics(B)}


# First match wins: the backward kernels before the forwards, cuDNN's
# BatchNorm and layout kernels before its convolutions.
KERNEL_GROUPS = (
    ("warp_sample_bwd", ("warp_sample_bwd",)),
    ("warp_sample", ("warp_sample",)),
    ("ssim_bwd", ("ssim_bwd_kernel",)),
    ("ssim", ("ssim_kernel",)),
    ("batch_norm", ("batch_norm", "bn_fw", "bn_bw")),
    ("layout", ("nchwtonhwc", "nhwctonchw")),
    ("conv/gemm", ("conv", "xmma", "cudnn", "gemm", "implicit", "winograd", "fft", "dgrad",
                   "wgrad")),
    ("optimizer", ("multi_tensor", "adam")),
    ("copy/cast", ("copy", "memcpy", "memset", "catarray")),
    ("reduce", ("reduce",)),
    ("pad/pool/upsample", ("reflection", "pool", "upsample")),
    ("elementwise", ("elementwise",)),
)


def profile_window(step, batch, steps: int):
    """One profiled window of ``steps`` steps: (rows of (device us, count,
    kernel) without the annotation ranges ("Optimizer.step#Adam.step"),
    which span kernels counted on their own; wall ms; whether the device
    recorded every launch, copy and fill the host asked for)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            step(batch)
            torch.cuda.synchronize()  # fewer device records outstanding at once
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    rows = [(e.self_device_time_total, e.count, e.key) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and "#" not in e.key]
    calls = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CPU
                and e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
                                      "cudaMemsetAsync")))
    return sorted(rows, reverse=True), wall_ms, sum(r[1] for r in rows) >= calls


def profile_phase(step, batch, label: str, steps: int = 3, tries: int = 3) -> None:
    """Device time by kernel over a few steps (torch.profiler) and the
    device's busy share of the window. The profiler can drop device events;
    a window whose device records fall short of the host's calls is taken
    again, up to ``tries`` times, and otherwise reported as a lower bound."""
    step(batch)
    torch.cuda.synchronize()
    for _ in range(tries):
        rows, wall_ms, complete = profile_window(step, batch, steps)
        if complete:
            break
    if not rows:
        log("[profile] the profiler recorded no device time: not measured")
        return
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"[profile] {label}: wall {wall_ms / steps:.4f} ms/step, device busy "
        f"{busy_ms / steps:.4f} ms/step ({100 * busy_ms / wall_ms:.1f}% of the window); "
        + ("every launch recorded" if complete else
           f"events were dropped in {tries} windows, busy is a lower bound"))
    groups = {}
    for us, _, key in rows:
        name = next((g for g, pats in KERNEL_GROUPS if any(p in key.lower() for p in pats)), "other")
        groups[name] = groups.get(name, 0.0) + us / 1e3 / steps
    log("[profile] ms/step by group: " + ", ".join(
        f"{g} {ms:.4f}" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    for us, n, key in rows[:20]:
        log(f"  {us / 1e3 / steps:9.4f} ms/step  x{n // steps:<4d} {key[:100]}")


# Every kernel wrapper of the port, by the name the kernels line gives it.
WRAPPERS = {fn.__name__: fn for fn in KERNEL_WRAPPERS}


def zero_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def make_nets(seed: int):
    return (DispNet(18, generator=torch.Generator().manual_seed(seed)),
            PoseNet(18, generator=torch.Generator().manual_seed(seed + 1)))


def slice_phase(seed: int, rng: np.random.RandomState, profile: bool) -> dict:
    """Slices 1-2's paths: depth inference and the photometric validation
    step, forward only."""
    disp_net, pose_net = make_nets(seed)
    batch = make_batch(rng)
    cfg = LossConfig()
    infer = make_inference_fn(disp_net, device=DEVICE)
    eval_step = make_eval_step(disp_net, pose_net, cfg, device=DEVICE)

    # Each path with every launch count at 0 just before it.
    zero_launches()
    disp, depth = infer(batch["tgt"])
    infer_launches = read_launches()
    zero_launches()
    metrics = eval_step(batch)
    launches = read_launches()
    log(f"[slice] launches: inference {infer_launches}, validation step {launches}")
    if launches["warp_sample_bwd"] or launches["ssim_nchw_bwd"]:
        raise AssertionError("the validation step launched a backward kernel")
    if disp.shape != (B, H, W, 1) or not torch.isfinite(depth).all():
        raise AssertionError(f"inference: shape {tuple(disp.shape)} or non-finite depth")
    if not (disp.min().item() >= 0.01 and disp.max().item() <= 10.01):
        raise AssertionError("inference: disparity outside [0.01, 10.01]")
    vals = {k: metrics[k].item() for k in METRICS}
    log(f"[slice] bf16 eval step: {vals}")
    if not all(np.isfinite(v) for v in vals.values()) or vals["photo_loss"] <= 0:
        raise AssertionError(f"eval step: bad losses {vals}")
    for name in ("warp_sample", "ssim_nchw"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the validation path")

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

    on_card = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    times = {
        "eval_step_bf16_ms": host_ms(lambda: eval_step(batch)),
        "eval_step_bf16_batch_on_card_ms": host_ms(lambda: eval_step(on_card)),
        "eval_step_fp32_ms": host_ms(lambda: step32(batch)),
        "inference_bf16_ms": host_ms(lambda: infer(batch["tgt"])),
    }
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # The device's own time per step: no host in a CUDA-graph replay.
    times["eval_step_bf16_device_ms"] = graph_ms(lambda: eval_step(on_card), 3)
    log(f"[slice] times (host clock, median of {STEP_ITERS}, each step ends in synchronize; "
        f"device_ms from a CUDA-graph replay): {times}")
    log(f"[slice] peak device memory {peak_gib:.2f} GiB")
    if profile:
        profile_phase(eval_step, on_card, "bf16 eval step")
    return {"inference": infer_launches, "validation_step": launches}


def host_ms(fn, iters: int = STEP_ITERS) -> float:
    """Median host-clock ms of ``fn`` over ``iters`` runs, each ending in
    synchronize, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def spread_heads(disp_net, pose_net, seed: int) -> None:
    """A realistic scene for comparing gradients, as the CPU tests do: at
    initialisation the disparity heads are nearly constant and the poses
    ~1e-4, so the geometry term is a difference of nearly equal depths."""
    with torch.no_grad():
        for s in range(4):
            disp_net.decoder.decoder[10 + s].conv.weight.mul_(20.0)
        motion = np.random.RandomState(seed).randn(6) * [1.0, 1.0, 1.0, 0.5, 0.5, 0.5]
        pose_net.decoder.net[3].bias.copy_(torch.from_numpy(motion.astype(np.float32)))


def grads_by_name(*nets) -> dict:
    return {f"{i}.{name}": p.grad.detach().double().cpu() for i, net in enumerate(nets)
            for name, p in net.named_parameters() if p.grad is not None}


def check_step_against_cpu(seed: int, rng: np.random.RandomState) -> dict:
    """The fp32 train step on the card (TF32 off) against the plain versions
    on the CPU, at B2 N2 128x416 with full-width ResNet-18: losses, and each
    parameter's gradient by relative L2."""
    b, n, h, w = CHECK_SHAPE
    k = kitti_intrinsics(b)
    k[:, :2] *= np.array([[w / W], [h / H]], np.float32)
    batch = {"tgt": rng.rand(b, h, w, 3).astype(np.float32),
             "refs": rng.rand(b, n, h, w, 3).astype(np.float32), "intrinsics": k}
    disp_net, pose_net = make_nets(seed)
    spread_heads(disp_net, pose_net, seed)
    cpu_nets = (copy.deepcopy(disp_net), copy.deepcopy(pose_net))
    card = make_train_step(disp_net, pose_net, make_optimizer(disp_net, pose_net),
                           device=DEVICE, precision="fp32")
    cpu = make_train_step(*cpu_nets, make_optimizer(*cpu_nets), device="cpu", precision="fp32")
    got = {k: v.item() for k, v in card(batch).items()}
    want = {k: v.item() for k, v in cpu(batch).items()}
    worst = {}
    for key in METRICS:
        rel = abs(got[key] - want[key]) / max(abs(want[key]), 1e-12)
        worst[key] = rel
        log(f"  fp32 train {key}: card {got[key]:.7f} cpu {want[key]:.7f} rel {rel:.2e} "
            f"(tol {STEP_RTOL:.0e})")
        if not rel <= STEP_RTOL:
            raise AssertionError(f"fp32 train {key}: card {got[key]} vs CPU {want[key]}")
    g_card, g_cpu = grads_by_name(disp_net, pose_net), grads_by_name(*cpu_nets)
    if set(g_card) != set(g_cpu) or len(g_cpu) < 100:
        raise AssertionError(f"gradients of {len(g_card)} and {len(g_cpu)} tensors")
    rels = {}
    for name, ref in g_cpu.items():
        rels[name] = ((g_card[name] - ref).norm() / ref.norm().clamp_min(1e-30)).item()
    for part, tol in GRAD_RTOL.items():
        mine = {k: v for k, v in rels.items() if (".encoder." in k) == (part == "encoders")}
        top = max(mine, key=mine.get)
        log(f"  fp32 train gradients, {part}: {len(mine)} tensors, median rel L2 "
            f"{np.median(list(mine.values())):.2e}, worst {mine[top]:.2e} ({top}) (tol {tol:.1e})")
        if not mine[top] <= tol:
            raise AssertionError(f"fp32 train gradient {top}: rel L2 {mine[top]:.2e} > {tol}")
        worst[f"grad_{part}"] = mine[top]
    return worst


def train_phase(seed: int, rng: np.random.RandomState, profile: bool):
    """Slice 3's path: the bf16 train step at full width. Returns its
    launches and its device time per step."""
    disp_net, pose_net = make_nets(seed)
    batch = make_batch(rng)
    state = create_train_state(disp_net, pose_net, make_optimizer(disp_net, pose_net))
    step = make_train_step(disp_net, pose_net, state.optimizer, LossConfig(), device=DEVICE)
    torch.cuda.reset_peak_memory_stats()

    zero_launches()
    first = step(batch)
    launches = read_launches()
    log(f"[train] launches in one bf16 train step: {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched by the train step")
    losses = [first["loss"].item()] + [step(batch)["loss"].item() for _ in range(TRAIN_STEPS)]
    log(f"[train] bf16 losses over {len(losses)} steps: {[round(x, 6) for x in losses]}")
    if not all(np.isfinite(losses)) or state.step != TRAIN_STEPS + 1:
        raise AssertionError(f"train step: losses {losses}, {state.step} optimizer steps")

    on_card = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    times = {"train_step_bf16_ms": host_ms(lambda: step(batch)),
             "train_step_bf16_batch_on_card_ms": host_ms(lambda: step(on_card))}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # The device's own time per step, from a CUDA-graph replay of the same
    # step on a copy of the nets; capture needs Adam's capturable form,
    # which keeps its step count on the card.
    nets = (copy.deepcopy(disp_net), copy.deepcopy(pose_net))
    adam = torch.optim.Adam([q for net in nets for q in net.parameters()], lr=1e-4,
                            eps=1e-8, capturable=True)
    graph_step = make_train_step(*nets, adam, LossConfig(), device=DEVICE)
    times["train_step_bf16_device_ms"] = graph_ms(lambda: graph_step(on_card), 3)
    times["device_busy_share"] = (times["train_step_bf16_device_ms"]
                                  / times["train_step_bf16_batch_on_card_ms"])
    del graph_step, adam, nets
    log(f"[train] times (host clock, median of {STEP_ITERS}, each step ends in synchronize; "
        f"device_ms from a CUDA-graph replay): {times}")
    log(f"[train] peak device memory {peak_gib:.2f} GiB")
    if profile:
        profile_phase(step, on_card, "bf16 train step")
    del step, state, disp_net, pose_net
    log("[train] fp32 step on the card against the CPU's plain step")
    check_step_against_cpu(seed + 2, rng)
    return launches, times["train_step_bf16_device_ms"]


# The trainer phase: the canonical KITTI run (scripts/train_resnet18_depth_256.sh)
# at full width, from a packed dataset written in data/packed.py's format.
CLI_SCENES = (("train_a", 24), ("train_b", 24), ("val_a", 12))
CLI_EPOCHS, CLI_EPOCH_SIZE, CLI_VAL_BATCHES = 2, 10, 2
CLI_STEPS = CLI_EPOCHS * CLI_EPOCH_SIZE
TRAINER_DIR = os.path.join("build", "chip_smoke_trainer")
AUG_TOL = 1e-5           # abs on normalized frames; intrinsics rel
REMAT_LOSS_RTOL = 1e-5   # the remat step's forward is the plain step's
REMAT_STATS_TOL = 1e-6   # abs, BatchNorm running statistics
# The graphed train step against eager steps (fp32, TF32 off): the same
# kernels and cuDNN algorithms, but the warp's d(depth) scatters with
# atomics in an order that changes from run to run, so nothing is bitwise,
# and Adam turns that noise into whole updates of either sign where a
# gradient is near 0. Left to run on, two eager copies drift apart as
# fast as the graph drifts from either (losses 1e-3 apart after 9 steps),
# so each call is held against eager steps that start from the graph's
# own state, and NOISE_COPIES more eager copies measure the same noise in
# the same run: each bound below is the larger of its fixed value and
# NOISE_FACTOR times the largest disagreement of a copy with the first.
# At random init the geometry term is a small difference of nearly equal
# depths, and two eager copies' geometry losses differ by up to rel 5e-4
# within 3 steps: each term's error is taken relative to the total loss.
GRAPH_K, GRAPH_CALLS = 3, 3
NOISE_COPIES = 2
GRAPH_LOSS_RTOL = 1e-4   # per step, relative to the step's total loss
GRAPH_STATS_RTOL = 1e-4  # BatchNorm running statistics, max|err| over max|ref| per tensor
# Parameters, as the JAX package's fused test bounds them
# (tests/test_training.py:284-314), over each call's K steps: Adam moves
# each element by about lr a step whatever its gradient (elementwise bound
# 2 * lr * K); the disagreement's L2 norm under 2% of the update's.
GRAPH_TRAJ_RTOL = 0.02
NOISE_FACTOR = 4
LR = 1e-4                # make_optimizer's default
CLI_FUSED_K = 5          # the CLI's --fused-steps: 2 dispatches per 10-step epoch


def write_packed_dataset(root: str, seed: int) -> int:
    """CLI_SCENES as a packed dataset under ``root/packed``: per scene a
    camera panning over a texture (8x8-pixel blocks of noise with finer noise
    on them), 2 pixels per frame, with KITTI's intrinsics. Returns the
    frames' bytes."""
    rng = np.random.RandomState(seed)
    packed = os.path.join(root, "packed")
    os.makedirs(packed)
    n_frames = sum(n for _, n in CLI_SCENES)
    frames = np.memmap(os.path.join(packed, "frames.u8"), np.uint8, "w+",
                       shape=(n_frames, H, W, 3))
    scenes, start = {}, 0
    for name, count in CLI_SCENES:
        coarse = rng.randint(32, 224, (-(-H // 8), -(-(W + 2 * count) // 8), 3))
        texture = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:H, :W + 2 * count]
        texture = np.clip(texture + rng.randint(-24, 25, texture.shape), 0, 255).astype(np.uint8)
        for i in range(count):
            frames[start + i] = texture[:, 2 * i:2 * i + W]
        scenes[name] = {"start": start, "count": count,
                        "intrinsics": kitti_intrinsics(1)[0].tolist()}
        start += count
    frames.flush()
    del frames
    index = {"height": H, "width": W, "n_frames": n_frames, "scenes": scenes,
             "train": [n for n, _ in CLI_SCENES if n.startswith("train")],
             "val": [n for n, _ in CLI_SCENES if n.startswith("val")]}
    with open(os.path.join(packed, "index.json"), "w") as f:
        json.dump(index, f)
    return n_frames * H * W * 3


def run_cli(root: str, name: str, seed: int, *extra: str) -> str:
    """``train.main`` from ``root`` (where ``checkpoints/`` lands) on the
    canonical configuration; returns the experiment directory. The CLI's
    progress lines are printed after it ends."""
    argv = [root, "--name", name, "--packed", "--device-augment",
            "--with-pretrain", "0", "-b", str(B), "--sequence-length", str(1 + N),
            "--with-auto-mask", "1", "--epochs", str(CLI_EPOCHS), "--epoch-size",
            str(CLI_EPOCH_SIZE), "--val-batches", str(CLI_VAL_BATCHES), "--no-tensorboard",
            "--log-style", "line", "--seed", str(seed), *extra]
    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with contextlib.redirect_stdout(out):
            code = train_cli.main(argv)
    finally:
        os.chdir(cwd)
        for line in out.getvalue().replace("\r", "\n").splitlines():
            if line.strip():
                log(f"  [cli] {line.strip()}")
    if code != 0:
        raise AssertionError(f"train CLI exited {code}")
    (path,) = glob.glob(os.path.join(root, "checkpoints", name, "*"))
    return path


def read_rows(path: str):
    with open(path) as f:
        return list(csv.reader(f, delimiter="\t"))[1:]


def check_cli_outputs(save: str, label: str) -> list:
    """CLI_STEPS finite loss rows, and the reference-layout weight files
    load into fresh networks; returns the rows."""
    rows = read_rows(os.path.join(save, "progress_log_full.csv"))
    losses = [float(r[0]) for r in rows]
    if len(rows) != CLI_STEPS or not all(np.isfinite(float(v)) for r in rows for v in r):
        raise AssertionError(f"{label} progress_log_full.csv: {len(rows)} rows {rows}")
    log(f"[{label}] {len(rows)} finite loss rows, first {losses[0]:.5f} last {losses[-1]:.5f}")
    for prefix, net in (("dispnet", DispNet(18)), ("exp_pose", PoseNet(18))):
        for kind in ("checkpoint", "model_best"):
            net.load_state_dict(load_torch_state_dict(
                os.path.join(save, f"{prefix}_{kind}.pth.tar")))
    log(f"[{label}] dispnet/exp_pose checkpoint and model_best files load into fresh networks")
    return rows


def check_resume(root: str, save: str, name: str, seed: int, label: str) -> None:
    """A ``--resume`` epoch (without ``--fused-steps``) continues the step."""
    resumed = run_cli(root, name, seed, "--epochs", "1", "--resume", save)
    steps = [int(r[0]) for r in read_rows(os.path.join(resumed, train_cli.TIME_LOG))]
    if steps != list(range(CLI_STEPS + 1, CLI_STEPS + CLI_EPOCH_SIZE + 1)):
        raise AssertionError(f"{label}: resumed run's steps {steps}")
    log(f"[{label}] --resume without --fused-steps: steps {steps[0]}..{steps[-1]}")


def cli_times(save: str, prefix: str, skip: int) -> dict:
    """Step and data wait per optimizer step from the time log, after the
    first ``skip`` rows: the median, and the mean over the second epoch,
    whose rows add up to its wall time from its first batch to its
    metrics on the host."""
    timing = read_rows(os.path.join(save, train_cli.TIME_LOG))
    step_ms = [1e3 * float(r[2]) for r in timing]
    wait_ms = [1e3 * float(r[1]) for r in timing]
    return {f"{prefix}_first_step_ms": step_ms[0],
            f"{prefix}_step_ms_median_after_{skip}": float(np.median(step_ms[skip:])),
            f"{prefix}_step_ms_range_after_{skip}": [min(step_ms[skip:]), max(step_ms[skip:])],
            f"{prefix}_step_ms_mean_epoch_2": float(np.mean(step_ms[CLI_EPOCH_SIZE:])),
            f"{prefix}_data_wait_ms_median_after_{skip}": float(np.median(wait_ms[skip:])),
            f"{prefix}_data_wait_ms_mean_after_{skip}": float(np.mean(wait_ms[skip:]))}


def union_ms(intervals) -> float:
    """Total length of the union of ``(start_us, end_us)`` intervals, ms."""
    total, reach = 0.0, -np.inf
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def trace_summary(trace_dir: str) -> dict:
    """What a ``--profile-dir`` trace of one dispatch holds: the window, the
    device's kernels (by the port's kernels' names), busy time and share,
    and the host's launches."""
    (path,) = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    window_ms = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
    busy_ms = union_ms((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    ours = {}
    for e in kernels:
        name = next((n for n in ("warp_sample_bwd", "warp_sample", "ssim_bwd_kernel",
                                 "ssim_kernel") if n in e["name"]), None)
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


def cli_phase(seed: int, per_step: dict, per_validation: dict) -> dict:
    """The train CLI from disk: the eager run and, this slice's main path,
    the ``--fused-steps`` run; launches, logs, checkpoints, the restored
    state, resumed epochs, times and one profiled dispatch of each."""
    root = os.path.abspath(TRAINER_DIR)
    shutil.rmtree(root, ignore_errors=True)
    n_bytes = write_packed_dataset(root, seed)
    log(f"[cli] packed dataset {CLI_SCENES} at {W}x{H}: {n_bytes / 1e6:.1f} MB")
    val_samples = sum(n - N for name, n in CLI_SCENES if name.startswith("val"))
    val_batches = CLI_EPOCHS * min(CLI_VAL_BATCHES, -(-val_samples // B))
    want = {k: CLI_STEPS * per_step[k] + val_batches * per_validation[k] for k in WRAPPERS}

    zero_launches()
    save = run_cli(root, "smoke", seed)
    launches = read_launches()
    log(f"[cli] launches over {CLI_STEPS} train steps and {val_batches} validation batches: "
        f"{launches} (each train step launches {per_step})")
    if launches != want or min(per_step.values()) < 1:
        raise AssertionError(f"CLI launches {launches}, expected {want}")
    check_cli_outputs(save, "cli")

    # The saved train state, restored on the card into fresh networks.
    disp_net, pose_net = make_nets(seed + 7)
    disp_net.to(DEVICE)
    pose_net.to(DEVICE)
    state = restore_train_state(save, create_train_state(disp_net, pose_net))
    saved = torch.load(os.path.join(save, "train_state.pth.tar"), weights_only=True)
    moments = state.optimizer.state_dict()["state"]
    same = all(torch.equal(moments[i][k].cpu(), saved["optimizer"]["state"][i][k])
               for i in saved["optimizer"]["state"] for k in ("exp_avg", "exp_avg_sq"))
    if state.step != CLI_STEPS or not same or len(moments) < 100:
        raise AssertionError(f"restored step {state.step}, Adam moments equal: {same}")
    log(f"[cli] restored on the card: step {state.step}, Adam moments of {len(moments)} "
        "tensors equal to the saved ones")
    del state, disp_net, pose_net
    check_resume(root, save, "smoke_resume", seed, "cli")

    # The loader alone, as the CLI makes it (8 threads, pinned batches).
    loader = BatchLoader(PackedSequenceSet(os.path.join(root, "packed")), B, num_workers=8,
                         pin_memory=True)
    t = time.perf_counter()
    n_loaded = sum(1 for _ in loader)
    loader_ms = (time.perf_counter() - t) * 1e3 / n_loaded
    times = {**cli_times(save, "cli", 1), "loader_alone_ms_per_batch": loader_ms}
    log(f"[cli] times (host clock; the CLI syncs only at --print-freq and the epoch's end): "
        f"{times}")

    log(f"[cli-fused] the CLI with --fused-steps {CLI_FUSED_K}: one CUDA-graph replay of "
        f"{CLI_FUSED_K} steps per dispatch after a warm-up and a capture")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    fused = run_cli(root, "smoke_fused", seed, "--fused-steps", str(CLI_FUSED_K))
    fused_launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[cli-fused] launches over {CLI_STEPS} train steps ({CLI_STEPS // CLI_FUSED_K} "
        f"dispatches; replays counted) and {val_batches} validation batches: {fused_launches}")
    if fused_launches != want:
        raise AssertionError(f"fused CLI launches {fused_launches}, expected {want}")
    check_cli_outputs(fused, "cli-fused")
    check_resume(root, fused, "smoke_fused_resume", seed, "cli-fused")
    fused_times = {**cli_times(fused, "cli_fused", 2 * CLI_FUSED_K),
                   "cli_fused_peak_memory_gib": peak_gib}
    log(f"[cli-fused] times per optimizer step (host clock; a dispatch's K rows share its "
        f"time): {fused_times}")

    # One profiled dispatch of each, in runs of their own: the eager run's
    # second step, the fused run's third dispatch (after the warm-up and the
    # capture, so in its second epoch).
    for label, extra in (("eager", ("--epochs", "1", "--epoch-size", "3")),
                         ("fused", ("--fused-steps", str(CLI_FUSED_K)))):
        trace_dir = os.path.join(root, f"trace_{label}")
        run_cli(root, f"smoke_profile_{label}", seed, "--profile-dir", trace_dir, *extra)
        summary = trace_summary(trace_dir)
        log(f"[profile-dir] one {label} CLI dispatch: {summary}")
        if not summary["device_kernels"]:
            log(f"[profile-dir] the {label} trace holds no device kernel records")
    shutil.rmtree(root, ignore_errors=True)
    return {"train_cli": launches, "train_cli_fused": fused_launches}


def uint8_snippet(rng: np.random.RandomState) -> dict:
    return {"tgt": rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
            "refs": rng.randint(0, 256, (B, N, H, W, 3)).astype(np.uint8),
            "intrinsics": kitti_intrinsics(B)}


def augment_phase(seed: int, rng: np.random.RandomState) -> dict:
    """The augmentation on uint8 [4, 1+2, 256, 832, 3] on the card against
    the CPU with the same draws; its device time."""
    cfg = device_augment.AugmentConfig()
    augment = device_augment.make_device_augment(cfg)
    batch = uint8_snippet(rng)
    cpu = augment(device_augment.step_generator(seed, 0),
                  {k: torch.from_numpy(v) for k, v in batch.items()})
    on_card = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    card = augment(device_augment.step_generator(seed, 0), on_card)
    torch.cuda.synchronize()
    err = max(check_close(f"augment {k}", card[k].cpu(), cpu[k], AUG_TOL)
              for k in ("tgt", "refs"))
    check_rel("augment intrinsics", card["intrinsics"].cpu(), cpu["intrinsics"], AUG_TOL)
    # As in the step: the draws and the affine map are made on the CPU and
    # copied; the graph holds the device's share (resample, normalize).
    draws = device_augment.sample_draws(device_augment.step_generator(seed, 0), B, cfg)
    affine = device_augment._affine_on(DEVICE, draws, H, W)
    resample = lambda: device_augment._apply_affine(
        device_augment._to_unit_float(on_card), affine, cfg)
    times = {"augment_device_ms": graph_ms(resample, 20),
             "augment_call_ms": cuda_ms(lambda: augment(device_augment.step_generator(seed, 0),
                                                        on_card), 20)}
    log(f"[augment] uint8 [{B},{1 + N},{H},{W},3] on the card vs the CPU: max|err| {err:.3e}; "
        f"times (device_ms from a CUDA-graph replay of the resample and normalize at the "
        f"affine map the CPU made; call_ms "
        f"CUDA events around the whole call, the CPU draws and their copies included): "
        f"{times}")
    return times


def remat_phase(seed: int, rng: np.random.RandomState) -> None:
    """One fp32 ``remat`` step on the card against a plain step from the
    same state: losses and BatchNorm running statistics."""
    batch = make_batch(rng)
    nets = make_nets(seed + 3)
    twins = tuple(copy.deepcopy(n) for n in nets)
    plain = make_train_step(*nets, make_optimizer(*nets), device=DEVICE, precision="fp32")
    remat = make_train_step(*twins, make_optimizer(*twins), device=DEVICE, precision="fp32",
                            remat=True)
    got = {k: v.item() for k, v in remat(batch).items()}
    want = {k: v.item() for k, v in plain(batch).items()}
    for k in METRICS:
        rel = abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
        log(f"  remat fp32 {k}: {got[k]:.7f} plain {want[k]:.7f} rel {rel:.2e} "
            f"(tol {REMAT_LOSS_RTOL:.0e})")
        if not rel <= REMAT_LOSS_RTOL:
            raise AssertionError(f"remat {k}: {got[k]} vs plain {want[k]}")
    worst = 0.0
    for a, b in zip(nets, twins):
        for (name, x), (_, y) in zip(a.named_buffers(), b.named_buffers()):
            if name.endswith("num_batches_tracked"):
                if int(x) != 1 or int(y) != 1:
                    raise AssertionError(f"{name}: moved {int(y)} times under remat")
            else:
                worst = max(worst, (x - y).abs().max().item())
    log(f"  remat fp32 BatchNorm running statistics: max|err| {worst:.3e} "
        f"(tol {REMAT_STATS_TOL:.0e}), each moved once")
    if not worst <= REMAT_STATS_TOL:
        raise AssertionError(f"remat running statistics off by {worst}")


def staging_phase(seed: int, rng: np.random.RandomState) -> dict:
    """The CLI's step on a batch already on the card, and the host-to-card
    copy of one batch: pinned uint8 through ``device_prefetch`` against
    pageable fp32."""
    u8 = uint8_snippet(rng)
    disp_net, pose_net = make_nets(seed + 5)
    augment = device_augment.make_device_augment(device_augment.AugmentConfig())
    step = make_train_step(disp_net, pose_net, make_optimizer(disp_net, pose_net),
                           device=DEVICE, augment_fn=augment, aug_seed=seed)
    on_card = {k: torch.from_numpy(v).to(DEVICE) for k, v in u8.items()}
    times = {"cli_config_step_batch_on_card_ms": host_ms(lambda: step(on_card))}
    del step, disp_net, pose_net

    pinned = {k: torch.from_numpy(v).pin_memory() for k, v in u8.items()}
    f32 = {k: (v.astype(np.float32) / 255.0 if v.dtype == np.uint8 else v)
           for k, v in u8.items()}
    # The step thread's time per batch taken from a running device_prefetch.
    staged = device_prefetch((pinned for _ in range(STEP_ITERS + 3)), DEVICE)
    for _ in range(3):
        next(staged)
    taken = []
    for _ in range(STEP_ITERS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        next(staged)
        taken.append((time.perf_counter() - t) * 1e3)
    # The copy's own device time, on a side stream as device_prefetch makes it.
    side = torch.cuda.Stream()
    copies = []
    for _ in range(STEP_ITERS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            start.record()
            on_card = {k: v.to(DEVICE, non_blocking=True) for k, v in pinned.items()}
            end.record()
        end.synchronize()
        copies.append(start.elapsed_time(end))
    times.update({
        "prefetch_u8_pinned_host_ms": float(np.median(taken)),
        "u8_pinned_copy_device_ms": float(np.median(copies)),
        "pageable_f32_ms": host_ms(lambda: {k: torch.from_numpy(v).to(DEVICE)
                                            for k, v in f32.items()}),
        "u8_batch_mb": sum(v.nbytes for v in u8.values()) / 1e6,
        "f32_batch_mb": sum(v.nbytes for v in f32.values()) / 1e6})
    log(f"[staging] times (median of {STEP_ITERS}; prefetch_u8_pinned_host_ms: the step "
        f"thread's time to take a batch from a running device_prefetch, host clock; "
        f"u8_pinned_copy_device_ms: CUDA events around the pinned copy on a side stream; "
        f"pageable_f32_ms: host clock around the blocking copy of the same batch in fp32): "
        f"{times}")
    return times


def stacked_uint8(rng: np.random.RandomState, k: int) -> dict:
    """K uint8 snippets stacked on a leading axis, on the card."""
    arrays = {"tgt": rng.randint(0, 256, (k, B, H, W, 3)).astype(np.uint8),
              "refs": rng.randint(0, 256, (k, B, N, H, W, 3)).astype(np.uint8),
              "intrinsics": np.broadcast_to(kitti_intrinsics(B), (k, B, 3, 3)).copy()}
    return {name: torch.from_numpy(a).to(DEVICE) for name, a in arrays.items()}


def compare_nets(nets, ref_nets, start) -> dict:
    """``nets`` against ``ref_nets``, both trained from the parameters
    ``start``: the parameters' max|diff| and trajectory rel L2 (the
    disagreement's L2 norm over that of ``ref_nets``' update), the
    BatchNorm statistics' worst max|err|/max|ref|, and how many times the
    statistics moved."""
    diff_sq = upd_sq = max_diff = stats = 0.0
    params = [(p, q) for a, b in zip(nets, ref_nets) for p, q in zip(a.parameters(),
                                                                      b.parameters())]
    for (p, q), p0 in zip(params, start):
        max_diff = max(max_diff, (p - q).abs().max().item())
        diff_sq += (p - q).double().pow(2).sum().item()
        upd_sq += (q - p0).double().pow(2).sum().item()
    moved = set()
    for a, b in zip(nets, ref_nets):
        for (name, x), (_, y) in zip(a.named_buffers(), b.named_buffers()):
            if name.endswith("num_batches_tracked"):
                moved |= {int(x), int(y)}
            else:
                stats = max(stats, ((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item())
    return {"max_diff": max_diff, "trajectory": (diff_sq / upd_sq) ** 0.5, "stats": stats,
            "moved": sorted(moved)}


def copy_train_state(src, dst) -> None:
    """``src``'s (nets, optimizer) parameters, buffers and Adam state into
    ``dst``'s tensors, in place (the graph keeps reading its own)."""
    (src_nets, src_opt), (dst_nets, dst_opt) = src, dst
    with torch.no_grad():
        for a, b in zip(src_nets, dst_nets):
            for x, y in zip([*a.parameters(), *a.buffers()], [*b.parameters(), *b.buffers()]):
                y.copy_(x)
        for g, h in zip(src_opt.param_groups, dst_opt.param_groups):
            for p, q in zip(g["params"], h["params"]):
                for name, v in src_opt.state[p].items():
                    dst_opt.state[q][name].copy_(v)


def graph_check(seed: int, rng: np.random.RandomState, remat: bool):
    """fp32 K = GRAPH_K graphed steps through GRAPH_CALLS calls (warm-up,
    capture and replay, replay), each call against K eager steps on a deep
    copy of the same nets and optimizer put in the graph's state before the
    call, with the same uint8 batches and augmentation draws, beside
    NOISE_COPIES more eager copies that measure the eager step's own
    run-to-run noise. Returns the graphed step, a batch for it, and the
    failures."""
    nets = make_nets(seed)
    for net in nets:
        net.to(DEVICE)
    optimizer = make_optimizer(*nets, lr=LR, capturable=True)
    copies = [copy.deepcopy((nets, optimizer)) for _ in range(1 + NOISE_COPIES)]
    augment = device_augment.make_device_augment(device_augment.AugmentConfig())
    kw = {"device": DEVICE, "precision": "fp32", "remat": remat, "augment_fn": augment,
          "aug_seed": seed}
    graphed = make_train_step(*nets, optimizer, fused_steps=GRAPH_K, **kw)
    eager = [make_train_step(*pair, opt, **kw) for pair, opt in copies]
    failures = []
    for call in range(1, GRAPH_CALLS + 1):
        label = f"graphed {'remat ' if remat else ''}call {call}"
        if call > 1:  # the first call starts from the deep copies' own state
            for c in copies:
                copy_train_state((nets, optimizer), c)
        start = [p.detach().clone() for net in nets for p in net.parameters()]
        group = stacked_uint8(rng, GRAPH_K)
        metrics = graphed(group)
        got = [{k: metrics[k][i].item() for k in METRICS} for i in range(GRAPH_K)]
        runs = [[] for _ in eager]  # runs[0] is the reference, the rest the noise
        for i in range(GRAPH_K):
            batch = {name: v[i] for name, v in group.items()}
            for run, step in zip(runs, eager):
                run.append({k: v.item() for k, v in step(batch).items()})
        want = runs[0]
        # Each term's error relative to the step's total loss.
        err = lambda a, k: [abs(x[k] - w[k]) / abs(w["loss"]) for x, w in zip(a, want)]
        for k in METRICS:
            graph_err = err(got, k)
            noise_err = [max(e) for e in zip(*(err(run, k) for run in runs[1:]))]
            tol = max(GRAPH_LOSS_RTOL, NOISE_FACTOR * max(noise_err))
            log(f"  {label} fp32 {k}, error per step over the eager total loss: "
                f"{' '.join(f'{x:.1e}' for x in graph_err)}; largest of the eager copies "
                f"{' '.join(f'{x:.1e}' for x in noise_err)} (tol {tol:.1e})")
            if not (max(graph_err) <= tol and all(np.isfinite(g[k]) for g in got)):
                failures.append(f"{label} {k}: error {max(graph_err):.2e} > {tol:.2e}")
        log(f"  {label} losses: {[round(g['loss'], 6) for g in got]}")
        graph = compare_nets(nets, copies[0][0], start)
        noises = [compare_nets(c[0], copies[0][0], start) for c in copies[1:]]
        noise = {k: max(n[k] for n in noises) for k in ("trajectory", "stats")}
        bounds = {"max_diff": 2 * LR * GRAPH_K,
                  "trajectory": max(GRAPH_TRAJ_RTOL, NOISE_FACTOR * noise["trajectory"]),
                  "stats": max(GRAPH_STATS_RTOL, NOISE_FACTOR * noise["stats"])}
        log(f"  {label}, its {GRAPH_K} steps: {graph}; eager copies to eager: {noises}; "
            f"bounds {bounds}")
        failures += [f"{label} {k} {graph[k]:.3e} > {b:.3e}" for k, b in bounds.items()
                     if not graph[k] <= b]
        if graph["moved"] != [call * GRAPH_K]:
            failures.append(f"{label} BatchNorm statistics moved {graph['moved']} times")
    return graphed, group, failures


def graph_phase(seed: int, rng: np.random.RandomState, per_step: dict,
                eager_device_ms: float) -> dict:
    """The train step as CUDA-graph replays of K steps: fp32 against eager
    steps (plain and ``remat``), launches over replays, and bf16 K =
    CLI_FUSED_K's times and memory. Returns the replays' launches and the
    checks' failures."""
    graphed, group, failures = graph_check(seed + 11, rng, remat=False)
    zero_launches()
    for _ in range(2):
        graphed(group)
    launches = read_launches()
    want = {k: 2 * GRAPH_K * per_step[k] for k in WRAPPERS}
    log(f"[graph] launches over 2 replays of {GRAPH_K} steps: {launches} (expected {want})")
    if launches != want:
        failures.append(f"graphed launches {launches}, expected {want}")
    del graphed, group
    failures += graph_check(seed + 12, rng, remat=True)[2]
    torch.cuda.empty_cache()

    nets = make_nets(seed + 13)
    for net in nets:
        net.to(DEVICE)
    step = make_train_step(*nets, make_optimizer(*nets, lr=LR, capturable=True), device=DEVICE,
                           augment_fn=device_augment.make_device_augment(
                               device_augment.AugmentConfig()),
                           aug_seed=seed, fused_steps=CLI_FUSED_K)
    group = stacked_uint8(rng, CLI_FUSED_K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls = []
    for _ in range(2):  # the warm-up, then the capture and its first replay
        t = time.perf_counter()
        losses = step(group)["loss"].tolist()
        calls.append((time.perf_counter() - t) * 1e3)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"bf16 graphed losses {losses}")
    times = {"warmup_call_ms": calls[0], "capture_call_ms": calls[1],
             "graph_device_ms_per_step": cuda_ms(lambda: step(group), 4, warmup=1)
             / CLI_FUSED_K,
             "graph_call_host_ms_per_step": host_ms(lambda: step(group), 5) / CLI_FUSED_K,
             "eager_step_device_ms": eager_device_ms,
             "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"[graph] bf16 K={CLI_FUSED_K} (device augmentation on uint8): {times} "
        "(device ms: CUDA events around back-to-back calls, each a replay and its input "
        "copies; host ms: host clock around a call that ends in synchronize; the eager "
        "step's device time is the train phase's graph of one step, without augmentation)")
    del step, nets
    torch.cuda.empty_cache()
    return launches, failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="also print the eval and train steps' device time by kernel "
                        "(torch.profiler)")
    p.add_argument("--graph-seeds", type=int, default=0,
                   help="also repeat the fp32 graph-against-eager check, without and with "
                        "remat, from this many more seeds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    smi = device_phase()
    build_phase()
    rng = np.random.RandomState(args.seed)
    log("[kernels] against their plain versions at the main path's shapes")
    inputs = warp_inputs(rng)
    kernels = [warp_phase(inputs), warp_bwd_phase(inputs, rng), ssim_phase(rng),
               ssim_bwd_phase(rng)]
    del inputs
    by_path = slice_phase(args.seed, rng, args.profile)
    by_path["train_step"], step_device_ms = train_phase(args.seed, rng, args.profile)
    log("[augment] the device augmentation on the card against the CPU")
    augment_phase(args.seed, rng)
    log("[remat] an fp32 remat step on the card against a plain step")
    remat_phase(args.seed, rng)
    log("[graph] the train step as CUDA-graph replays of K steps against eager steps")
    # The graph checks' failures fail the run after the phases that follow.
    by_path["train_step_graphed"], failures = graph_phase(args.seed, rng, by_path["train_step"],
                                                          step_device_ms)
    for s in range(args.graph_seeds):
        for remat in (False, True):
            found = graph_check(args.seed + 100 + s, rng, remat)[2]
            log(f"[graph] seed {args.seed + 100 + s}, remat {remat}: failures {found}")
            failures += found
        torch.cuda.empty_cache()
    log("[cli] the train CLI from a packed dataset on disk, eager and with --fused-steps")
    by_path.update(cli_phase(args.seed, by_path["train_step"], by_path["validation_step"]))
    staging_phase(args.seed, rng)
    for k in kernels:
        k["launches"] = by_path["train_cli_fused"][k["name"]]
        k["launches_per_train_step"] = by_path["train_step"][k["name"]]
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in by_path.items()}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if failures:
        raise AssertionError(f"graph checks failed: {failures}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
