#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--profile] [--graph-seeds N]
                          [--cpu-check-seeds N]

``--profile`` adds the validation and train steps' device time by kernel
group (torch.profiler); ``--graph-seeds N`` repeats phase 7's fp32
graph-against-eager check from N more seeds; ``--cpu-check-seeds N``
repeats phase 5's fp32 card-against-CPU train check from N more draws and
reports each gate's worst value and crossings (which fail the run).
Phases, each of which fails the run (non-zero exit) when it fails:

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
   against its own plain version, with each launch's geometry). Also at
   the width-sharded path's shapes (``--spatial-shards 2``): the warp with
   shard 1's coordinates, W/2 wide, into the source gathered to full
   width, and SSIM on a [16, 3, 256, 417] tile (its backward held against
   its plain version; against autograd only reported, beside a float64
   autograd: see ``SSIM_SHARD_SHAPE``). Kernel,
   plain and library or stream times. ``ms`` is CUDA events around
   back-to-back wrapper calls; ``device_ms`` is the kernel's own device time
   per call (torch.profiler, or a CUDA graph of the calls replayed under
   CUDA events where the profiler records none). Then ManyDepth's cost
   volume (``--cost-volume-only`` stops after it), and the decoder-input
   kernel (``decoder_input_phase``; ``--decoder-input-only`` runs only the
   build and it): every ``DepthDecoder`` input of the cells' shapes against
   the plain composition, bf16 and fp32, its time beside its bytes bound,
   and on width shards cut from whole images (two and four shards), each
   shard's output against its columns of the whole image's. Its launches
   are counted with the other kernels' on every path below (14 forwards
   for each DispNet forward, 14 backwards for each backward), and so are
   the cost volume's (``ops.KERNEL_WRAPPERS``): 0 on every SC-Depth path,
   so "every kernel" below means every kernel but the cost volume.
4. Slices 1-2's paths at full width: ResNet-18 DispNet and PoseNet from a
   seeded ``torch.Generator``, depth inference on [4, 256, 832, 3] and the
   photometric validation step on a B=4, N=2 snippet at 832x256, each with
   the launch counts at 0 just before it; the fp32 validation step against
   the CPU; times.
5. The main path, the train step at full width (B=4, N=2, 832x256, bf16
   convolutions, Adam): one step with the launch counts at 0, in which every
   kernel must launch; then 8 more steps with finite losses; median
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
9. This slice's main path, evaluation on the card (``[eval]``): PNGs
   written from ``--seed`` with ``write_png`` in all five row filters (16
   KITTI-raw frames at 1242x375 with sparse ground truth, a 60-frame
   KITTI-odometry sequence 09 at 1241x376 with poses at 2 m per frame) and
   the seeded networks as ``.pth.tar``; then ``test_disp`` (bf16, batch 8),
   ``eval_depth``, ``run_inference`` (4 frames), ``test_vo`` (batch 16),
   ``eval_odom`` (``--align 7dof``) and ``test_pose`` through their
   ``main``, at 832x256, each with the launch counts at 0 just before it
   (the losses' kernels and the backwards must stay at 0; the
   decoder-input kernel runs 14 times a DispNet forward on the card).
   Checked: ``test_disp``'s fp32 depth
   on the card against the CPU (4 frames) and ``test_vo``'s fp32
   trajectory (9 frames); ``eval_odom`` of the ground truth against
   itself; every output file and every printed metric. Printed: bf16
   against fp32, ``Avg Time``/fps, the CLI's wall time per frame,
   ``read_png`` ms by row filter, pairs/s, snippets/s, memory.
10. This slice's main path, data preparation (``[prepare]``): raw trees
   written from ``--seed`` at the datasets' sizes (KITTI raw from
   ``tools/make_smoke_kitti.py::make_kitti_raw``: two drives, cameras 02
   and 03, 24 frames each at 1242x375 in all five PNG row filters,
   KITTI's calibration, OXTS with a still stretch, 120,000-point velodyne
   scans, and an Eigen test drive; a KITTI-odometry sequence at 1241x376
   with ``calib.txt``; a Cityscapes city at 2048x1024 with camera and
   vehicle JSON); ``python -m sc_sfmlearner_release_tpu_torch.
   prepare_train_data`` on each at ``scripts/run_prepare_data.sh``'s
   flags (8 spawn workers, resizes on the card), its JPEGs built by the
   port's own codec (``csrc/jpeg_io.cpp``, g++). Checked: the test drive
   left out and the listed static frames dropped; the KITTI dump against a
   ``--device cpu`` run in this process (depth ``.npy`` equal, ``cam.txt``,
   ``poses.txt`` and the split equal as text, JPEG bytes, the card's uint8
   resize within one grey level of the CPU's); every format's written
   JPEGs, decoded, against the frames they encode; the packer's frames
   equal the decoded JPEGs bit for bit; a 16-bit NYU depth PNG through
   ``ValidationSet``; then the train CLI from the JPEG tree (no
   ``--packed``; ``--with-gt`` validation on the velodyne depth) for 2
   epochs of 10 steps with the launch counts at 0 (every kernel in every
   step; the decoder-input kernel also in the depth validation).
   Printed: the codec's route, ETL ms per frame by stage and
   per format, the workers' start-up and memory, decode ms per 832x256
   JPEG one at a time and batched, the JPEG tree's CLI step and data wait
   against the packed CLI of phase 6.
11. This slice's main path, the JAX package's checkpoints
   (``[checkpoints]``): seeded full-width nets after 3 bf16 Adam steps
   written as ``.msgpack`` (``save_jax_checkpoint``) and as ``.pth.tar``;
   ``test_disp`` and ``test_vo`` on phase 9's frames from either file
   (depths and trajectories bit-equal); ``restore_train_state`` from
   either directory into fresh nets on the card (parameters, BatchNorm
   statistics, Adam moments and steps bit-equal); the train CLI with
   ``--resume`` of the JAX directory on phase 6's packed dataset for one
   epoch of 10 steps, eager and with ``--fused-steps 5``, each with the
   launch counts at 0 (every kernel in every step, steps 4-13, finite
   losses); ``convert_checkpoint`` from ``.pth.tar`` to ``.msgpack`` and
   back bit-equal; write and read times, sizes and the host memory of a
   restore.
12. This slice's tools (``[tools]``), each with the launch counts at 0:
   ``synthetic_scene`` writes 24+8 frames and the train CLI trains from
   that JPEG tree for 10 steps with ``--with-gt`` validation on its
   ``.npy`` depth (every kernel in every step); ``overfit_check`` at its
   defaults must pass; ``mfu_report`` at B4, K = 5; ``profile_step`` at
   K = 5, whose device window per step (its kernel groups plus the idle
   time between the replays' records) must be within 10% of phase 7's
   graph device time; ``ablate_step`` on ``full``, ``no_ssim`` and
   ``convs_only``.
13. This slice's main path, data parallelism over processes
   (``[distributed]``, run after phase 8): (1) the train CLI with
   ``--distributed`` at world size 1 under NCCL, called in this process
   with torchrun's environment set, on phase 6's packed dataset (written
   again from ``--seed``) for 2 epochs of 10 steps, eager and with
   ``--fused-steps 5``, each with the launch counts at 0 (every kernel in
   every step), one experiment directory each, and its first step's
   losses against phase 6's first step. Then, in a world-size-1 NCCL group
   of this process: ``BatchNorm2d``'s global path (PyTorch's SyncBatchNorm
   kernels) against ``F.batch_norm``
   at the encoder's first and last BatchNorm shapes, both memory formats:
   output, input, weight and bias gradients, running statistics; the
   step's device time in the group (a CUDA-graph replay)
   and the gradient all-reduce's alone. (2) Two ranks
   (``distributed.run_processes``): NCCL with one card each where there
   are 2 or more cards, else gloo on CUDA tensors with both ranks on card
   0 (NCCL refuses two ranks on one device); the fp32 step (TF32 off) at
   B2 N2 128x416, one sample per rank, against one process on the global
   batch here: losses, every gradient and every BatchNorm statistic; both
   ranks' parameters bit-identical after the step; over NCCL also
   ``fused_steps=2`` (the all-reduces captured in the CUDA graph) for 3
   calls. (3) ``graft_entry.dryrun_data_parallel`` over the machine's
   cards (two ranks sharing the card where there is one). (4) The phase's wall time.
14. This slice's main path, width sharding (``[spatial]``, after
   ``[distributed]``): two ranks each holding one column half of every
   image (``distributed.run_processes(..., spatial_shards=2)``: NCCL with a
   card each on two or more cards, else gloo with both on card 0). (1) The
   fp32 step (TF32 off) at B2 N2 832x256 against one process on the
   global batch on this card: losses, every gradient, every BatchNorm
   statistic, both ranks' parameters bit-identical (the fp32 check's
   128x416 cannot split: 13 columns at the deepest level). (2) The bf16
   canonical step at B4 N2 832x256: its first step's losses against one
   process, each rank's peak device memory against the one process's
   (at most 0.75 of it), the step's time and the spatial collectives it
   calls. Both with the launch counts at 0 (every kernel once per step
   and rank). (3) The train CLI with ``--distributed --spatial-shards 2``
   under torchrun's environment (``run_processes(..., join=False)``: the
   CLI joins the group) on phase 6's packed dataset for one epoch of 4
   steps and a validation batch, launches per rank; with two or more
   cards again with ``--fused-steps 2``. (4) ``graft_entry.
   dryrun_data_spatial`` (data x spatial-2 over the cards, two ranks
   sharing the one card where there is one). (5) The phase's wall time.
15. The port's parity runbooks (``[scripts]``, after ``[tools]``):
   ``sc_sfmlearner_release_tpu_torch/scripts/kitti_parity_runbook.sh`` and
   ``nyu_parity_runbook.sh`` side by side with ``SMOKE=1 DEVICE=cuda`` (prepare, pack,
   train, ``test_disp``, ``eval_depth``, ``test_vo``, ``eval_odom``; NYU:
   train, ``test_disp``, ``eval_depth``), every ``python -m`` step through
   a shim that runs it under ``chip_smoke.py --count-launches`` (the
   launches of all their processes summed); the runbooks stop at a
   failing step, so their exit codes gate every step. Checked:
   ``predictions.npy`` finite with the frame count, ``eval_depth``'s
   printed metrics finite, the VO trajectory one pose per frame,
   ``eval_odom``'s errors finite; each step's wall time.
16. This slice's main path, the other published training configurations
   (``[configs]``, after ``[scripts]``), each train CLI with the flags of
   its script in ``sc_sfmlearner_release_tpu_torch/scripts/`` (read by
   ``config_argv``: only TRAIN_SET, the ImageNet weights directory,
   ``--epochs``, ``--epoch-size`` and ``--name`` overridden; seeded random
   ``resnet50.pth``/``resnet18.pth`` for ``--with-pretrain 1``), every path
   with the launch counts at 0 just before it. (1) The four kernels at
   ``train_nyu.sh``'s B16 N1 256x320 shapes against their plain versions
   (``nyu_kernels_phase``), their times and bounds. (2)
   ``train_resnet50_depth_256.sh`` (DispNet-50, B4 N2 832x256, auto-mask):
   the fp32 card step against the CPU at B2 N2 128x416 (``GRAD_RTOL_R50``);
   the bf16 eager step (every kernel once, finite losses, host and device
   ms, peak memory); the K = 16 graph with augmentation (device ms per
   step, peak memory, launches, MFU from ``mfu_report.flop_model``); the
   fp32 K = 3 graph against eager steps at ResNet-50; the CLI on a JPEG tree
   at 832x256 with ``.npy`` ground truth, 2 epochs of 32 steps (two
   ``--fused-steps 16`` dispatches each: the warm-up and the capture, then
   two replays) and a ``--resume`` epoch of 16; then
   ``test_disp --resnet-layers 50`` on ``[eval]``'s depth frames and
   ``eval_depth`` (``test_kitti_depth.sh``). (3)
   ``train_resnet50_pose_256.sh``: the CLI for 4 eager steps on an
   odometry-layout tree, then ``test_pose``, ``test_vo`` and ``eval_odom``
   on ``[eval]``'s sequence 09 from its PoseNet
   (``test_kitti_pose.sh``, ``test_kitti_vo.sh``). (4) ``train_nyu.sh``
   (DispNet-18, pair folders): the fp32 card step against the CPU at B2 N1
   128x160 (``GRAD_RTOL_NYU``); the bf16 step at B16 N1 256x320 (device ms,
   peak memory, MFU); the CLI on ``tools/make_smoke_nyu.py``'s tree at
   256x320 (40 pairs a scene) for 2 epochs with ``--with-gt`` validation on
   its 16-bit depth PNGs; ``test_nyu.sh``'s ``test_disp`` and ``eval_depth
   --dataset nyu`` on its test split.
17. Output: a ``{"kernels": [...]}`` line (``launches``: the
   ``train_resnet50_depth_256.sh`` CLI run's of phase 16, with every
   path's in ``launches_by_path``, and the kernels' numbers at NYU's shapes
   under ``nyu_b16``), the nvidia-smi line, and last ``{"ok": true,
   "device": {...}}``.

Without a card it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import ctypes
import faulthandler
import glob
import hashlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from sc_sfmlearner_release_tpu_torch import (
    disable_tf32, eval_depth, eval_odom, prepare_train_data, run_inference, test_disp, test_pose,
    test_vo,
)
from sc_sfmlearner_release_tpu_torch import graft_entry
from sc_sfmlearner_release_tpu_torch import train as train_cli
from sc_sfmlearner_release_tpu_torch.data import (
    BatchLoader, PackedSequenceSet, ValidationSet, device_augment, jpeg_io,
)
from sc_sfmlearner_release_tpu_torch.data import packed as packed_module
from sc_sfmlearner_release_tpu_torch.data.image_io import FILTERS, read_png, write_png
from sc_sfmlearner_release_tpu_torch.data.prepare.common import imresize
from sc_sfmlearner_release_tpu_torch.models import DispNet, PoseNet
from sc_sfmlearner_release_tpu_torch.models.resnet import BatchNorm2d, ResNet
from sc_sfmlearner_release_tpu_torch.models.convert import (
    load_torch_state_dict, save_torch_checkpoint,
)
from sc_sfmlearner_release_tpu_torch.ops import KERNEL_WRAPPERS, _build
from sc_sfmlearner_release_tpu_torch.ops.geometry import project_pixel_coords
from sc_sfmlearner_release_tpu_torch.ops.ssim import (
    ssim_nchw, ssim_nchw_bwd, ssim_nchw_bwd_plain, ssim_nchw_plain,
)
from sc_sfmlearner_release_tpu_torch.ops.warp import (
    warp_sample, warp_sample_bwd, warp_sample_plain,
)
from sc_sfmlearner_release_tpu_torch.parallel import device_prefetch, distributed
from sc_sfmlearner_release_tpu_torch.inference import restore_disp_state
from sc_sfmlearner_release_tpu_torch.tools import (
    ablate_step, convert_checkpoint, make_smoke_kitti, make_smoke_nyu, mfu_report, overfit_check,
    profile_step, synthetic_scene,
)
from sc_sfmlearner_release_tpu_torch.tools.profile_step import profile_phase, trace_summary
from sc_sfmlearner_release_tpu_torch.training import (
    LossConfig, create_train_state, make_eval_step, make_inference_fn, make_optimizer,
    make_train_step,
)
from sc_sfmlearner_release_tpu_torch.training.checkpoint import (
    restore_train_state, save_checkpoint, save_jax_checkpoint,
)
from sc_sfmlearner_release_tpu_torch.utils.profiling import card_line

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


def warp_fwd_bound(pixels: int):
    """The warp forward's bound: read coords and the 4-channel source, write
    4 channels, once each."""
    return bound(pixels * (2 * 4 + 4 * 4 + 4 * 4), pixels * (30 + 4 * 7))


def warp_bwd_bound(pixels: int):
    """The warp backward's: read dout, coords and the source once; write
    d(coords) and d(depth) once."""
    return bound(pixels * (4 * 4 + 8 + 4 * 4 + 8 + 4), pixels * (30 + 4 * 8 + 20 + 4 * 2))


def ssim_fwd_bound(n: int):
    """SSIM forward over ``n`` values: read x and y, write the map."""
    return bound(3 * n * 4, n * (9 * 8 + 20))


def ssim_bwd_bound(n: int):
    """SSIM backward (d/dy): read x, y and g, write d/dy."""
    return bound(4 * n * 4, n * (9 * 8 + 60 + 3 * 18 + 6))


def kitti_intrinsics(b: int) -> np.ndarray:
    """KITTI's camera scaled from 1242x375 to 832x256."""
    k = np.array([[718.856 * W / 1242, 0.0, 607.193 * W / 1242],
                  [0.0, 718.856 * H / 375, 185.216 * H / 375],
                  [0.0, 0.0, 1.0]], np.float32)
    return np.broadcast_to(k, (b, 3, 3)).copy()


def device_phase() -> str:
    smi = card_line()
    disable_tf32()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def build_phase() -> None:
    names = ("warp_sample", "ssim", "ssim_bwd", "cost_volume", "decoder_input")
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


# ManyDepth's cost volume at the cell's shapes: B12, 64 channels at 48x160
# (640x192 / 4), 96 bins between the trackers' start.
COST_VOLUME_SHAPE = (12, 64, 48, 160)
COST_VOLUME_BINS = (0.1, 10.0, 96)
# max|err| / max|plain| of the volume where both are confident, and the share
# of pixels whose lowest-cost bin or confidence may differ: the plain loop's
# coordinates come from cuBLAS and grid_sample with fused multiply-adds, the
# kernel's without, an ulp apart (3.5e-5 and 2.1e-3 read on an H100 at
# these inputs, whose shifted features leave many near ties between bins).
COST_VOLUME_TOL = 2e-4
COST_VOLUME_FLIPS = 1e-2


def cost_volume_inputs(rng: np.random.RandomState) -> dict:
    """Current features, lookup features (the current ones shifted by 3
    columns, plus noise), quarter-resolution KITTI intrinsics and poses:
    sample 0 with the zero pose (an empty volume), sample 1 with the
    identity (a static camera), the rest moving forward and turning a
    little."""
    b, c, h, w = COST_VOLUME_SHAPE
    cur = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32))
    cur = torch.nn.functional.avg_pool2d(cur, 3, 1, 1)
    lookup = torch.roll(cur, 3, dims=3) + 0.05 * torch.from_numpy(
        rng.standard_normal((b, c, h, w)).astype(np.float32))
    k = torch.tensor([[0.58 * w, 0.0, 0.5 * w], [0.0, 1.92 * h, 0.5 * h], [0.0, 0.0, 1.0]])
    k = k.expand(b, 3, 3).clone()
    poses = torch.eye(4).repeat(b, 1, 1)
    angles = rng.uniform(-0.02, 0.02, (b,))
    for i in range(2, b):
        ca, sa = np.cos(angles[i]), np.sin(angles[i])
        poses[i, :3, :3] = torch.tensor([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]],
                                        dtype=torch.float32)
        poses[i, :3, 3] = torch.tensor([rng.uniform(-0.05, 0.05), 0.0,
                                        rng.uniform(-0.6, -0.2)], dtype=torch.float32)
    poses[0] = 0.0
    dev = torch.device("cuda")
    lo, hi, n = COST_VOLUME_BINS
    return {"cur": cur.to(dev), "lookup": lookup.to(dev),
            "proj": (k @ poses[:, :3]).contiguous().to(dev),
            "inv_k": torch.linalg.inv(k).contiguous().to(dev),
            "bins": torch.linspace(lo, hi, n).to(dev)}


def cost_volume_phase(rng: np.random.RandomState) -> dict:
    """The cost-volume kernel against its plain version (the public code's
    per-sample ``F.grid_sample`` loop, on the card) at the cell's shapes:
    the volume where both are confident, and the pixels whose confidence
    or lowest-cost bin differ (near ties of the channel sum's order); the
    kernel's device time, its share of its bytes bound and the plain
    loop's time."""
    from sc_sfmlearner_release_tpu_torch.ops.cost_volume import cost_volume, cost_volume_plain

    x = cost_volume_inputs(rng)
    args = (x["cur"], x["lookup"], x["proj"], x["inv_k"], x["bins"])
    got = cost_volume(*args)
    with torch.no_grad():
        want = cost_volume_plain(*args)
    both = (got[2] * want[2]).bool()
    conf_flips = (got[2] != want[2]).float().mean().item()
    arg_flips = (got[1] != want[1]).float().mean().item()
    scale = want[0].abs().max().item()
    err = ((got[0] - want[0]).abs() * both[:, None]).max().item() / max(scale, 1e-30)
    empty = got[2][0].sum().item()
    log(f"  cost_volume: volume max|err|/max|plain| {err:.3e} (tol {COST_VOLUME_TOL:.0e}); "
        f"confidence flips {conf_flips:.2e}, lowest-cost flips {arg_flips:.2e} (tol "
        f"{COST_VOLUME_FLIPS:.0e}); confident {want[2].mean().item():.4f}; sample 0 (zero pose) "
        f"confident pixels {empty:.0f}")
    if not (err <= COST_VOLUME_TOL and conf_flips <= COST_VOLUME_FLIPS
            and arg_flips <= COST_VOLUME_FLIPS and empty == 0):
        raise AssertionError("cost_volume disagrees with its plain version")
    b, c, h, w = COST_VOLUME_SHAPE
    d = COST_VOLUME_BINS[2]
    n_bytes = 4 * b * h * w * (2 * c + d + 2)
    kernel_ms, how = device_ms(lambda: cost_volume(*args), "cost_volume_kernel")
    wrapper_ms = cuda_ms(lambda: cost_volume(*args), KERNEL_ITERS)
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: cost_volume_plain(*args), 3, warmup=1)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  cost_volume: {kernel_ms:.4f} ms on the device ({how}), {wrapper_ms:.4f} ms a "
        f"wrapper call, bound {bound_ms:.4f} ms ({100 * bound_ms / kernel_ms:.2f}% of it); "
        f"the public per-sample loop {plain_ms:.3f} ms")
    return {"name": "cost_volume", "ms": wrapper_ms, "device_ms": kernel_ms,
            "bound_ms": bound_ms, "bound_share": bound_ms / kernel_ms, "plain_ms": plain_ms,
            "max_rel_err": err, "confidence_flips": conf_flips, "lowest_cost_flips": arg_flips}


# DepthDecoder's 14 convolution inputs (ops/decoder_input.py) at the cells'
# shapes: 12 images through DispNet-18 and DispNet-50 at 832x256 (B4 N2),
# and ManyDepth's B12 at 640x192 (ResNet-18 decoders).
DECODER_CELLS = (("r18", 18, 12, 256, 832), ("r50", 50, 12, 256, 832),
                 ("manydepth", 18, 12, 192, 640))
# The gradients' max|err| / max|plain|. bf16: the kernel sums a source
# pixel's padded positions and its 2x2 block in fp32 and rounds once; the
# composition rounds the pad's sum to bf16 and then the upsample's sum, or,
# on a bf16 source at scale 1, rounds after each of up to 3 atomic adds, so
# the two differ by up to 2 bf16 units in the last place of the element:
# 2 * 2^-7 of it at most, of max|plain| at most. fp32: only the order of the
# sums differs (the pad's atomics), a few fp32 units in the last place.
DECODER_GRAD_TOL = {torch.bfloat16: 2.0**-6, torch.float32: 1e-5}
DECODER_ITERS = 20  # calls per CUDA graph timed
# The decoder-input kernel's launches in one DepthDecoder forward.
DECODER_INPUTS = 14
# Width shards of DispNet-18's decoder inputs, cut from whole images in one
# process: (label, n, h, w, shards). 832x256 in two shards, and 128x64 in
# four, whose deepest maps are one column a shard.
DECODER_SHARDS = (("r18_832x256", 2, 256, 832, 2), ("r18_128x64", 2, 64, 128, 4))


def decoder_sites(layers: int, n: int, h: int, w: int) -> list:
    """``(name, source shape or None, skip shape or None, scale)`` of each
    of DepthDecoder's 14 inputs, in its order of calls."""
    from sc_sfmlearner_release_tpu_torch.models.disp_net import DEC_CHANNELS
    from sc_sfmlearner_release_tpu_torch.models.resnet import encoder_channels

    enc, dec = encoder_channels(layers), DEC_CHANNELS
    at = lambda c, level: (n, c, h >> level, w >> level)
    sites = [("upconv_4_0", None, at(enc[4], 5), 1)]
    for i in range(4, -1, -1):
        if i < 4:
            sites.append((f"upconv_{i}_0", at(dec[i + 1], i + 1), None, 1))
        sites.append((f"iconv_{i}_1", at(dec[i], i + 1), at(enc[i - 1], i) if i else None, 2))
        if i < 4:
            sites.append((f"dispconv_{i}", at(dec[i], i), None, 1))
    return sites


def decoder_site_bytes(src, skip, scale: int, dtype) -> int:
    """One site's bytes, forward or backward alike: the source (``dtype``)
    and the fp32 skip read once and the padded input (``dtype``) written
    once; the backward reads the padded input's gradient and writes the
    other two."""
    item = torch.tensor([], dtype=dtype).element_size()
    n, _, hh, ww = skip if skip else (src[0], 0, src[2] * scale, src[3] * scale)
    c = (src[1] if src else 0) + (skip[1] if skip else 0)
    src_b = math.prod(src) * item if src else 0
    skip_b = math.prod(skip) * 4 if skip else 0
    return src_b + skip_b + n * c * (hh + 2) * (ww + 2) * item


def decoder_input_phase(rng: np.random.RandomState) -> dict:
    """The decoder-input kernel against its plain version at every decoder
    shape of the cells, bf16 (autocast) and fp32: the forward bit for bit
    and channels-last, the gradients within ``DECODER_GRAD_TOL``; each
    site's forward and backward device time (a CUDA graph of the calls)
    beside its bytes bound, summed per decoder pass; the plain composition's
    time; the kernels' names in the profiler; and the kernel on width
    shards (``decoder_shard_check``)."""
    from torch.profiler import ProfilerActivity, profile

    from sc_sfmlearner_release_tpu_torch.ops import decoder_input as di

    dev = torch.device(DEVICE)
    report, worst = {}, {torch.bfloat16: 0.0, torch.float32: 0.0}
    for cell, layers, n, h, w in DECODER_CELLS:
        totals = {"fwd_ms": 0.0, "bwd_ms": 0.0, "fwd_bound_ms": 0.0, "bwd_bound_ms": 0.0,
                  "plain_ms": 0.0}
        for name, src_shape, skip_shape, scale in decoder_sites(layers, n, h, w):
            for dtype in (torch.bfloat16, torch.float32):
                src = (torch.from_numpy(rng.standard_normal(src_shape).astype(np.float32))
                       .to(dev, dtype).contiguous(memory_format=torch.channels_last)
                       if src_shape else None)
                skip = (torch.from_numpy(rng.standard_normal(skip_shape).astype(np.float32))
                        .to(dev) if skip_shape else None)
                leaves = [t.requires_grad_(True) for t in (src, skip) if t is not None]
                plain_leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
                plain_src = plain_leaves[0] if src is not None else None
                plain_skip = plain_leaves[-1] if skip is not None else None
                amp = (torch.autocast("cuda", dtype=torch.bfloat16) if dtype == torch.bfloat16
                       else contextlib.nullcontext())
                with amp:
                    got = di.decoder_input(src, skip, scale)
                want = di.decoder_input_plain(plain_src, plain_skip, scale).to(dtype)
                label = f"decoder_input {cell} {name} {str(dtype)[6:]}"
                if not (got.dtype == dtype and got.shape == want.shape
                        and got.is_contiguous(memory_format=torch.channels_last)
                        and torch.equal(got, want)):
                    raise AssertionError(f"{label}: forward differs from the plain version "
                                         f"({got.dtype}, {tuple(got.shape)})")
                g = torch.randn(want.shape, device=dev, dtype=dtype).contiguous(
                    memory_format=torch.channels_last)
                grads = torch.autograd.grad(got, leaves, g)
                plain_grads = torch.autograd.grad(want, plain_leaves, g)
                for which, a, b in zip(("src", "skip") if src is not None else ("skip",),
                                       grads, plain_grads):
                    scale_ref = b.float().abs().max().item()
                    err = (a.float() - b.float()).abs().max().item() / max(scale_ref, 1e-30)
                    worst[dtype] = max(worst[dtype], err)
                    if not (err <= DECODER_GRAD_TOL[dtype] and a.dtype == b.dtype
                            and torch.isfinite(a).all().item()):
                        raise AssertionError(f"{label} d/d{which}: max|err|/max|ref| {err:.3e} "
                                             f"> {DECODER_GRAD_TOL[dtype]:.3g}")
                if dtype != torch.bfloat16:
                    continue
                s = di._Shape(src.detach() if src is not None else None,
                              skip.detach() if skip is not None else None, scale, dtype)
                xs = src.detach() if src is not None else None
                ks = skip.detach() if skip is not None else None
                fwd_ms = graph_ms(lambda: di._launch_fwd(xs, ks, s), DECODER_ITERS)
                bwd_ms = graph_ms(lambda: di.decoder_input_bwd(g, s, xs is not None,
                                                               ks is not None), DECODER_ITERS)

                def plain_pass():
                    with torch.autocast("cuda", dtype=torch.bfloat16):
                        out = di.decoder_input_plain(plain_src, plain_skip, scale).to(dtype)
                    torch.autograd.grad(out, plain_leaves, g)

                plain_ms = cuda_ms(plain_pass, 5, warmup=1)
                fwd_b = bwd_b = decoder_site_bytes(src_shape, skip_shape, scale, dtype)
                totals["fwd_ms"] += fwd_ms
                totals["bwd_ms"] += bwd_ms
                totals["fwd_bound_ms"] += fwd_b / HBM_BYTES_PER_S * 1e3
                totals["bwd_bound_ms"] += bwd_b / HBM_BYTES_PER_S * 1e3
                totals["plain_ms"] += plain_ms
                fwd_share = 100 * fwd_b / HBM_BYTES_PER_S * 1e3 / fwd_ms
                log(f"  {label}: fwd {fwd_ms:.4f} ms ({fwd_share:.0f}"
                    f"% of {fwd_b / 1e6:.1f} MB), bwd {bwd_ms:.4f} ms "
                    f"({100 * bwd_b / HBM_BYTES_PER_S * 1e3 / bwd_ms:.0f}%), plain fwd+bwd "
                    f"{plain_ms:.4f} ms")
            torch.cuda.empty_cache()
        totals["share"] = ((totals["fwd_bound_ms"] + totals["bwd_bound_ms"])
                           / (totals["fwd_ms"] + totals["bwd_ms"]))
        log(f"  decoder_input {cell}: one decoder pass (14 sites, bf16) {json.dumps(totals)}")
        report[cell] = totals
    log(f"  decoder_input: forwards bit for bit; worst gradient max|err|/max|ref| bf16 "
        f"{worst[torch.bfloat16]:.3e} (tol {DECODER_GRAD_TOL[torch.bfloat16]:.3g}), fp32 "
        f"{worst[torch.float32]:.3e} (tol {DECODER_GRAD_TOL[torch.float32]:.3g})")

    # The kernels' names as the profiler records them (a trace's groups);
    # several calls, since the profiler can miss a launch just after it starts.
    x = torch.randn(2, 16, 8, 8, device=dev).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    skip = torch.randn(2, 8, 16, 16, device=dev)
    di.decoder_input(x, skip, 2).sum().backward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            di.decoder_input(x, skip, 2).sum().backward()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "upsample_cat_reflection_pad" in e.key})
    log(f"  decoder_input: profiler kernel names {names}")
    if len(names) != 2:
        raise AssertionError(f"decoder_input: expected a forward and a backward kernel, {names}")

    shards = decoder_shard_check(rng)
    torch.cuda.empty_cache()
    return {"name": "decoder_input", "cells": report,
            "worst_grad_rel_err": {str(k)[6:]: v for k, v in worst.items()},
            "shards_worst_grad_rel_err": shards}


def decoder_shard_check(rng: np.random.RandomState) -> dict:
    """The kernel on width shards (``--spatial-shards``) against the plain
    composition on the whole image, at ``DECODER_SHARDS``: each shard's
    source and skip cut with one column from each neighbour (none at the
    image's edges) and launched with those side flags, as
    ``decoder_input`` launches it after ``distributed.halo``. Each shard's
    output equals its columns of the whole image's padded input bit for
    bit; the shards' gradients, each halo column's added where it came
    from (the halo's backward), match the whole image's fp32 gradient
    within ``DECODER_GRAD_TOL``. Returns the worst error by dtype."""
    from sc_sfmlearner_release_tpu_torch.ops import decoder_input as di

    dev = torch.device(DEVICE)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for label, n, h, w, count in DECODER_SHARDS:
        for name, src_shape, skip_shape, scale in decoder_sites(18, n, h, w):
            for dtype in (torch.bfloat16, torch.float32):
                src = (torch.from_numpy(rng.standard_normal(src_shape).astype(np.float32))
                       .to(dev, dtype) if src_shape else None)
                skip = (torch.from_numpy(rng.standard_normal(skip_shape).astype(np.float32))
                        .to(dev) if skip_shape else None)
                leaves = [t.float().requires_grad_(True) for t in (src, skip) if t is not None]
                whole = di.decoder_input_plain(leaves[0] if src is not None else None,
                                               leaves[-1] if skip is not None else None, scale)
                width = (whole.shape[3] - 2) // count  # a shard's columns, upsampled
                widths = ([width // scale] if src is not None else []) + (
                    [width] if skip is not None else [])
                grads = [torch.zeros_like(t) for t in leaves]
                ct_whole = torch.zeros_like(whole)
                for i in range(count):
                    left, right = int(i > 0), int(i < count - 1)
                    cut = lambda t, wd: t[..., i * wd - left:(i + 1) * wd + right]
                    xs = di._last(cut(src, width // scale)) if src is not None else None
                    ks = cut(skip, width).contiguous() if skip is not None else None
                    s = di._Shape(xs, ks, scale, dtype, left, right)
                    out = di._launch_fwd(xs, ks, s)
                    want = whole.detach()[..., i * width:(i + 1) * width + 2].to(dtype)
                    if not (out.is_contiguous(memory_format=torch.channels_last)
                            and torch.equal(out, want)):
                        raise AssertionError(f"decoder_input shards {label} {name} "
                                             f"{str(dtype)[6:]}: shard {i} of {count} differs "
                                             "from its columns of the whole image")
                    ct = torch.randn(out.shape, device=dev, dtype=dtype).contiguous(
                        memory_format=torch.channels_last)
                    ct_whole[..., i * width:(i + 1) * width + 2] += ct.float()
                    got = [g for g in di.decoder_input_bwd(ct, s, xs is not None,
                                                           ks is not None) if g is not None]
                    for acc, g, wd in zip(grads, got, widths):
                        cut(acc, wd).add_(g.float())
                for which, a, b in zip(("src", "skip") if src is not None else ("skip",),
                                       grads, torch.autograd.grad(whole, leaves, ct_whole)):
                    err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                    worst[dtype] = max(worst[dtype], err)
                    if not err <= DECODER_GRAD_TOL[dtype]:
                        raise AssertionError(f"decoder_input shards {label} {name} "
                                             f"{str(dtype)[6:]} d/d{which}: max|err|/max|ref| "
                                             f"{err:.3e} > {DECODER_GRAD_TOL[dtype]:.3g}")
        log(f"  decoder_input: {count} width shards of DispNet-18's inputs at {label}: "
            "forwards bit for bit")
    log(f"  decoder_input: width shards' worst gradient max|err|/max|ref| bf16 "
        f"{worst[torch.bfloat16]:.3e}, fp32 {worst[torch.float32]:.3e}")
    return {str(k)[6:]: v for k, v in worst.items()}


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
    # Width sharding (S = 2): shard 1's target columns, W/2 wide from column
    # W/2 (what pixel_grid(x0=W/2) projects, normalised by the whole W), sample
    # the source gathered to its whole width.
    for mode, label, coords in list(cases):
        cases.append((mode, f"{label}, shard 1 of 2", coords[:, :, W // 2:].contiguous()))
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
    bound_ms, bound_by = warp_fwd_bound(PAIRS * H * W)
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
    full = torch.from_numpy(rng.randn(PAIRS, H, W, 4).astype(np.float32)).to(DEVICE)
    err = 0.0
    for mode, label, coords in inputs["cases"]:
        dout = full[:, :, :coords.shape[2]].contiguous()
        dsrc, dcoords = warp_sample_bwd(src, coords, dout, mode, 1, True)
        (want_d, want_c), _ = plain_grads(
            lambda d, c: warp_sample_plain(d, c, mode, frozen=rgb), (depth, coords), dout)
        torch.cuda.synchronize()
        err = max(err, check_rel(f"warp_sample_bwd {mode}/{label} d(coords)", dcoords, want_c,
                                 GRAD_TOL))
        err = max(err, check_rel(f"warp_sample_bwd {mode}/{label} d(depth)", dsrc, want_d,
                                 GRAD_TOL))
    mode, label, coords = inputs["cases"][0]
    dout = full
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
    bound_ms, bound_by = warp_bwd_bound(PAIRS * H * W)
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


# A tile of width sharding at S = 2: half the width and one halo column on
# its inner side (``ops/ssim.py::ssim_nchw_sharded``). Its backward is held
# against its plain version ``ssim_nchw_bwd_plain``; against autograd through
# the plain forward it is only reported, beside both against a float64
# autograd: on correlated inputs these two fp32 evaluations, each ~4.5e-5 of
# max|ref| from the float64 one, differ by up to 1.2e-5 of it at one pixel
# of this shape, above GRAD_TOL.
SSIM_SHARD_SHAPE = (PAIRS, 3, H, W // 2 + 1)


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
    cases = [((PAIRS, 3, H, W), False), (SSIM_SHARD_SHAPE, False),
             *((s, False) for s in SSIM_EDGE_SHAPES), (offset, True)]
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
    bound_ms, bound_by = ssim_fwd_bound(x.numel())
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


def report_against_float64(name: str, x, y, g, got, fp32) -> None:
    """Logs the kernel's (d/dx, d/dy) ``got`` and autograd's fp32 ``fp32``
    against each other and against autograd through the plain forward in
    float64, each as max|err| over max|ref|."""
    (want_x, want_y), _ = plain_grads(ssim_nchw_plain, (x.double(), y.double()),
                                      g.double())
    rel = lambda a, b: ((a.double() - b).abs().max() / b.abs().max()).item()
    for i, d in ((1, "d/dy"), (0, "d/dx")):
        exact = (want_x, want_y)[i]
        log(f"  {name} {d} (reported): kernel vs autograd {rel(got[i], fp32[i]):.3e}; "
            f"against float64 autograd: kernel {rel(got[i], exact):.3e}, fp32 autograd "
            f"{rel(fp32[i], exact):.3e}")


def ssim_bwd_check(rng: np.random.RandomState) -> float:
    """The backward kernel against autograd through the plain forward and
    against its own plain version ``ssim_nchw_bwd_plain``, for d/dy alone
    (the main path's call) and d/dx with d/dy, at every SSIM case (at
    ``SSIM_SHARD_SHAPE`` against the plain version, autograd reported);
    and once through the autograd Function."""
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
            refs = [("autograd", (want_x, want_y)), ("plain", (plain_x, plain_y))]
            if tuple(x.shape) == SSIM_SHARD_SHAPE:
                report_against_float64(name, x, y, g, (dx, dy), (want_x, want_y))
                refs = refs[1:]
            for ref, want in refs:
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
    bound_ms, bound_by = ssim_bwd_bound(n)
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


# Every kernel wrapper of the port, by the name the kernels line gives it.
WRAPPERS = {fn.__name__: fn for fn in KERNEL_WRAPPERS}


def unlaunched(launches: dict) -> list:
    """The kernels of an SC-Depth path's ``launches`` that did not launch,
    and ManyDepth's cost volume if it did."""
    return [k for k, n in launches.items() if (n < 1) != (k == "cost_volume")]


def zero_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def make_nets(seed: int, layers: int = 18):
    """DispNet of ``layers`` and PoseNet-18 (PoseNet is ResNet-18 in every
    configuration) from seeded generators."""
    return (DispNet(layers, generator=torch.Generator().manual_seed(seed)),
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
    if any(launches[k] for k in ("warp_sample_bwd", "ssim_nchw_bwd", "decoder_input_bwd",
                                 "cost_volume")):
        raise AssertionError("the validation step launched a backward kernel or the cost volume")
    if infer_launches["decoder_input"] != DECODER_INPUTS:
        raise AssertionError(f"inference: {infer_launches['decoder_input']} decoder-input "
                             f"launches, expected {DECODER_INPUTS} (every input of the decoder)")
    if disp.shape != (B, H, W, 1) or not torch.isfinite(depth).all():
        raise AssertionError(f"inference: shape {tuple(disp.shape)} or non-finite depth")
    if not (disp.min().item() >= 0.01 and disp.max().item() <= 10.01):
        raise AssertionError("inference: disparity outside [0.01, 10.01]")
    vals = {k: metrics[k].item() for k in METRICS}
    log(f"[slice] bf16 eval step: {vals}")
    if not all(np.isfinite(v) for v in vals.values()) or vals["photo_loss"] <= 0:
        raise AssertionError(f"eval step: bad losses {vals}")
    for name in ("warp_sample", "ssim_nchw", "decoder_input"):
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


def check_step_inputs(seed: int, rng: np.random.RandomState, layers: int = 18,
                      shape=CHECK_SHAPE, intrinsics=None):
    """``check_step_against_cpu``'s nets (heads spread) and numpy batch."""
    b, n, h, w = shape
    if intrinsics is None:
        intrinsics = kitti_intrinsics(b)
        intrinsics[:, :2] *= np.array([[w / W], [h / H]], np.float32)
    batch = {"tgt": rng.rand(b, h, w, 3).astype(np.float32),
             "refs": rng.rand(b, n, h, w, 3).astype(np.float32), "intrinsics": intrinsics}
    nets = make_nets(seed, layers)
    spread_heads(*nets, seed)
    return nets, batch


def check_step_against_cpu(seed: int, rng: np.random.RandomState, gate: bool = True,
                           layers: int = 18, shape=CHECK_SHAPE, intrinsics=None,
                           cfg: LossConfig = LossConfig(), grad_rtol=GRAD_RTOL) -> dict:
    """The fp32 train step on the card (TF32 off) against the plain versions
    on the CPU, by default at B2 N2 128x416 (``shape``) with full-width
    ResNet-18 (DispNet of ``layers``) and KITTI's camera scaled to it
    (``intrinsics``, a ``[B, 3, 3]`` array, in its place): losses, and each
    parameter's gradient by relative L2 against ``grad_rtol``. Returns the
    worst errors (and the worst tensors' names under ``where_*``); with
    ``gate`` a crossing raises."""
    (disp_net, pose_net), batch = check_step_inputs(seed, rng, layers, shape, intrinsics)
    cpu_nets = (copy.deepcopy(disp_net), copy.deepcopy(pose_net))
    card = make_train_step(disp_net, pose_net, make_optimizer(disp_net, pose_net), cfg,
                           device=DEVICE, precision="fp32")
    cpu = make_train_step(*cpu_nets, make_optimizer(*cpu_nets), cfg, device="cpu",
                          precision="fp32")
    got = {k: v.item() for k, v in card(batch).items()}
    want = {k: v.item() for k, v in cpu(batch).items()}
    worst = {}
    for key in METRICS:
        rel = abs(got[key] - want[key]) / max(abs(want[key]), 1e-12)
        worst[key] = rel
        log(f"  fp32 train {key}: card {got[key]:.7f} cpu {want[key]:.7f} rel {rel:.2e} "
            f"(tol {STEP_RTOL:.0e})")
        if gate and not rel <= STEP_RTOL:
            raise AssertionError(f"fp32 train {key}: card {got[key]} vs CPU {want[key]}")
    g_card, g_cpu = grads_by_name(disp_net, pose_net), grads_by_name(*cpu_nets)
    if set(g_card) != set(g_cpu) or len(g_cpu) < 100:
        raise AssertionError(f"gradients of {len(g_card)} and {len(g_cpu)} tensors")
    rels = {}
    for name, ref in g_cpu.items():
        rels[name] = ((g_card[name] - ref).norm() / ref.norm().clamp_min(1e-30)).item()
    for part, tol in grad_rtol.items():
        mine = {k: v for k, v in rels.items() if (".encoder." in k) == (part == "encoders")}
        top = max(mine, key=mine.get)
        log(f"  fp32 train gradients, {part}: {len(mine)} tensors, median rel L2 "
            f"{np.median(list(mine.values())):.2e}, worst {mine[top]:.2e} ({top}) (tol {tol:.1e})")
        if gate and not mine[top] <= tol:
            raise AssertionError(f"fp32 train gradient {top}: rel L2 {mine[top]:.2e} > {tol}")
        worst[f"grad_{part}"] = mine[top]
        worst[f"where_{part}"] = top
    return worst


def cpu_check_seeds(seed: int, n: int) -> list:
    """The fp32 card-against-CPU check from ``n`` more draws (draw ``d``:
    ``make_nets(d)`` with its heads spread, the batch from
    ``RandomState(d)``, ``d = seed + 200 ...``), each against every gate:
    the worst errors over the draws and the crossings, which it returns."""
    tols = {**{k: STEP_RTOL for k in METRICS},
            **{f"grad_{part}": tol for part, tol in GRAD_RTOL.items()}}
    crossings, worst = [], {k: (0.0, None) for k in tols}
    for draw in range(seed + 200, seed + 200 + n):
        got = check_step_against_cpu(draw, np.random.RandomState(draw), gate=False)
        for k, tol in tols.items():
            if got[k] > worst[k][0]:
                worst[k] = (got[k], draw)
            if not got[k] <= tol:
                where = got.get(f"where_{k[5:]}", "")
                crossings.append(f"draw {draw} {k} {got[k]:.3e} > {tol} {where}")
        log(f"[cpu-check] draw {draw}: " + ", ".join(
            f"{k} {got[k]:.3e}" + (f" ({got['where_' + k[5:]]})" if k.startswith("grad") else "")
            for k in tols))
    log(f"[cpu-check] {n} draws: worst (value, draw) " + ", ".join(
        f"{k} {v:.3e} (draw {d}; tol {tols[k]})" for k, (v, d) in worst.items())
        + f"; {len(crossings)} crossing(s): {crossings}")
    return crossings


def bf16_step(tag: str, nets, batch: dict, cfg: LossConfig, profile: bool = False):
    """The bf16 train step of ``nets`` (DispNet, PoseNet) on the numpy
    ``batch``: one step with the launch counts at 0, in which every kernel
    but the cost volume must launch, and it not; TRAIN_STEPS more with
    finite losses; the median host time fed the numpy batch and with the
    batch on the card; peak memory; the device time of a CUDA-graph replay
    of the step on a copy of the nets.
    Returns (launches, times)."""
    disp_net, pose_net = nets
    state = create_train_state(disp_net, pose_net, make_optimizer(disp_net, pose_net))
    step = make_train_step(disp_net, pose_net, state.optimizer, cfg, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()

    zero_launches()
    first = step(batch)
    launches = read_launches()
    log(f"[{tag}] launches in one bf16 train step: {launches}")
    if unlaunched(launches):
        raise AssertionError(f"{unlaunched(launches)}: launched or not against the train step")
    losses = [first["loss"].item()] + [step(batch)["loss"].item() for _ in range(TRAIN_STEPS)]
    log(f"[{tag}] bf16 losses over {len(losses)} steps: {[round(x, 6) for x in losses]}")
    if not all(np.isfinite(losses)) or state.step != TRAIN_STEPS + 1:
        raise AssertionError(f"train step: losses {losses}, {state.step} optimizer steps")

    on_card = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    times = {"train_step_bf16_ms": host_ms(lambda: step(batch)),
             "train_step_bf16_batch_on_card_ms": host_ms(lambda: step(on_card))}
    times["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # The device's own time per step, from a CUDA-graph replay of the same
    # step on a copy of the nets; capture needs Adam's capturable form,
    # which keeps its step count on the card.
    copies = (copy.deepcopy(disp_net), copy.deepcopy(pose_net))
    adam = torch.optim.Adam([q for net in copies for q in net.parameters()], lr=1e-4,
                            eps=1e-8, capturable=True)
    graph_step = make_train_step(*copies, adam, cfg, device=DEVICE)
    times["train_step_bf16_device_ms"] = graph_ms(lambda: graph_step(on_card), 3)
    times["device_busy_share"] = (times["train_step_bf16_device_ms"]
                                  / times["train_step_bf16_batch_on_card_ms"])
    del graph_step, adam, copies
    log(f"[{tag}] times (host clock, median of {STEP_ITERS}, each step ends in synchronize; "
        f"device_ms from a CUDA-graph replay): {times}")
    log(f"[{tag}] peak device memory {times['peak_memory_gib']:.2f} GiB")
    if profile:
        profile_phase(step, on_card, "bf16 train step")
    return launches, times


def train_phase(seed: int, rng: np.random.RandomState, profile: bool):
    """Slice 3's path: the bf16 train step at full width. Returns its
    launches and its device time per step."""
    launches, times = bf16_step("train", make_nets(seed), make_batch(rng), LossConfig(),
                                profile)
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


def noise_texture(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """uint8 ``[h, w, 3]``: 8x8-pixel blocks of noise with finer noise on them."""
    coarse = rng.randint(32, 224, (-(-h // 8), -(-w // 8), 3))
    texture = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:h, :w]
    return np.clip(texture + rng.randint(-24, 25, texture.shape), 0, 255).astype(np.uint8)


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
        texture = noise_texture(rng, H, W + 2 * count)
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


def run_cli(root: str, name: str, seed: int, *extra: str,
            data_args=("--packed", "--device-augment")) -> str:
    """``train.main`` from ``root`` (where ``checkpoints/`` lands) on the
    canonical configuration, by default from the packed frames; returns the
    experiment directory. The CLI's progress lines are printed after it
    ends."""
    argv = [root, "--name", name, *data_args,
            "--with-pretrain", "0", "-b", str(B), "--sequence-length", str(1 + N),
            "--with-auto-mask", "1", "--epochs", str(CLI_EPOCHS), "--epoch-size",
            str(CLI_EPOCH_SIZE), "--val-batches", str(CLI_VAL_BATCHES), "--no-tensorboard",
            "--log-style", "line", "--seed", str(seed), *extra]
    return run_train(root, argv)


def run_train(root: str, argv: list, tag: str = "cli") -> str:
    """``train.main(argv)`` from ``root`` (where ``checkpoints/`` lands);
    returns the experiment directory of ``argv``'s ``--name``. The CLI's
    progress lines are printed after it ends."""
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
                log(f"  [{tag}] {line.strip()}")
    if code != 0:
        raise AssertionError(f"train CLI exited {code}")
    (path,) = glob.glob(os.path.join(root, "checkpoints", argv[argv.index("--name") + 1], "*"))
    return path


def read_rows(path: str):
    with open(path) as f:
        return list(csv.reader(f, delimiter="\t"))[1:]


def check_cli_outputs(save: str, label: str, steps: int = CLI_STEPS, layers: int = 18) -> list:
    """``steps`` finite loss rows, and the reference-layout weight files load
    into fresh networks (DispNet of ``layers``); returns the rows."""
    rows = read_rows(os.path.join(save, "progress_log_full.csv"))
    losses = [float(r[0]) for r in rows]
    if len(rows) != steps or not all(np.isfinite(float(v)) for r in rows for v in r):
        raise AssertionError(f"{label} progress_log_full.csv: {len(rows)} rows {rows}")
    log(f"[{label}] {len(rows)} finite loss rows, first {losses[0]:.5f} last {losses[-1]:.5f}")
    for prefix, net in (("dispnet", DispNet(layers)), ("exp_pose", PoseNet(18))):
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


def cli_times(save: str, prefix: str, skip: int, epoch_size: int = CLI_EPOCH_SIZE) -> dict:
    """Step and data wait per optimizer step from the time log, after the
    first ``skip`` rows: the median, and the mean over the second epoch,
    whose rows add up to its wall time from its first batch to its
    metrics on the host."""
    timing = read_rows(os.path.join(save, train_cli.TIME_LOG))
    step_ms = [1e3 * float(r[2]) for r in timing]
    wait_ms = [1e3 * float(r[1]) for r in timing]
    times = {f"{prefix}_first_step_ms": step_ms[0],
             f"{prefix}_step_ms_median_after_{skip}": float(np.median(step_ms[skip:])),
             f"{prefix}_step_ms_range_after_{skip}": [min(step_ms[skip:]), max(step_ms[skip:])],
             f"{prefix}_data_wait_ms_median_after_{skip}": float(np.median(wait_ms[skip:])),
             f"{prefix}_data_wait_ms_mean_after_{skip}": float(np.mean(wait_ms[skip:]))}
    if len(step_ms) > epoch_size:
        times[f"{prefix}_step_ms_mean_epoch_2"] = float(np.mean(step_ms[epoch_size:]))
    return times


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
    if launches != want or unlaunched(per_step):
        raise AssertionError(f"CLI launches {launches}, expected {want}")
    first_row = [float(v) for v in check_cli_outputs(save, "cli")[0]]

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
    times = {**cli_times(save, "cli", 1), "loader_alone_ms_per_batch": loader_ms,
             "cli_first_step_losses": first_row}
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
    return {"train_cli": launches, "train_cli_fused": fused_launches}, {**times, **fused_times}


# The distributed phase: data parallelism over processes (parallel/distributed.py).
DIST_DIR = os.path.join("build", "chip_smoke_distributed")
# The --distributed CLI's first step at world size 1 against phase 6's: the
# same batch, draws, weights and bf16 convolutions, and a forward only (no
# atomics yet). What differs is BatchNorm's statistics, taken from the
# processes' means and means of squares (PyTorch's SyncBatchNorm kernels)
# instead of by cuDNN's kernel: a rounding of a statistic
# moves some bf16 inputs of the next convolution by one bf16 ulp (2^-8
# relative), which the loss's means over ~10^6 pixels average down to well
# under 1e-3 of each loss term.
DIST_FIRST_STEP_RTOL = 1e-3
DIST_FUSED_K, DIST_FUSED_CALLS = 2, 3
DIST_WORKER_TIMEOUT = 300   # s, the processes of a multi-process run together
# A rank still running after this long prints every thread's stack and exits
# (a collective that waits for a peer never returns by itself).
DIST_STACK_DUMP_S = 240
# The two ranks' BatchNorm statistics after the step against one process's,
# as the CPU test of the 2-rank step holds them.
DIST_BN_RTOL, DIST_BN_ATOL = 1e-4, 1e-5
# BatchNorm2d's global path (PyTorch's SyncBatchNorm kernels) at world size
# 1 against F.batch_norm: within this share of each tensor's largest value,
# as the CPU test of the global BatchNorm (the statistics come from means
# and means of squares, rounded otherwise than F.batch_norm's).
BN_CHECK_TOL = 1e-5
# DispNet's encoder's first and last BatchNorm at the main path's width.
BN_CHECK_SHAPES = ((B, 64, H // 2, W // 2), (B, 512, H // 32, W // 32))


@contextlib.contextmanager
def torchrun_env(rank: int, world: int, local_rank: int, port: int):
    """torchrun's environment for one process, put back after."""
    env = {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(local_rank),
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def params_digest(*nets) -> str:
    """SHA-256 of every parameter's bytes, in order."""
    flat = torch.cat([p.detach().reshape(-1) for net in nets for p in net.parameters()])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def two_rank_inputs(seed: int, shape=CHECK_SHAPE):
    """The fp32 check's nets (heads spread) and a global batch of ``shape``
    (B, N, H, W)."""
    b, n, h, w = shape
    rng = np.random.RandomState(seed)
    k = kitti_intrinsics(b)
    k[:, :2] *= np.array([[w / W], [h / H]], np.float32)
    batch = {"tgt": rng.rand(b, h, w, 3).astype(np.float32),
             "refs": rng.rand(b, n, h, w, 3).astype(np.float32), "intrinsics": k}
    disp_net, pose_net = make_nets(seed)
    spread_heads(disp_net, pose_net, seed)
    return disp_net, pose_net, batch


def bn_buffers(*nets) -> dict:
    """Every buffer (BatchNorm's running statistics and counts), on the CPU."""
    return {f"{i}.{k}": v.detach().cpu().clone() for i, net in enumerate(nets)
            for k, v in net.named_buffers()}


def two_rank_rank(device: torch.device, seed: int) -> dict:
    """One of the two ranks (``distributed.run_processes``): the fp32 step
    on its half of the global batch, and over NCCL the graphed step."""
    faulthandler.dump_traceback_later(DIST_STACK_DUMP_S, exit=True)
    disable_tf32()
    backend = torch.distributed.get_backend()
    rank = distributed.process_index()
    t0 = time.perf_counter()
    stage = lambda name: log(f"rank {rank} {name} at {time.perf_counter() - t0:.1f} s")
    result = {"route": f"{backend}, {torch.cuda.device_count()} card(s)",
              "device": str(device)}
    disp_net, pose_net, batch = two_rank_inputs(seed)
    rows = distributed.local_rows(CHECK_SHAPE[0])
    local = {k: v[rows] for k, v in batch.items()}
    optimizer = make_optimizer(disp_net, pose_net)
    step = make_train_step(disp_net, pose_net, optimizer, device=device, precision="fp32")
    distributed.replicate(disp_net, pose_net, optimizer)  # a broadcast on the card
    zero_launches()
    result["metrics"] = {k: v.item() for k, v in step(local).items()}
    result["launches"] = read_launches()
    stage("fp32 step")
    result["digest"] = params_digest(disp_net, pose_net)
    result["buffers"] = bn_buffers(disp_net, pose_net)
    if rank == 0:
        result["grads"] = grads_by_name(disp_net, pose_net)
    # The gradient all-reduce alone (the 26.8 M fp32 gradients and 4
    # metrics in one collective): NCCL's device time per call from a
    # CUDA-graph replay; gloo's, which stages through the host, from CUDA
    # events around eager calls.
    params = [p for net in (disp_net, pose_net) for p in net.parameters()]
    metrics = {k: torch.zeros((), device=device) for k in METRICS}
    allreduce = lambda: distributed.sum_grads_and_metrics(params, metrics)
    result["grad_allreduce_ms"] = (graph_ms(allreduce, 10) if backend == "nccl"
                                   else cuda_ms(allreduce, 10))
    stage("gradient all-reduce timed")
    if backend == "nccl":
        result["fused"] = two_rank_graphed(seed + 1, device, local, stage)
    faulthandler.cancel_dump_traceback_later()
    return result


def two_rank_graphed(seed: int, device: torch.device, local: dict, stage) -> dict:
    """``fused_steps=DIST_FUSED_K`` for DIST_FUSED_CALLS calls (a warm-up, a
    capture and replay, a replay): the all-reduces inside the CUDA graph.
    The graph goes with this function: NCCL's communicator is destroyed
    only once no graph holds its collectives."""
    nets = make_nets(seed)
    graphed = make_train_step(*nets, make_optimizer(*nets, capturable=True), device=device,
                              precision="fp32", fused_steps=DIST_FUSED_K)
    stacked = {k: torch.from_numpy(np.stack([v] * DIST_FUSED_K)) for k, v in local.items()}
    zero_launches()
    losses = []
    for call in range(DIST_FUSED_CALLS):
        losses.append(graphed(stacked)["loss"].tolist())
        stage(f"graphed call {call}")
    return {"losses": losses, "launches": read_launches(), "digest": params_digest(*nets)}


def check_ranks(results: list, per_step: dict, want: dict, want_grads: dict,
                want_buffers: dict, who: str) -> None:
    """Every rank's fp32 step (its ``launches``, ``metrics``, ``digest``
    and ``buffers``; rank 0's ``grads``, summed over the ranks) against one
    process's on the global batch: the launches, the losses within
    STEP_RTOL, bit-identical parameters, every BatchNorm buffer within abs
    DIST_BN_ATOL + rel DIST_BN_RTOL, every gradient within GRAD_RTOL."""
    for r, res in enumerate(results):
        if res["launches"] != per_step:
            raise AssertionError(f"rank {r} launches {res['launches']}, expected {per_step}")
        for key in METRICS:
            rel = abs(res["metrics"][key] - want[key]) / max(abs(want[key]), 1e-12)
            log(f"  rank {r} fp32 {key}: {res['metrics'][key]:.7f} one process "
                f"{want[key]:.7f} rel {rel:.2e} (tol {STEP_RTOL:.0e})")
            if not rel <= STEP_RTOL:
                raise AssertionError(f"rank {r} {key}: {res['metrics'][key]} vs {want[key]}")
    if len({res["digest"] for res in results}) != 1:
        raise AssertionError(f"the {who} parameters differ after the step")
    log(f"  the {who} parameters after the fp32 step: bit-identical")
    for r, res in enumerate(results):
        if set(res["buffers"]) != set(want_buffers) or len(want_buffers) < 100:
            raise AssertionError(f"rank {r}: buffers of {len(res['buffers'])} and "
                                 f"{len(want_buffers)} tensors")
        # |err| over its bound, abs DIST_BN_ATOL + rel DIST_BN_RTOL, per buffer.
        ratios = {k: ((res["buffers"][k].double() - v.double()).abs()
                      / (DIST_BN_ATOL + DIST_BN_RTOL * v.double().abs())).max().item()
                  for k, v in want_buffers.items()}
        worst = max(ratios, key=ratios.get)
        if not ratios[worst] <= 1.0:
            raise AssertionError(f"rank {r} BatchNorm buffer {worst}: {ratios[worst]:.3f} "
                                 f"times its bound (rel {DIST_BN_RTOL}, abs {DIST_BN_ATOL})")
        log(f"  rank {r} BatchNorm statistics ({len(want_buffers)} buffers) against one "
            f"process: worst |err| / (abs {DIST_BN_ATOL:.0e} + rel {DIST_BN_RTOL:.0e}) "
            f"{ratios[worst]:.3f} ({worst}; must be <= 1)")
    got = results[0]["grads"]
    if set(got) != set(want_grads) or len(got) < 100:
        raise AssertionError(f"gradients of {len(got)} and {len(want_grads)} tensors")
    rels = {k: ((got[k] - g).norm() / g.norm().clamp_min(1e-30)).item()
            for k, g in want_grads.items()}
    for part, tol in GRAD_RTOL.items():
        mine = {k: v for k, v in rels.items() if (".encoder." in k) == (part == "encoders")}
        top = max(mine, key=mine.get)
        log(f"  {who} gradients (summed) against one process, {part}: {len(mine)} "
            f"tensors, median rel L2 {np.median(list(mine.values())):.2e}, worst "
            f"{mine[top]:.2e} ({top}) (tol {tol:.1e})")
        if not mine[top] <= tol:
            raise AssertionError(f"{who} gradient {top}: rel L2 {mine[top]:.2e} > {tol}")


def two_rank_phase(seed: int, per_step: dict) -> dict:
    """Two ranks on the card(s) against one process on the global batch."""
    # The reference first: one process, the global batch, this card.
    disp_net, pose_net, batch = two_rank_inputs(seed)
    step = make_train_step(disp_net, pose_net, make_optimizer(disp_net, pose_net),
                           device=DEVICE, precision="fp32")
    want = {k: v.item() for k, v in step(batch).items()}
    want_grads = grads_by_name(disp_net, pose_net)
    want_buffers = bn_buffers(disp_net, pose_net)
    del step, disp_net, pose_net
    torch.cuda.empty_cache()
    results = distributed.run_processes(two_rank_rank, 2, DEVICE, args=(seed,),
                                        timeout=DIST_WORKER_TIMEOUT)
    log(f"[distributed] two ranks: {results[0]['route']} on {results[0]['device']} and "
        f"{results[1]['device']}; gradient all-reduce {results[0]['grad_allreduce_ms']:.4f} ms "
        f"per step (10 calls; NCCL: a CUDA-graph replay, gloo: CUDA events)")
    check_ranks(results, per_step, want, want_grads, want_buffers, "two ranks'")
    paths = {"two_ranks_rank0": results[0]["launches"]}
    if "fused" in results[0]:
        fused = [res["fused"] for res in results]
        want_fused = {k: DIST_FUSED_CALLS * DIST_FUSED_K * n for k, n in per_step.items()}
        for r, f in enumerate(fused):
            log(f"  rank {r} fused_steps={DIST_FUSED_K}, {DIST_FUSED_CALLS} calls (warm-up, "
                f"capture and replay, replay): losses {f['losses']}, launches {f['launches']}")
            if f["launches"] != want_fused or not np.all(np.isfinite(f["losses"])):
                raise AssertionError(f"rank {r} graphed steps: {f}")
        if fused[0]["digest"] != fused[1]["digest"]:
            raise AssertionError("the ranks' parameters differ after the graphed steps: the "
                                 "all-reduce did not run inside the graph")
        paths["two_ranks_fused_rank0"] = fused[0]["launches"]
    else:
        log("[distributed] one card: gloo, eager only (NCCL refuses two ranks on one device)")
    return paths


def global_bn_check(seed: int) -> None:
    """``BatchNorm2d``'s global path on the card (``_GlobalBatchNorm``'s
    CUDA branch) in a world-size-1 group against ``F.batch_norm`` with the
    port's rule for the running statistics (momentum 0.1 towards the biased
    variance): output, input, weight and bias gradients and both running
    statistics, at BN_CHECK_SHAPES in both memory formats."""
    if not distributed.is_distributed():
        raise AssertionError("the BatchNorm check needs the world-size-1 group")
    g = torch.Generator().manual_seed(seed)
    for shape in BN_CHECK_SHAPES:
        c, n = shape[1], math.prod(shape) // shape[1]
        for fmt in (torch.contiguous_format, torch.channels_last):
            x = (torch.randn(shape, generator=g) * 2 + 0.5).to(DEVICE).contiguous(
                memory_format=fmt)
            dy = torch.randn(shape, generator=g).to(DEVICE).contiguous(memory_format=fmt)
            weight, bias = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g)
            mean0, var0 = torch.randn(c, generator=g), torch.rand(c, generator=g) + 0.5
            bn = BatchNorm2d(c).to(DEVICE).train()
            with torch.no_grad():
                for buf, v in ((bn.weight, weight), (bn.bias, bias), (bn.running_mean, mean0),
                               (bn.running_var, var0)):
                    buf.copy_(v)
            xg = x.clone().requires_grad_()
            out = bn(xg)
            out.backward(dy)
            xr = x.clone().requires_grad_()
            wr, br = weight.to(DEVICE).requires_grad_(), bias.to(DEVICE).requires_grad_()
            mean, var = torch.zeros(c, device=DEVICE), torch.zeros(c, device=DEVICE)
            ref = F.batch_norm(xr, mean, var, wr, br, True, 1.0, bn.eps)
            ref.backward(dy)
            errs = {}
            for name, got, want in (
                    ("output", out, ref), ("input grad", xg.grad, xr.grad),
                    ("weight grad", bn.weight.grad, wr.grad),
                    ("bias grad", bn.bias.grad, br.grad),
                    ("running_mean", bn.running_mean, mean0.to(DEVICE).lerp(mean, bn.momentum)),
                    ("running_var", bn.running_var,
                     var0.to(DEVICE).lerp(var * ((n - 1) / n), bn.momentum))):
                errs[name] = ((got - want).abs().max() / want.abs().max()).item()
                if not errs[name] <= BN_CHECK_TOL:
                    raise AssertionError(f"global BatchNorm {shape} {fmt} {name}: "
                                         f"{errs[name]:.2e} of max > {BN_CHECK_TOL}")
            log(f"[distributed] global BatchNorm {list(shape)} "
                f"{'channels_last' if fmt == torch.channels_last else 'contiguous'} against "
                f"F.batch_norm, max |err| / max |ref| (tol {BN_CHECK_TOL:.0e}): "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))


def distributed_phase(seed: int, smi: str, per_step: dict, per_validation: dict,
                      packed_times: dict, step_device_ms: float) -> dict:
    """(1) the --distributed CLI at world size 1 under NCCL, eager and fused;
    the step's device time in the group; (2) two ranks on the card(s); (3)
    the multi-device dry run; (4) the wall time."""
    t_phase = time.perf_counter()
    root = os.path.abspath(os.path.join(DIST_DIR, "trainer"))
    shutil.rmtree(root, ignore_errors=True)
    write_packed_dataset(root, seed)
    val_samples = sum(n - N for name, n in CLI_SCENES if name.startswith("val"))
    val_batches = CLI_EPOCHS * min(CLI_VAL_BATCHES, -(-val_samples // B))
    want = {k: CLI_STEPS * per_step[k] + val_batches * per_validation[k] for k in WRAPPERS}
    by_path, times = {}, {}
    first_want = packed_times["cli_first_step_losses"]
    for path, name, extra in (("train_cli_distributed", "smoke_dist", ()),
                              ("train_cli_distributed_fused", "smoke_dist_fused",
                               ("--fused-steps", str(CLI_FUSED_K)))):
        torch.cuda.reset_peak_memory_stats()
        with torchrun_env(0, 1, 0, distributed.free_port()):
            zero_launches()
            save = run_cli(root, name, seed, "--distributed", *extra)
            by_path[path] = read_launches()
        if distributed.is_distributed():
            raise AssertionError("the CLI left its process group initialised")
        log(f"[distributed] {path}: launches {by_path[path]} (expected {want})")
        if by_path[path] != want:
            raise AssertionError(f"{path} launches {by_path[path]}, expected {want}")
        first = [float(v) for v in check_cli_outputs(save, path)[0]]
        rels = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(first, first_want)]
        log(f"[distributed] {path} first step's losses {first} against phase 6's "
            f"{first_want}: max rel {max(rels):.2e} (tol {DIST_FIRST_STEP_RTOL:.0e})")
        if not max(rels) <= DIST_FIRST_STEP_RTOL:
            raise AssertionError(f"{path}: first step's losses {first} vs {first_want}")
        skip = 1 if not extra else 2 * CLI_FUSED_K
        times[path] = {**cli_times(save, path, skip),
                       "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"[distributed] {path} times per optimizer step (host clock) | {smi}: "
            f"{times[path]}")
    log(f"[distributed] phase 6's CLI in this run, eager: median "
        f"{packed_times['cli_step_ms_median_after_1']:.2f} ms, epoch-2 mean "
        f"{packed_times['cli_step_ms_mean_epoch_2']:.2f} ms; fused: epoch-2 mean "
        f"{packed_times['cli_fused_step_ms_mean_epoch_2']:.2f} ms | {smi}")
    shutil.rmtree(root, ignore_errors=True)

    # The step's device time inside a world-size-1 NCCL group: BatchNorm's
    # global path, the loss's mask-sum collectives and the gradient all-reduce.
    with torchrun_env(0, 1, 0, distributed.free_port()):
        distributed.init_distributed("cuda")
        try:
            global_bn_check(seed)
            nets = make_nets(seed)
            adam = torch.optim.Adam([q for net in nets for q in net.parameters()], lr=1e-4,
                                    eps=1e-8, capturable=True)
            graph_step = make_train_step(*nets, adam, LossConfig(), device=DEVICE)
            on_card = {k: torch.from_numpy(v).to(DEVICE)
                       for k, v in make_batch(np.random.RandomState(seed)).items()}
            dist_device_ms = graph_ms(lambda: graph_step(on_card), 3)
            params = [p for net in nets for p in net.parameters()]
            metrics = {k: torch.zeros((), device=DEVICE) for k in METRICS}
            allreduce_ms = graph_ms(lambda: distributed.sum_grads_and_metrics(params, metrics),
                                    20)
            del graph_step, adam, nets, params
        finally:
            distributed.leave()
    times["device"] = {"step_device_ms_world_1": dist_device_ms,
                       "step_device_ms_no_group": step_device_ms,
                       "extra_device_ms": dist_device_ms - step_device_ms,
                       "grad_allreduce_ms_world_1": allreduce_ms}
    log(f"[distributed] bf16 train step B{B} N{N} {W}x{H}, device time (CUDA-graph replay) "
        f"in a world-size-1 NCCL group | {smi}: {times['device']}")
    torch.cuda.empty_cache()

    log("[distributed] two ranks against one process on the global batch")
    by_path.update(two_rank_phase(seed + 2, per_step))

    # The dry run over every card (two ranks sharing the one card where
    # there is one).
    n = max(2, torch.cuda.device_count())
    t = time.perf_counter()
    loss = graft_entry.dryrun_data_parallel(n)
    log(f"[distributed] graft_entry.dryrun_data_parallel({n}) in "
        f"{time.perf_counter() - t:.1f} s: loss {loss}")
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun_data_parallel({n}): loss {loss}")
    log(f"[distributed] phase {time.perf_counter() - t_phase:.1f} s | {smi}")
    return by_path


# The width-sharded phase (``--spatial-shards``): each image's columns split
# over SPATIAL_SHARDS ranks (NCCL with a card each where there are that many
# cards, else gloo with the ranks sharing card 0), held against one process
# on the same global batch. The fp32 check runs at full width: CHECK_SHAPE's
# 416 columns are 13 at the deepest level and cannot split in two.
SPATIAL_DIR = os.path.join("build", "chip_smoke_spatial")
SPATIAL_SHARDS = 2
SPATIAL_CHECK_SHAPE = (2, 2, H, W)
# Each rank's peak device memory over the one process's on the same global
# batch, at most: above it some activation is kept at full width.
SPATIAL_MEMORY_SHARE = 0.75
SPATIAL_TIMED_STEPS = 5
SPATIAL_CLI_EPOCH_SIZE = 4
SPATIAL_CLI_FUSED_K = 2


def spatial_local(batch: dict) -> dict:
    """This rank's rows (its data group's) of a global batch, at full
    width: the step cuts the columns."""
    rows = distributed.local_rows(batch["tgt"].shape[0])
    return {k: v[rows] for k, v in batch.items()}


def spatial_peak_gib(device, fn):
    """``fn()``'s peak device memory above what was allocated before it, GiB."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    out = fn()
    torch.cuda.synchronize(device)
    return out, (torch.cuda.max_memory_allocated(device) - base) / 2**30


def spatial_rank(device: torch.device, seed: int) -> dict:
    """One width shard (``distributed.run_processes(..., spatial_shards=2)``):
    the fp32 step on its columns of the fp32 check's batch, then the bf16
    canonical step on its columns of B4 N2 832x256 with its peak memory,
    its time and the spatial collectives it calls."""
    faulthandler.dump_traceback_later(DIST_STACK_DUMP_S, exit=True)
    disable_tf32()
    backend = torch.distributed.get_backend()
    rank = distributed.process_index()
    result = {"route": f"{backend}, {torch.cuda.device_count()} card(s)", "device": str(device)}
    disp_net, pose_net, batch = two_rank_inputs(seed, SPATIAL_CHECK_SHAPE)
    optimizer = make_optimizer(disp_net, pose_net)
    step = make_train_step(disp_net, pose_net, optimizer, device=device, precision="fp32")
    distributed.replicate(disp_net, pose_net, optimizer)
    zero_launches()
    result["metrics"] = {k: v.item() for k, v in step(spatial_local(batch)).items()}
    result["launches"] = read_launches()
    result["digest"] = params_digest(disp_net, pose_net)
    result["buffers"] = bn_buffers(disp_net, pose_net)
    if rank == 0:
        result["grads"] = grads_by_name(disp_net, pose_net)
    del step, optimizer, disp_net, pose_net
    torch.cuda.empty_cache()

    disp_net, pose_net = make_nets(seed)
    local = spatial_local(make_batch(np.random.RandomState(seed)))
    optimizer = make_optimizer(disp_net, pose_net)
    # Built and replicated before the peak's baseline, as the one-process
    # step is: both peaks count the step's own memory, not the weights.
    step = make_train_step(disp_net, pose_net, optimizer, device=device)
    distributed.replicate(disp_net, pose_net, optimizer)
    before = dict(distributed.spatial_collectives)
    zero_launches()
    result["bf16_first"], result["bf16_peak_gib"] = spatial_peak_gib(
        device, lambda: {k: v.item() for k, v in step(local).items()})
    result["bf16_launches"] = read_launches()
    result["collectives_per_step"] = {
        k: v - before[k] for k, v in distributed.spatial_collectives.items()}
    result["bf16_step_ms"] = host_ms(lambda: step(local), SPATIAL_TIMED_STEPS)
    faulthandler.cancel_dump_traceback_later()
    return result


def spatial_check_phase(seed: int, per_step: dict, smi: str) -> dict:
    """(1) fp32 and (2) bf16 width-sharded steps against one process."""
    # The references first: one process, the global batches, this card.
    disp_net, pose_net, batch = two_rank_inputs(seed, SPATIAL_CHECK_SHAPE)
    step = make_train_step(disp_net, pose_net, make_optimizer(disp_net, pose_net),
                           device=DEVICE, precision="fp32")
    want = {k: v.item() for k, v in step(batch).items()}
    want_grads = grads_by_name(disp_net, pose_net)
    want_buffers = bn_buffers(disp_net, pose_net)
    del step, disp_net, pose_net
    torch.cuda.empty_cache()
    disp_net, pose_net = make_nets(seed)
    bf16_batch = make_batch(np.random.RandomState(seed))
    step = make_train_step(disp_net, pose_net, make_optimizer(disp_net, pose_net),
                           device=DEVICE)
    want_bf16, one_peak = spatial_peak_gib(
        DEVICE, lambda: {k: v.item() for k, v in step(bf16_batch).items()})
    one_ms = host_ms(lambda: step(bf16_batch), SPATIAL_TIMED_STEPS)
    del step, disp_net, pose_net
    torch.cuda.empty_cache()

    results = distributed.run_processes(spatial_rank, SPATIAL_SHARDS, DEVICE, args=(seed,),
                                        timeout=DIST_WORKER_TIMEOUT,
                                        spatial_shards=SPATIAL_SHARDS)
    log(f"[spatial] {SPATIAL_SHARDS} width shards: {results[0]['route']} on "
        + ", ".join(r["device"] for r in results))
    check_ranks(results, per_step, want, want_grads, want_buffers, "width shards'")
    for r, res in enumerate(results):
        if res["bf16_launches"] != per_step:
            raise AssertionError(f"rank {r} bf16 launches {res['bf16_launches']}, "
                                 f"expected {per_step}")
        rels = {k: abs(res["bf16_first"][k] - want_bf16[k]) / max(abs(want_bf16[k]), 1e-12)
                for k in METRICS}
        log(f"  rank {r} bf16 B{B} N{N} {W}x{H} first step's losses {res['bf16_first']} against "
            f"one process {want_bf16}: max rel {max(rels.values()):.2e} "
            f"(tol {DIST_FIRST_STEP_RTOL:.0e})")
        if not max(rels.values()) <= DIST_FIRST_STEP_RTOL:
            raise AssertionError(f"rank {r} bf16 first step {res['bf16_first']} vs {want_bf16}")
        share = res["bf16_peak_gib"] / one_peak
        log(f"  rank {r} peak device memory of the bf16 step {res['bf16_peak_gib']:.3f} GiB "
            f"against one process's {one_peak:.3f} GiB: {share:.3f} (at most "
            f"{SPATIAL_MEMORY_SHARE}) | {smi}")
        if not share <= SPATIAL_MEMORY_SHARE:
            raise AssertionError(f"rank {r} keeps {share:.3f} of one process's peak memory: "
                                 "an activation at full width")
    log(f"[spatial] bf16 step (host clock, median of {SPATIAL_TIMED_STEPS}, each ending in "
        f"synchronize) | {smi}: one process {one_ms:.2f} ms, width shards "
        + ", ".join(f"{res['bf16_step_ms']:.2f}" for res in results) + f" ms ({results[0]['route']})"
        f"; spatial collectives per step (calls on the host): "
        f"{results[0]['collectives_per_step']}")
    return {"spatial_fp32_rank0": results[0]["launches"],
            "spatial_bf16_rank0": results[0]["bf16_launches"]}


def spatial_cli_rank(device: torch.device, root: str, argv: list) -> dict:
    """One process of the train CLI under torchrun's environment (the CLI
    joins the group itself): its exit code and launches."""
    faulthandler.dump_traceback_later(DIST_STACK_DUMP_S, exit=True)
    os.chdir(root)
    zero_launches()
    code = train_cli.main(argv)
    faulthandler.cancel_dump_traceback_later()
    return {"code": code, "launches": read_launches()}


def spatial_phase(seed: int, smi: str, per_step: dict, per_validation: dict) -> dict:
    """(1)-(2) the width-sharded steps against one process; (3) the train CLI
    with ``--distributed --spatial-shards 2`` under torchrun's environment
    on phase 6's packed dataset (written again from ``--seed``), and with
    ``--fused-steps`` where each rank has a card; (4) the data x spatial dry
    run; (5) the wall time."""
    t_phase = time.perf_counter()
    by_path = spatial_check_phase(seed + 3, per_step, smi)

    root = os.path.abspath(os.path.join(SPATIAL_DIR, "trainer"))
    shutil.rmtree(root, ignore_errors=True)
    write_packed_dataset(root, seed)
    runs = [("spatial", "smoke_spatial", ())]
    if torch.cuda.device_count() >= SPATIAL_SHARDS:
        runs.append(("spatial_fused", "smoke_spatial_fused",
                     ("--fused-steps", str(SPATIAL_CLI_FUSED_K))))
    else:
        log(f"[spatial] one card: the CLI refuses --fused-steps over ranks that share it "
            "(gloo, which a CUDA graph cannot capture)")
    want = {k: SPATIAL_CLI_EPOCH_SIZE * per_step[k] + per_validation[k] for k in WRAPPERS}
    for path, name, extra in runs:
        argv = [root, "--name", name, "--packed", "--device-augment", "--with-pretrain", "0",
                "-b", str(B), "--sequence-length", str(1 + N), "--with-auto-mask", "1",
                "--epochs", "1", "--epoch-size", str(SPATIAL_CLI_EPOCH_SIZE),
                "--val-batches", "1", "--no-tensorboard", "--log-style", "line",
                "--seed", str(seed), "--distributed", "--spatial-shards",
                str(SPATIAL_SHARDS), *extra]
        t = time.perf_counter()
        ranks = distributed.run_processes(spatial_cli_rank, SPATIAL_SHARDS, DEVICE,
                                          args=(root, argv), timeout=DIST_WORKER_TIMEOUT,
                                          join=False)
        wall = time.perf_counter() - t
        if any(r["code"] != 0 for r in ranks):
            raise AssertionError(f"{path}: exit codes {[r['code'] for r in ranks]}")
        (save,) = glob.glob(os.path.join(root, "checkpoints", name, "*"))
        rows = read_rows(os.path.join(save, "progress_log_full.csv"))
        if len(rows) != SPATIAL_CLI_EPOCH_SIZE or not all(
                np.isfinite(float(v)) for r in rows for v in r):
            raise AssertionError(f"{path} progress_log_full.csv: {rows}")
        for prefix, net in (("dispnet", DispNet(18)), ("exp_pose", PoseNet(18))):
            net.load_state_dict(load_torch_state_dict(
                os.path.join(save, f"{prefix}_model_best.pth.tar")))
        for r, res in enumerate(ranks):
            if res["launches"] != want:
                raise AssertionError(f"{path} rank {r} launches {res['launches']}, "
                                     f"expected {want}")
        by_path[path] = ranks[0]["launches"]
        log(f"[spatial] train CLI {' '.join(argv[1:])}: {len(rows)} finite loss rows "
            f"({[round(float(r[0]), 5) for r in rows]}), weights load; launches per rank "
            f"{ranks[0]['launches']}; {wall:.1f} s for the two processes | {smi}")
    shutil.rmtree(root, ignore_errors=True)

    n = max(2, torch.cuda.device_count() // 2 * 2)
    t = time.perf_counter()
    loss = graft_entry.dryrun_data_spatial(n)
    log(f"[spatial] graft_entry.dryrun_data_spatial({n}) in {time.perf_counter() - t:.1f} s: "
        f"loss {loss}")
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun_data_spatial({n}): loss {loss}")
    log(f"[spatial] phase {time.perf_counter() - t_phase:.1f} s | {smi}")
    return by_path


# The scripts phase: both parity runbooks of the port's scripts/ in their
# SMOKE=1 mode on the card, each `python -m` step through a shim that counts
# its kernel launches (`chip_smoke.py --count-launches`).
SCRIPTS_DIR = os.path.join("build", "chip_smoke_scripts")
RUNBOOKS = (("kitti_parity_runbook.sh", {"depth_frames": 4, "vo_frames": 12}),
            ("nyu_parity_runbook.sh", {"depth_frames": 4}))
SCRIPTS_TIMEOUT = 400  # s, each runbook


def count_launches_main(argv) -> int:
    """``chip_smoke.py --count-launches DIR -m MODULE ARG...``: ``python -m
    MODULE ARG...``, then the kernel launches it made, written to
    ``DIR/<pid>.json``; its exit code."""
    import runpy

    out_dir, flag, module = argv[:3]
    if flag != "-m":
        raise SystemExit("--count-launches DIR -m MODULE [ARG ...]")
    sys.argv = [module] + list(argv[3:])
    code = 0
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    except SystemExit as exc:
        code = exc.code if isinstance(exc.code, int) else (0 if exc.code is None else 1)
    finally:
        with open(os.path.join(out_dir, f"{os.getpid()}.json"), "w") as f:
            json.dump({"module": module,
                       "launches": {k: fn.launches for k, fn in WRAPPERS.items()}}, f)
    return code


def run_runbook(name: str, scripts: str, shim_dir: str, root: str):
    """One runbook, SMOKE=1 on the card, its lines logged as they come:
    (exit code, its output, [(step, wall s)], wall s, work directory)."""
    tag = name.split("_")[0]
    work = os.path.join(root, tag)
    env = dict(os.environ, SMOKE="1", DEVICE=DEVICE, WORK=work,
               PATH=f"{shim_dir}:{os.environ['PATH']}")
    t0 = last = time.perf_counter()
    steps, out = [], []
    proc = subprocess.Popen(["bash", os.path.join(scripts, name)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    timer = threading.Timer(SCRIPTS_TIMEOUT, proc.kill)
    timer.start()
    try:
        for line in proc.stdout:
            line = line.rstrip().replace("\r", " ")
            out.append(line)
            if line.startswith("== ["):
                now = time.perf_counter()
                if steps:
                    steps[-1][1] = now - last
                steps.append([line.strip("= "), None])
                last = now
            log(f"  [scripts {tag}] {line}")
        code = proc.wait()
    finally:
        timer.cancel()
    if steps:
        steps[-1][1] = time.perf_counter() - last
    return code, "\n".join(out), steps, time.perf_counter() - t0, work


def scripts_phase(smi: str) -> dict:
    """Both runbooks, SMOKE=1 on the card, side by side: every step's exit
    code (the runbooks stop at the first failure), their artifacts, each
    step's wall time and the launches of all their processes."""
    t_phase = time.perf_counter()
    root = os.path.abspath(SCRIPTS_DIR)
    shutil.rmtree(root, ignore_errors=True)
    shim_dir, counts = os.path.join(root, "bin"), os.path.join(root, "launches")
    os.makedirs(shim_dir)
    os.makedirs(counts)
    shim = os.path.join(shim_dir, "python")
    with open(shim, "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "{os.path.abspath(__file__)}" '
                f'--count-launches "{counts}" "$@"\n')
    os.chmod(shim, 0o755)
    scripts = os.path.join(os.path.dirname(os.path.abspath(train_cli.__file__)), "scripts")
    with ThreadPoolExecutor(len(RUNBOOKS)) as pool:
        runs = [pool.submit(run_runbook, name, scripts, shim_dir, root) for name, _ in RUNBOOKS]
        runs = [r.result() for r in runs]
    for (name, expect), (code, text, steps, wall, work) in zip(RUNBOOKS, runs):
        if code != 0 or "COMPLETE" not in text:
            raise AssertionError(f"{name} exited {code}")
        results = os.path.join(work, "results")
        pred = np.load(os.path.join(results, "predictions.npy"))
        if pred.shape[0] != expect["depth_frames"] or not np.all(np.isfinite(pred)):
            raise AssertionError(f"{name}: predictions.npy {pred.shape}, finite "
                                 f"{np.isfinite(pred).all()}")
        depth_metrics = [float(v) for v in re.findall(NUMBER, text.split(" a3 |")[-1]
                                                    .splitlines()[1])]
        if len(depth_metrics) < 6 or not np.all(np.isfinite(depth_metrics)):
            raise AssertionError(f"{name}: eval_depth's metrics {depth_metrics}")
        checked = f"predictions.npy {list(pred.shape)} finite, eval_depth {depth_metrics}"
        if "vo_frames" in expect:
            poses = np.loadtxt(os.path.join(results, "vo", "09.txt"))
            if poses.shape != (expect["vo_frames"], 12) or not np.all(np.isfinite(poses)):
                raise AssertionError(f"{name}: 09.txt {poses.shape}")
            errors = [float(printed(text, k)[-1]) for k in
                      ("Translational error", "Rotational error", "ATE", "RPE (m)",
                       "RPE (deg)")]
            if not np.all(np.isfinite(errors)):
                raise AssertionError(f"{name}: eval_odom's errors {errors}")
            checked += f", 09.txt {list(poses.shape)}, eval_odom {errors}"
        log(f"[scripts] {name} exit 0 in {wall:.1f} s | {smi}: {checked}; "
            "steps (wall s): " + ", ".join(f"{s} {t:.1f}" for s, t in steps))
    launches = {k: 0 for k in WRAPPERS}
    modules = []
    for path in glob.glob(os.path.join(counts, "*.json")):
        with open(path) as f:
            rec = json.load(f)
        modules.append(rec["module"].rsplit(".", 1)[-1])
        for k, v in rec["launches"].items():
            launches[k] += v
    log(f"[scripts] launches over the runbooks' {len(modules)} processes "
        f"({', '.join(sorted(modules))}): {launches}")
    if unlaunched(launches):
        raise AssertionError(f"a kernel did not launch in the runbooks (or the cost volume "
                             f"did): {launches}")
    shutil.rmtree(root, ignore_errors=True)
    log(f"[scripts] phase {time.perf_counter() - t_phase:.1f} s (the two runbooks side by side) "
        f"| {smi}")
    return {"scripts": launches}


# The eval phase: the evaluation and inference CLIs at full width (ResNet-18,
# 832x256: scripts/test_kitti_depth.sh, test_kitti_vo.sh, test_kitti_pose.sh)
# on PNGs written from --seed, each frame with one of the five row filters: a
# KITTI-raw-shaped depth set with sparse ground truth and a KITTI-odometry-
# shaped sequence 09 (a camera panning over a texture) with its poses.
EVAL_DIR = os.path.join("build", "chip_smoke_eval")
DEPTH_FRAMES, DEPTH_HW = 16, (375, 1242)
ODOM_FRAMES, ODOM_HW = 60, (376, 1241)
ODOM_STEP_M, ODOM_YAW = 2.0, 0.004   # per frame: 118 m in all, so a 100 m segment exists
EVAL_CHECK_FRAMES = 4   # test_disp frames held against the CPU
VO_CHECK_FRAMES = 9     # test_vo frames held against the CPU
EVAL_DEPTH_RTOL = 1e-3  # fp32 depth, card against CPU, max rel
EVAL_TRAJ_TOL = 1e-4    # fp32 trajectory, card against CPU, of max|ref|
ODOM_SELF_TOL = 1e-6    # eval_odom of the ground truth against itself
NUMBER = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?|nan|inf"


def odometry_poses() -> np.ndarray:
    """``[ODOM_FRAMES, 12]`` KITTI rows: ODOM_STEP_M forward per frame,
    turning by ODOM_YAW about the vertical axis."""
    rows, position = [], np.zeros(3)
    for i in range(ODOM_FRAMES):
        yaw = ODOM_YAW * i
        rot = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
        rows.append(np.concatenate([rot, position[:, None]], axis=1).reshape(-1))
        position = position + ODOM_STEP_M * rot[:, 2]
    return np.stack(rows)


def write_eval_data(root: str, seed: int) -> dict:
    """The depth set, its ground truth, the odometry sequence, its poses and
    the two networks' ``.pth.tar``; returns their paths."""
    rng = np.random.RandomState(seed)
    paths = {"depth": os.path.join(root, "depth"), "gt": os.path.join(root, "depth_gt"),
             "odom": os.path.join(root, "odom"),
             "seq": os.path.join(root, "odom", "sequences", "09", "image_2"),
             "poses": os.path.join(root, "odom", "poses"),
             "disp": os.path.join(root, "dispnet_model_best.pth.tar"),
             "pose": os.path.join(root, "exp_pose_model_best.pth.tar")}
    for key in ("depth", "gt", "seq", "poses"):
        os.makedirs(paths[key])
    jobs = []
    h, w = DEPTH_HW
    for i in range(DEPTH_FRAMES):
        jobs.append((os.path.join(paths["depth"], f"{i:010d}.png"), noise_texture(rng, h, w),
                     i % len(FILTERS)))
        # far at the top, near at the bottom, 5% of the pixels valid (LiDAR)
        gt = (80 - 75 * np.linspace(0, 1, h)[:, None]) * (1 + 0.1 * rng.rand(h, w))
        gt[rng.rand(h, w) > 0.05] = 0
        np.save(os.path.join(paths["gt"], f"{i:010d}.npy"), gt.astype(np.float32))
    h, w = ODOM_HW
    pan = noise_texture(rng, h, w + 2 * ODOM_FRAMES)
    for i in range(ODOM_FRAMES):
        jobs.append((os.path.join(paths["seq"], f"{i:06d}.png"), pan[:, 2 * i:2 * i + w],
                     i % len(FILTERS)))
    with ThreadPoolExecutor(8) as pool:  # zlib releases the GIL
        list(pool.map(lambda job: write_png(*job), jobs))
    np.savetxt(os.path.join(paths["poses"], "09.txt"), odometry_poses(), fmt="%.12e")
    disp_net, pose_net = make_nets(seed + 11)
    save_torch_checkpoint(disp_net.state_dict(), paths["disp"])
    save_torch_checkpoint(pose_net.state_dict(), paths["pose"])
    return paths


def run_eval_cli(module, argv, label: str):
    """``run_main`` of an eval CLI: (its printed output, wall seconds,
    launches); it must exit 0 and launch none of the losses' kernels and
    no backward; the decoder-input kernel ``DECODER_INPUTS`` times a DispNet
    forward where the CLI runs DispNet on the card (``test_disp``,
    ``run_inference``), else never."""
    code, text, secs, launches = run_main(module, argv, label)
    if code != 0:
        raise AssertionError(f"{label} exited {code}")
    decoder = launches["decoder_input"]
    dispnet = module in (test_disp, run_inference) and "cpu" not in argv
    if (any(v for k, v in launches.items() if k != "decoder_input")
            or decoder % DECODER_INPUTS or (decoder > 0) != dispnet):
        raise AssertionError(f"{label} launched {launches}")
    return text, secs, launches


def with_depth_validation(want: dict, launches: dict) -> dict:
    """``want`` of a train CLI's steps and photometric validations, with
    its ``--with-gt`` validation added: DispNet's forward alone (and, with
    ``--log-output``, the logged images' inference), ``DECODER_INPUTS``
    decoder-input launches each. Their number is the validation set's, read
    from ``launches``: a positive whole number of forwards, else ``want``
    unchanged (and the comparison fails)."""
    extra = launches["decoder_input"] - want["decoder_input"]
    if extra <= 0 or extra % DECODER_INPUTS:
        return want
    return {**want, "decoder_input": launches["decoder_input"]}


def run_main(module, argv, label: str):
    """``module.main(argv)`` with the launch counts at 0 just before it:
    (its exit code, its printed output, wall seconds, launches); its lines
    are printed after it ends."""
    out = io.StringIO()
    zero_launches()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = module.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = read_launches()
    for line in out.getvalue().splitlines():
        if line.strip():
            log(f"  [{label}] {line.strip()}")
    return code, out.getvalue(), secs, launches


def printed(text: str, prefix: str) -> np.ndarray:
    """The numbers of the last printed line that starts with ``prefix``,
    all finite."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip().startswith(prefix)]
    if not lines:
        raise AssertionError(f"no printed line starts with {prefix!r}")
    values = np.array([float(v) for v in re.findall(NUMBER, lines[-1][len(prefix):])])
    if not values.size or not np.isfinite(values).all():
        raise AssertionError(f"{prefix!r}: {lines[-1]}")
    return values


def expect_files(paths) -> None:
    missing = [p for p in paths if not os.path.isfile(p)]
    if missing:
        raise AssertionError(f"missing outputs: {missing}")


def eval_phase(seed: int, smi: str) -> dict:
    """The six evaluation and inference CLIs on the card; each one's
    launches (all 0), its outputs and printed metrics, the card against the
    CPU, bf16 against fp32 and the times."""
    t_phase = time.perf_counter()
    root = os.path.abspath(EVAL_DIR)
    shutil.rmtree(root, ignore_errors=True)
    paths = write_eval_data(root, seed)
    log(f"[eval] wrote {DEPTH_FRAMES} depth frames at {DEPTH_HW[1]}x{DEPTH_HW[0]} and "
        f"{ODOM_FRAMES} odometry frames at {ODOM_HW[1]}x{ODOM_HW[0]} (row filters by frame: "
        f"{', '.join(FILTERS)}), ground truth and networks in {time.perf_counter() - t_phase:.2f} s")
    depth_files = sorted(glob.glob(os.path.join(paths["depth"], "*.png")))
    decode_ms = {}
    for k, name in enumerate(FILTERS):
        times = []
        for _ in range(3):
            t = time.perf_counter()
            img = read_png(depth_files[k])
            times.append((time.perf_counter() - t) * 1e3)
        if img.shape != DEPTH_HW + (3,):
            raise AssertionError(f"read_png {depth_files[k]}: shape {img.shape}")
        decode_ms[name] = float(np.median(times))
    log(f"[eval] read_png ms per {DEPTH_HW[1]}x{DEPTH_HW[0]} frame by row filter (median of 3, "
        f"host clock) | {smi}: {decode_ms}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by earlier phases
    by_path, out = {}, lambda name: os.path.join(root, name)

    # test_disp: bf16 (the default), fp32 on the card, fp32 on the CPU.
    disp_args = ["--pretrained-dispnet", paths["disp"], "--resnet-layers", "18",
                 "--dataset-dir", paths["depth"]]
    text, secs, by_path["test_disp"] = run_eval_cli(
        test_disp, disp_args + ["--output-dir", out("disp_bf16"), "--batch-size", "8"],
        "test_disp")
    avg_s, fps = printed(text, "Avg Time:")[0], printed(text, "Avg Speed:")[0]
    bf16 = np.load(out("disp_bf16/predictions.npy"))
    decode_s = sum(decode_ms[FILTERS[i % len(FILTERS)]] for i in range(DEPTH_FRAMES)) / 1e3
    log(f"[eval] test_disp bf16 (batch 8, {DEPTH_FRAMES} frames) | {smi}: Avg Time "
        f"{avg_s * 1e3:.4f} ms per frame, {fps:.2f} fps (inference and the copy back, batches "
        f"after the first); the CLI's wall time {secs * 1e3 / DEPTH_FRAMES:.2f} ms per frame "
        f"(network set-up, decode, resize, the first batch's warm-up), of which read_png's "
        f"share {decode_s / secs:.3f} (its times above)")
    run_eval_cli(test_disp, disp_args + ["--output-dir", out("disp_fp32"), "--batch-size", "8",
                                         "--precision", "fp32"], "test_disp fp32")
    check_list = out("check_frames.txt")
    with open(check_list, "w") as f:
        f.write("\n".join(depth_files[:EVAL_CHECK_FRAMES]) + "\n")
    run_eval_cli(test_disp, ["--pretrained-dispnet", paths["disp"], "--resnet-layers", "18",
                             "--dataset-list", check_list, "--output-dir", out("disp_cpu"),
                             "--batch-size", str(EVAL_CHECK_FRAMES), "--device", "cpu",
                             "--precision", "fp32"], "test_disp cpu")
    fp32 = np.load(out("disp_fp32/predictions.npy"))
    cpu = np.load(out("disp_cpu/predictions.npy"))
    for name, a in (("bf16", bf16), ("fp32", fp32)):
        if a.shape != (DEPTH_FRAMES, H, W) or not (np.isfinite(a).all() and (a > 0).all()):
            raise AssertionError(f"test_disp {name} predictions: {a.shape}, finite and > 0 "
                                 "expected")
    rel = float(np.max(np.abs(fp32[:EVAL_CHECK_FRAMES] - cpu) / cpu))
    log(f"[eval] test_disp fp32 depth, card against the CPU, first {EVAL_CHECK_FRAMES} frames: "
        f"max rel {rel:.3e} (tol {EVAL_DEPTH_RTOL:.0e})")
    if not rel <= EVAL_DEPTH_RTOL:
        raise AssertionError(f"test_disp fp32 card vs CPU: max rel {rel:.3e}")
    bf_rel = np.abs(bf16 - fp32) / fp32
    log(f"[eval] test_disp bf16 against fp32 on the card (reported, not a gate): max rel "
        f"{bf_rel.max():.3e}, median rel {np.median(bf_rel):.3e}")

    text, _, by_path["eval_depth"] = run_eval_cli(
        eval_depth, ["--dataset", "kitti", "--pred_depth", out("disp_bf16/predictions.npy"),
                     "--gt_depth", paths["gt"]], "eval_depth")
    if printed(text, "&").size != 7:
        raise AssertionError("eval_depth: 7 KITTI metrics expected")
    printed(text, "Scaling ratios | med:")

    viz_list = out("viz_frames.txt")
    with open(viz_list, "w") as f:
        f.write("\n".join(os.path.basename(p) for p in depth_files[:4]) + "\n")
    _, _, by_path["run_inference"] = run_eval_cli(
        run_inference, ["--pretrained", paths["disp"], "--resnet-layers", "18",
                        "--dataset-dir", paths["depth"], "--dataset-list", viz_list,
                        "--output-dir", out("viz"), "--output-disp", "--output-depth"],
        "run_inference")
    written = [out(f"viz/{os.path.basename(p)[:-4]}_{kind}.png") for p in depth_files[:4]
               for kind in ("disp", "depth")]
    expect_files(written)
    for path in written:
        if read_png(path).shape != (H, W, 3):
            raise AssertionError(f"run_inference {path}: shape {read_png(path).shape}")

    vo_args = ["--pretrained-posenet", paths["pose"], "--sequence", "09"]
    text, secs, by_path["test_vo"] = run_eval_cli(
        test_vo, vo_args + ["--dataset-dir", os.path.join(paths["odom"], "sequences"),
                            "--output-dir", out("vo"), "--batch-size", "16"], "test_vo")
    traj = np.loadtxt(out("vo/09.txt"))
    if traj.shape != (ODOM_FRAMES, 12) or not np.isfinite(traj).all():
        raise AssertionError(f"test_vo trajectory {traj.shape}")
    log(f"[eval] test_vo bf16 (batch 16) | {smi}: {(ODOM_FRAMES - 1) / secs:.2f} pairs/s over "
        f"the CLI's wall time, network set-up and decode included ({secs:.3f} s for "
        f"{ODOM_FRAMES - 1} pairs)")
    few = os.path.join(root, "vo_few", "09", "image_2")
    os.makedirs(few)
    for p in sorted(glob.glob(os.path.join(paths["seq"], "*.png")))[:VO_CHECK_FRAMES]:
        os.symlink(p, os.path.join(few, os.path.basename(p)))
    few_args = vo_args + ["--dataset-dir", os.path.dirname(os.path.dirname(few)),
                          "--precision", "fp32"]
    run_eval_cli(test_vo, few_args + ["--output-dir", out("vo_card"), "--batch-size", "16"],
                 "test_vo fp32")
    run_eval_cli(test_vo, few_args + ["--output-dir", out("vo_cpu"), "--device", "cpu",
                                      "--batch-size", str(VO_CHECK_FRAMES - 1)], "test_vo cpu")
    card, ref = np.loadtxt(out("vo_card/09.txt")), np.loadtxt(out("vo_cpu/09.txt"))
    err = float(np.abs(card - ref).max() / np.abs(ref).max())
    log(f"[eval] test_vo fp32 trajectory, card against the CPU, first {VO_CHECK_FRAMES} frames: "
        f"max|err| / max|ref| {err:.3e} (tol {EVAL_TRAJ_TOL:.0e})")
    if card.shape != ref.shape or not err <= EVAL_TRAJ_TOL:
        raise AssertionError(f"test_vo fp32 card vs CPU: {err:.3e}")

    odom_args = ["--gt_dir", paths["poses"], "--align", "7dof", "--seqs", "9", "--no-plot",
                 "--no-confirm"]
    text, _, by_path["eval_odom"] = run_eval_cli(eval_odom, ["--result", out("vo")] + odom_args,
                                                 "eval_odom")
    for prefix in ("Translational error (%):", "Rotational error (deg/100m):", "ATE (m):",
                   "RPE (m):", "RPE (deg):"):
        printed(text, prefix)
    expect_files([out("vo/result.txt"), out("vo/errors/09.txt")])
    if not open(out("vo/errors/09.txt")).read().strip():
        raise AssertionError("eval_odom: no 100 m segment was evaluated")
    os.makedirs(out("gt_as_result"))
    shutil.copy(os.path.join(paths["poses"], "09.txt"), out("gt_as_result/09.txt"))
    text, _, _ = run_eval_cli(eval_odom, ["--result", out("gt_as_result")] + odom_args,
                              "eval_odom gt")
    t_err, ate = printed(text, "Translational error (%):")[0], printed(text, "ATE (m):")[0]
    log(f"[eval] eval_odom of the ground truth against itself: t_err {t_err:.3e} %, ATE "
        f"{ate:.3e} m (tol {ODOM_SELF_TOL:.0e})")
    if not (t_err < ODOM_SELF_TOL and ate < ODOM_SELF_TOL):
        raise AssertionError(f"eval_odom self-evaluation: t_err {t_err}, ATE {ate}")

    text, secs, by_path["test_pose"] = run_eval_cli(
        test_pose, [paths["pose"], "--dataset-dir", paths["odom"], "--sequences", "09",
                    "--output-dir", out("pose")], "test_pose")
    printed(text, "mean")
    printed(text, "std")
    snippets = np.load(out("pose/predictions.npy"))
    if snippets.shape != (ODOM_FRAMES - 4, 5, 3, 4) or not np.isfinite(snippets).all():
        raise AssertionError(f"test_pose predictions {snippets.shape}")
    log(f"[eval] test_pose bf16 | {smi}: {snippets.shape[0]} snippets in {secs:.3f} s of the "
        f"CLI's wall time ({snippets.shape[0] / secs:.2f} snippets/s, each frame decoded once)")
    log(f"[eval] peak device memory of the eval CLIs "
        f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB that earlier phases hold | {smi}; launches of the four "
        f"kernels on every eval path: 0; phase {time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    return by_path


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


def graph_check(seed: int, rng: np.random.RandomState, remat: bool, layers: int = 18):
    """fp32 K = GRAPH_K graphed steps through GRAPH_CALLS calls (warm-up,
    capture and replay, replay), each call against K eager steps on a deep
    copy of the same nets and optimizer put in the graph's state before the
    call, with the same uint8 batches and augmentation draws, beside
    NOISE_COPIES more eager copies that measure the eager step's own
    run-to-run noise; DispNet of ``layers``. Returns the graphed step, a
    batch for it, and the failures."""
    nets = make_nets(seed, layers)
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


def graphed_bf16(tag: str, nets, k: int, seed: int, rng: np.random.RandomState,
                 cfg: LossConfig = LossConfig()):
    """bf16 ``make_train_step(fused_steps=k)`` of ``nets`` with the device
    augmentation on uint8 frames: the warm-up and the capture calls' host
    times, the device time per optimizer step of the replays, the host time
    of a call that waits for its result, and peak memory. Returns them and
    the launches of all its calls, with their number of optimizer steps."""
    for net in nets:
        net.to(DEVICE)
    step = make_train_step(*nets, make_optimizer(*nets, lr=LR, capturable=True), cfg,
                           device=DEVICE, augment_fn=device_augment.make_device_augment(
                               device_augment.AugmentConfig()),
                           aug_seed=seed, fused_steps=k)
    group = stacked_uint8(rng, k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    calls = []
    for _ in range(2):  # the warm-up, then the capture and its first replay
        t = time.perf_counter()
        losses = step(group)["loss"].tolist()
        calls.append((time.perf_counter() - t) * 1e3)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"bf16 graphed losses {losses}")
    times = {"warmup_call_ms": calls[0], "capture_call_ms": calls[1],
             "graph_device_ms_per_step": cuda_ms(lambda: step(group), 4, warmup=1) / k,
             "graph_call_host_ms_per_step": host_ms(lambda: step(group), 5) / k,
             "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    launches = read_launches()
    n_steps = (2 + (1 + 4) + (1 + 5)) * k
    log(f"[{tag}] bf16 K={k} (device augmentation on uint8): {times} (device ms: CUDA events "
        "around back-to-back calls, each a replay and its input copies; host ms: host clock "
        "around a call that ends in synchronize)")
    del step, group
    torch.cuda.empty_cache()
    return times, launches, n_steps


def graph_phase(seed: int, rng: np.random.RandomState, per_step: dict,
                eager_device_ms: float) -> dict:
    """The train step as CUDA-graph replays of K steps: fp32 against eager
    steps (plain and ``remat``), launches over replays, and bf16 K =
    CLI_FUSED_K's times and memory. Returns the replays' launches, the
    checks' failures and the bf16 graph's device ms per step."""
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

    times = graphed_bf16("graph", make_nets(seed + 13), CLI_FUSED_K, seed, rng)[0]
    log(f"[graph] the eager step's device time (the train phase's graph of one step, without "
        f"augmentation): {eager_device_ms:.4f} ms")
    return launches, failures, times["graph_device_ms_per_step"]


# The prepare phase: the user's path from raw recordings
# (scripts/run_prepare_data.sh) on trees written from --seed at the datasets'
# sizes: KITTI raw (tools/make_smoke_kitti.py::make_kitti_raw: two drives of
# 24 frames at 1242x375 with KITTI's calibration and 120,000-point scans, a
# test drive), a KITTI-odometry sequence at 1241x376 and a Cityscapes city at
# 2048x1024; the port's prepare_train_data on the card at the scripts' flags,
# the train CLI from the JPEG tree it writes, and the packer.
PREP_DIR = os.path.join("build", "chip_smoke_prepare")
PREP_FRAMES, PREP_POINTS = 24, 120_000   # per KITTI drive and camera; per scan
PREP_ODOM_FRAMES, PREP_ODOM_HW = 12, (376, 1241)
PREP_CITY_FRAMES, PREP_CITY_HW = 8, (1024, 2048)
PREP_FORMATS = (  # name, the script's flags (scripts/run_prepare_data.sh)
    ("kitti_raw", ["--dataset-format", "kitti_raw", "--width", "832", "--height", "256",
                   "--with-depth", "--with-pose", "--static-frames", "data/static_frames.txt",
                   "--test-scenes", "data/test_scenes.txt"]),
    ("kitti_odom", ["--dataset-format", "kitti_odom", "--width", "832", "--height", "256"]),
    ("cityscapes", ["--dataset-format", "cityscapes", "--width", "832", "--height", "342"]),
)
PREP_THREADS = 8
# The written JPEGs (quality 75) against the frames they encode: these
# frames carry +-4 levels of noise on every pixel, which quality 75 drops
# (mean errors near 3 at 832x256 and 5.5 for Cityscapes, max near 60).
JPEG_TRIP_MEAN, JPEG_TRIP_MAX = 8.0, 80
PREP_RESIZE_TOL = 1      # grey levels, the card's uint8 resize against the CPU's
ODOM_CALIB = (  # KITTI odometry sequence 00's calib.txt
    "P0: 7.188560e+02 0 6.071928e+02 0 0 7.188560e+02 1.852157e+02 0 0 0 1 0",
    "P1: 7.188560e+02 0 6.071928e+02 -3.861448e+02 0 7.188560e+02 1.852157e+02 0 0 0 1 0",
    "P2: 7.188560e+02 0 6.071928e+02 4.538225e+01 0 7.188560e+02 1.852157e+02 -1.130887e-01 "
    "0 0 1 3.779761e-03",
    "P3: 7.188560e+02 0 6.071928e+02 -3.372877e+02 0 7.188560e+02 1.852157e+02 2.369057e+00 "
    "0 0 1 4.915215e-03")
CITY_CAMERA = {"fx": 2262.52, "fy": 2265.3017905988554, "u0": 1096.98, "v0": 513.137}


def write_prepare_data(root: str, seed: int) -> dict:
    """The three raw trees; returns their roots."""
    rng = np.random.RandomState(seed + 21)
    raw = {name: os.path.join(root, "raw", name) for name, _ in PREP_FORMATS}
    make_smoke_kitti.make_kitti_raw(raw["kitti_raw"], 375, 1242, PREP_FRAMES, PREP_POINTS,
                                    seed)
    jobs = []
    h, w = PREP_ODOM_HW
    for seq, n in (("00", PREP_ODOM_FRAMES), ("09", 3)):  # 09 is a test sequence
        sdir = os.path.join(raw["kitti_odom"], "sequences", seq)
        for cid in ("2", "3"):
            os.makedirs(os.path.join(sdir, f"image_{cid}"))
            for i, frame in enumerate(make_smoke_kitti._panning_frames(rng, h, w, n)):
                jobs.append((os.path.join(sdir, f"image_{cid}", f"{i:06d}.png"), frame,
                             i % len(FILTERS)))
        with open(os.path.join(sdir, "calib.txt"), "w") as f:
            f.write("\n".join(ODOM_CALIB) + "\n")
    h, w = PREP_CITY_HW
    city = "aachen"
    dirs = [os.path.join(raw["cityscapes"], kind, "train", city)
            for kind in ("leftImg8bit_sequence", "camera", "vehicle_sequence")]
    for d in dirs:
        os.makedirs(d)
    for i, frame in enumerate(make_smoke_kitti._panning_frames(rng, h, w, PREP_CITY_FRAMES)):
        stem = f"{city}_000000_{10 + i:06d}"
        jobs.append((os.path.join(dirs[0], f"{stem}_leftImg8bit.png"), frame, i % len(FILTERS)))
        with open(os.path.join(dirs[1], f"{stem}_camera.json"), "w") as f:
            json.dump({"intrinsic": CITY_CAMERA}, f)
        with open(os.path.join(dirs[2], f"{stem}_vehicle.json"), "w") as f:
            json.dump({"speed": 4.0}, f)
    with ThreadPoolExecutor(8) as pool:  # zlib releases the GIL
        list(pool.map(lambda job: write_png(*job), jobs))
    return raw


class MemorySampler:
    """The card's largest ``memory.used`` (MiB, nvidia-smi) while it runs:
    the prepare workers' CUDA contexts and tensors, in other processes."""

    def __init__(self, period_s: float = 0.25):
        self.period_s, self.peak_mib, self.start_mib = period_s, 0, None
        self._stop = threading.Event()

    def _poll(self):
        while not self._stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True, timeout=30).stdout.split()
            if out:
                self.peak_mib = max(self.peak_mib, int(out[0]))
                self.start_mib = int(out[0]) if self.start_mib is None else self.start_mib
            self._stop.wait(self.period_s)

    def __enter__(self):
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)


def run_prepare(src: str, dump: str, flags, device: str, threads: int) -> dict:
    """``python -m sc_sfmlearner_release_tpu_torch.prepare_train_data`` as a
    user runs it; its ETL totals, wall seconds and the card's peak memory."""
    argv = [sys.executable, "-m", "sc_sfmlearner_release_tpu_torch.prepare_train_data", src,
            "--dump-root", dump, *flags, "--num-threads", str(threads), "--device", device]
    t = time.perf_counter()
    with MemorySampler() as mem:
        res = subprocess.run(argv, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t
    for line in (res.stdout + res.stderr).splitlines():
        if line.strip():
            log(f"  [prepare] {line.strip()}")
    if res.returncode != 0:
        raise AssertionError(f"prepare_train_data exited {res.returncode}")
    (line,) = [ln for ln in res.stdout.splitlines() if ln.startswith("ETL totals: ")]
    return {**json.loads(line[len("ETL totals: "):]), "process_wall_s": wall,
            "smi_peak_used_mib": mem.peak_mib, "smi_start_used_mib": mem.start_mib}


def tree_files(root: str) -> list:
    return sorted(os.path.relpath(p, root)
                  for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
                  if os.path.isfile(p))


def jpeg_sources(fmt: str, raw: str, dump: str):
    """(written JPEG, the PNG it was made from, rows kept) of each frame."""
    out = []
    for jpg in sorted(glob.glob(os.path.join(dump, "*", "*.jpg"))):
        scene, frame = os.path.basename(os.path.dirname(jpg)), os.path.basename(jpg)[:-4]
        if fmt == "kitti_raw":
            drive, cid = scene[:-3], scene[-2:]
            png = os.path.join(raw, drive[:10], drive, f"image_{cid}", "data", f"{frame}.png")
        elif fmt == "kitti_odom":
            seq, cid = scene.split("_")
            png = os.path.join(raw, "sequences", seq, f"image_{cid}", f"{frame}.png")
        else:
            city, scene_id = scene.split("_")[:2]
            png = os.path.join(raw, "leftImg8bit_sequence", "train", city,
                               f"{city}_{scene_id}_{frame}_leftImg8bit.png")
        out.append((jpg, png))
    return out


def prepare_phase(seed: int, smi: str, per_step: dict, packed_times: dict) -> dict:
    """The ETL on the card for the three formats, checked against a CPU run
    and against the frames it encodes; training from the JPEG tree; the
    packer; a 16-bit NYU depth PNG through ``ValidationSet``; the times."""
    t_phase = time.perf_counter()
    root = os.path.abspath(PREP_DIR)
    shutil.rmtree(root, ignore_errors=True)
    raw = write_prepare_data(root, seed)
    scan = glob.glob(os.path.join(raw["kitti_raw"], "*", "*", "velodyne_points", "data", "*"))
    log(f"[prepare] wrote KITTI raw ({len(make_smoke_kitti.KITTI_DRIVES)} drives x 2 cameras x "
        f"{PREP_FRAMES} frames at 1242x375, scans of {PREP_POINTS} points, "
        f"{os.path.getsize(scan[0]) / 1e6:.2f} MB each), KITTI odometry (sequence 00, "
        f"{PREP_ODOM_FRAMES} frames x 2 cameras at {PREP_ODOM_HW[1]}x{PREP_ODOM_HW[0]}) and "
        f"Cityscapes ({PREP_CITY_FRAMES} frames at {PREP_CITY_HW[1]}x{PREP_CITY_HW[0]}) in "
        f"{time.perf_counter() - t_phase:.2f} s")
    build_s = _build.build_host("jpeg_io")
    log(f"[prepare] JPEG codec: {jpeg_io.route()}, {_build.host_library_path('jpeg_io').name}"
        f" (g++ in {build_s:.2f} s)")

    dumps, etl = {}, {}
    for fmt, flags in PREP_FORMATS:
        dumps[fmt] = os.path.join(root, fmt)
        etl[fmt] = run_prepare(raw[fmt], dumps[fmt], flags, "cuda", PREP_THREADS)
        frames = etl[fmt]["frames"]
        if frames < 6 or not os.path.getsize(os.path.join(dumps[fmt], "train.txt")):
            raise AssertionError(f"{fmt}: {frames} frames, train.txt empty")
        stages = {k: 1e3 * etl[fmt][k] / frames for k in
                  ("png_decode", "resize", "velodyne", "encode") if k in etl[fmt]}
        log(f"[prepare] {fmt} on the card, --num-threads {PREP_THREADS}: "
            f"workers {int(etl[fmt]['workers'])}, {int(frames)} frames, wall "
            f"{etl[fmt]['wall_s']:.2f} s ({etl[fmt]['wall_s'] / frames * 1e3:.1f} ms per frame), "
            f"spawn workers' start-up {etl[fmt].get('pool_start_s', 0.0):.2f} s, process "
            f"{etl[fmt]['process_wall_s']:.2f} s; ms per frame by stage (summed over workers): "
            f"{ {k: round(v, 3) for k, v in stages.items()} }; a worker's peak allocated "
            f"{etl[fmt].get('peak_device_bytes', 0) / 2**20:.1f} MiB, the card's memory.used "
            f"{etl[fmt]['smi_start_used_mib']} MiB at the start, peak "
            f"{etl[fmt]['smi_peak_used_mib']} MiB")
    scenes = sorted(os.listdir(dumps["kitti_raw"]))
    if any(make_smoke_kitti.KITTI_TEST_DRIVE in s for s in scenes):
        raise AssertionError(f"the test drive was prepared: {scenes}")
    still = sorted(os.listdir(os.path.join(dumps["kitti_raw"],
                                           "2011_09_26_drive_0022_sync_02")))
    if still[0] != "0000000005.jpg":
        raise AssertionError(f"static frames kept: {still[:3]}")

    # The same KITTI raw tree on the CPU, in this process.
    cpu_dump = os.path.join(root, "kitti_raw_cpu")
    args = prepare_train_data.build_parser().parse_args(
        [raw["kitti_raw"], "--dump-root", cpu_dump, *PREP_FORMATS[0][1], "--num-threads", "1",
         "--device", "cpu"])
    with contextlib.redirect_stdout(io.StringIO()):
        cpu_etl = prepare_train_data.prepare(args)
    files = tree_files(dumps["kitti_raw"])
    if tree_files(cpu_dump) != files:
        raise AssertionError("the card's and the CPU's KITTI dumps hold other files")
    same_jpeg, n_npy = 0, 0
    for rel in files:
        a, b = os.path.join(dumps["kitti_raw"], rel), os.path.join(cpu_dump, rel)
        if rel.endswith(".npy"):
            if not np.array_equal(np.load(a), np.load(b)):
                raise AssertionError(f"{rel}: depth differs from the CPU's")
            n_npy += 1
        elif rel.endswith(".txt"):
            if open(a).read() != open(b).read():
                raise AssertionError(f"{rel} differs from the CPU's")
        else:
            same_jpeg += open(a, "rb").read() == open(b, "rb").read()
    n_jpeg = sum(f.endswith(".jpg") for f in files)
    resize_err = 0
    for jpg, png in jpeg_sources("kitti_raw", raw["kitti_raw"], dumps["kitti_raw"])[:8]:
        img = read_png(png)
        card, cpu = imresize(img, 256, 832, "cuda"), imresize(img, 256, 832, "cpu")
        resize_err = max(resize_err, int(np.abs(card.astype(int) - cpu).max()))
    if resize_err > PREP_RESIZE_TOL:
        raise AssertionError(f"the card's resize is {resize_err} levels off the CPU's")
    log(f"[prepare] KITTI raw, card against CPU ({cpu_etl['wall_s']:.2f} s, one process): "
        f"{n_npy} depth .npy equal, cam.txt, poses.txt, train.txt and val.txt equal as text, "
        f"{same_jpeg} of {n_jpeg} JPEGs equal byte for byte; the uint8 resize on the card "
        f"within {resize_err} grey levels of the CPU's (8 frames) [tol {PREP_RESIZE_TOL}]")

    # The written JPEGs, decoded by the build, against the frames they encode.
    for fmt, flags in PREP_FORMATS:
        height = int(flags[flags.index("--height") + 1])
        errs = []
        for jpg, png in jpeg_sources(fmt, raw[fmt], dumps[fmt])[::3]:
            want = imresize(read_png(png), height, 832, "cuda")
            if fmt == "cityscapes":
                want = want[: int(height * 0.75)]
            got = jpeg_io.decode(jpg)
            if got.shape != want.shape:
                raise AssertionError(f"{jpg}: {got.shape} against {want.shape}")
            diff = np.abs(got.astype(int) - want)
            errs.append((diff.mean(), diff.max()))
        mean, worst = max(e[0] for e in errs), max(e[1] for e in errs)
        log(f"[prepare] {fmt}: {len(errs)} written JPEGs decoded against the frames they "
            f"encode: mean error up to {mean:.3f}, max {worst} [tol {JPEG_TRIP_MEAN}, "
            f"{JPEG_TRIP_MAX}]")
        if mean > JPEG_TRIP_MEAN or worst > JPEG_TRIP_MAX:
            raise AssertionError(f"{fmt}: JPEG round trip mean {mean}, max {worst}")

    # Decoding a prepared 832x256 JPEG: one at a time, and batched on threads.
    jpgs = [j for j, _ in jpeg_sources("kitti_raw", raw["kitti_raw"], dumps["kitti_raw"])]
    times = []
    for path in jpgs[:40]:
        t = time.perf_counter()
        jpeg_io.decode(path)
        times.append(time.perf_counter() - t)
    t = time.perf_counter()
    batch = jpeg_io.decode_batch(jpgs[:64], 256, 832, 8)
    batch_ms = (time.perf_counter() - t) * 1e3 / len(batch)
    log(f"[prepare] decode of an 832x256 JPEG (host clock): {np.median(times) * 1e3:.3f} ms "
        f"median one at a time, {batch_ms:.3f} ms per frame in a batch of {len(batch)} on 8 "
        "threads")

    # The packer on the prepared tree: its frames are the decoded JPEGs.
    with contextlib.redirect_stdout(io.StringIO()) as out:
        packed_module.main([dumps["kitti_raw"]])
    log(f"[prepare-pack] {out.getvalue().strip()}")
    packed_set = PackedSequenceSet(os.path.join(dumps["kitti_raw"], "packed"))
    index = packed_set.index
    n = 0
    for name, meta in index["scenes"].items():
        for i, path in enumerate(sorted(glob.glob(os.path.join(dumps["kitti_raw"], name,
                                                               "*.jpg")))):
            if not np.array_equal(packed_set.frames[meta["start"] + i], jpeg_io.decode(path)):
                raise AssertionError(f"packed frame of {path} differs from its decode")
            n += 1
    if n != index["n_frames"]:
        raise AssertionError(f"{n} JPEGs against {index['n_frames']} packed frames")
    log(f"[prepare-pack] {n} packed frames equal the decoded JPEGs bit for bit")

    # A 16-bit NYU depth PNG (NYU's /5000 convention) through ValidationSet.
    nyu = os.path.join(root, "nyu")
    os.makedirs(os.path.join(nyu, "scene", "depth"))
    rng = np.random.RandomState(seed + 22)
    depth = (rng.rand(480, 640) * 4.0 + 1.0) * 5000.0
    write_png(os.path.join(nyu, "scene", "depth", "000000.png"), depth.astype(np.uint16), 4)
    jpeg_io.encode(os.path.join(nyu, "scene", "000000.jpg"),
                   make_smoke_kitti._panning_frames(rng, 480, 640, 1)[0])
    with open(os.path.join(nyu, "val.txt"), "w") as f:
        f.write("scene\n")
    sample = ValidationSet(nyu, dataset="nyu").load(0, np.random.default_rng(0))
    if not np.array_equal(sample["depth"], depth.astype(np.uint16).astype(np.float32) / 5000.0):
        raise AssertionError("the NYU depth PNG did not read back")
    log(f"[prepare] a 16-bit NYU depth PNG (640x480) through ValidationSet(dataset='nyu'): "
        f"depth {sample['depth'].shape} equal to the written values / 5000")
    # The train CLI from the JPEG tree (no --packed), validation with the
    # velodyne ground truth.
    zero_launches()
    save = run_cli(dumps["kitti_raw"], "smoke_jpeg", seed, "--with-gt",
                   data_args=("--device-augment",))
    launches = read_launches()
    want = with_depth_validation({k: CLI_STEPS * per_step[k] for k in WRAPPERS}, launches)
    log(f"[prepare-cli] launches over {CLI_STEPS} train steps from the JPEG tree and the "
        f"ground-truth validation: {launches}")
    if launches != want:
        raise AssertionError(f"JPEG-tree CLI launches {launches}, expected {want}")
    check_cli_outputs(save, "prepare-cli")
    jpeg_times = cli_times(save, "cli_jpeg", 1)
    log(f"[prepare-cli] the JPEG tree's CLI against the packed one of [cli] (host clock, this "
        f"call): step median {jpeg_times['cli_jpeg_step_ms_median_after_1']:.2f} against "
        f"{packed_times['cli_step_ms_median_after_1']:.2f} ms, epoch-2 mean "
        f"{jpeg_times['cli_jpeg_step_ms_mean_epoch_2']:.2f} against "
        f"{packed_times['cli_step_ms_mean_epoch_2']:.2f} ms, data wait median "
        f"{jpeg_times['cli_jpeg_data_wait_ms_median_after_1']:.2f} against "
        f"{packed_times['cli_data_wait_ms_median_after_1']:.2f} ms | {smi}")

    shutil.rmtree(root, ignore_errors=True)
    log(f"[prepare] phase {time.perf_counter() - t_phase:.1f} s | {smi}")
    return {"train_cli_jpeg": launches}


# The checkpoints phase: seeded nets after a few bf16 Adam steps at full width,
# written in both layouts; the JAX layout evaluated, restored, resumed by the
# train CLI and converted.
CKPT_DIR = os.path.join("build", "chip_smoke_checkpoints")
CKPT_STEPS = 3


def rss_mib() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


def host_peak(fn):
    """(fn's result, its seconds, the peak of the process's resident host
    memory above its start while it ran, MiB; sampled every 2 ms)."""
    start, peak, stop = rss_mib(), [0.0], threading.Event()

    def poll():
        while not stop.is_set():
            peak[0] = max(peak[0], rss_mib())
            stop.wait(0.002)

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    t = time.perf_counter()
    try:
        out = fn()
    finally:
        secs = time.perf_counter() - t
        stop.set()
        thread.join(timeout=10)
    return out, secs, max(peak[0], rss_mib()) - start


def train_state_tensors(state) -> dict:
    """Every tensor a resume restores, by name, on the CPU: parameters,
    BatchNorm statistics, Adam's moments and steps."""
    out = {}
    for key, net in (("disp", state.disp_net), ("pose", state.pose_net)):
        for name, t in net.state_dict().items():
            if not name.endswith("num_batches_tracked"):  # flax keeps no counter
                out[f"{key}.{name}"] = t.detach().cpu()
    for i, st in state.optimizer.state_dict()["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            out[f"adam.{i}.{k}"] = st[k].detach().cpu()
    return out


def check_resumed_cli(save: str, label: str, want_launches: dict, launches: dict) -> None:
    """One resumed epoch: every kernel launched as expected, steps
    CKPT_STEPS + 1 onwards, finite losses."""
    steps = [int(r[0]) for r in read_rows(os.path.join(save, train_cli.TIME_LOG))]
    rows = read_rows(os.path.join(save, "progress_log_full.csv"))
    log(f"[{label}] launches {launches} (expected {want_launches}); steps "
        f"{steps[0]}..{steps[-1]}; {len(rows)} loss rows, last {rows[-1]}")
    if launches != want_launches:
        raise AssertionError(f"{label}: launches {launches}, expected {want_launches}")
    if steps != list(range(CKPT_STEPS + 1, CKPT_STEPS + CLI_EPOCH_SIZE + 1)):
        raise AssertionError(f"{label}: resumed steps {steps}")
    if len(rows) != CLI_EPOCH_SIZE or not all(np.isfinite(float(v)) for r in rows for v in r):
        raise AssertionError(f"{label}: loss rows {rows}")


def checkpoints_phase(seed: int, rng: np.random.RandomState, smi: str, per_step: dict,
                      per_validation: dict) -> dict:
    """The JAX package's checkpoint files on the card: seeded nets after
    CKPT_STEPS bf16 Adam steps written as ``.msgpack`` and as ``.pth.tar``;
    the eval CLIs on either file bit-equal; the train state restored from
    either directory bit-equal; the train CLI resumed from the JAX
    directory, eager and fused; the converter's round trip; times and
    sizes."""
    t_phase = time.perf_counter()
    root = os.path.abspath(CKPT_DIR)
    shutil.rmtree(root, ignore_errors=True)
    disp_net, pose_net = make_nets(seed + 21)
    state = create_train_state(disp_net, pose_net, make_optimizer(disp_net, pose_net))
    step = make_train_step(disp_net, pose_net, state.optimizer, LossConfig(), device=DEVICE)
    batch = make_batch(rng)
    losses = [step(batch)["loss"].item() for _ in range(CKPT_STEPS)]
    if not all(np.isfinite(losses)) or state.step != CKPT_STEPS:
        raise AssertionError(f"checkpoint nets: losses {losses}, step {state.step}")
    jax_dir, pth_dir = os.path.join(root, "jax"), os.path.join(root, "pth")
    _, jax_write_s, _ = host_peak(lambda: save_jax_checkpoint(jax_dir, state, True, epoch=1))
    _, pth_write_s, _ = host_peak(lambda: save_checkpoint(pth_dir, state, True, epoch=1))
    sizes = {name: os.path.getsize(os.path.join(jax_dir, name)) / 1e6
             for name in ("dispnet_checkpoint.msgpack", "exp_pose_checkpoint.msgpack",
                          "train_state.msgpack")}
    _, disp_read_s, disp_peak = host_peak(lambda: restore_disp_state(
        os.path.join(jax_dir, "dispnet_checkpoint.msgpack")))
    log(f"[checkpoints] {CKPT_STEPS} bf16 steps (losses {[round(x, 5) for x in losses]}); "
        f"written in {jax_write_s:.3f} s (.msgpack, incl. train_state) and {pth_write_s:.3f} s "
        f"(.pth.tar); sizes MB {sizes}; DispNet .msgpack read and mapped in {disp_read_s:.4f} s "
        f"(host peak +{disp_peak:.1f} MiB) | {smi}")

    # The eval CLIs on either file: bit-equal depths and trajectories.
    data = write_eval_data(os.path.join(root, "eval"), seed)
    outputs = {}
    for kind, d, ext in (("msgpack", jax_dir, "msgpack"), ("pth", pth_dir, "pth.tar")):
        out = os.path.join(root, f"out_{kind}")
        disp_file = os.path.join(d, f"dispnet_checkpoint.{ext}")
        pose_file = os.path.join(d, f"exp_pose_checkpoint.{ext}")
        run_eval_cli(test_disp, ["--pretrained-dispnet", disp_file, "--resnet-layers", "18",
                                 "--dataset-dir", data["depth"], "--output-dir",
                                 os.path.join(out, "disp"), "--batch-size", "8"],
                     f"test_disp {kind}")
        run_eval_cli(test_vo, ["--pretrained-posenet", pose_file, "--sequence", "09",
                               "--dataset-dir", os.path.join(data["odom"], "sequences"),
                               "--output-dir", os.path.join(out, "vo"), "--batch-size", "16"],
                     f"test_vo {kind}")
        outputs[kind] = (np.load(os.path.join(out, "disp", "predictions.npy")),
                         np.loadtxt(os.path.join(out, "vo", "09.txt")))
    same_depth = np.array_equal(outputs["msgpack"][0], outputs["pth"][0])
    same_traj = np.array_equal(outputs["msgpack"][1], outputs["pth"][1])
    log(f"[checkpoints] test_disp depths {outputs['pth'][0].shape} and test_vo trajectory "
        f"{outputs['pth'][1].shape} from .msgpack against .pth.tar: bit-equal {same_depth}, "
        f"{same_traj}")
    if not (same_depth and same_traj and np.isfinite(outputs["pth"][0]).all()):
        raise AssertionError("the .msgpack and .pth.tar networks evaluate differently")

    # The train state from either directory, into fresh nets on the card.
    want = train_state_tensors(state)
    restored, peaks = {}, {}
    for kind, d in (("msgpack", jax_dir), ("pth", pth_dir)):
        nets = make_nets(seed + 22)
        for net in nets:
            net.to(DEVICE)
        fresh = create_train_state(*nets, make_optimizer(*nets))
        _, secs, peak = host_peak(lambda: restore_train_state(d, fresh))
        peaks[kind] = (secs, peak)
        restored[kind] = train_state_tensors(fresh)
        del fresh, nets
    bad = [k for k in want if not (torch.equal(restored["msgpack"][k], want[k])
                                   and torch.equal(restored["pth"][k], want[k]))]
    log(f"[checkpoints] restore_train_state into fresh nets on the card: {len(want)} tensors "
        f"(parameters, BatchNorm statistics, Adam moments and steps), unequal {bad[:5]}; "
        f"seconds and host peak MiB: train_state.msgpack {peaks['msgpack'][0]:.3f} s "
        f"+{peaks['msgpack'][1]:.1f} MiB, train_state.pth.tar {peaks['pth'][0]:.3f} s "
        f"+{peaks['pth'][1]:.1f} MiB")
    if bad or len(want) < 300:
        raise AssertionError(f"restored train states differ: {bad[:10]} of {len(want)}")
    del restored, want, step, state, disp_net, pose_net
    torch.cuda.empty_cache()

    # The train CLI resumed from the JAX directory, eager and fused.
    write_packed_dataset(root, seed)
    val_samples = sum(n - N for name, n in CLI_SCENES if name.startswith("val"))
    val_batches = min(CLI_VAL_BATCHES, -(-val_samples // B))
    want_launches = {k: CLI_EPOCH_SIZE * per_step[k] + val_batches * per_validation[k]
                     for k in WRAPPERS}
    by_path = {}
    for label, extra in (("resume_jax", ()),
                         ("resume_jax_fused", ("--fused-steps", str(CLI_FUSED_K)))):
        zero_launches()
        save = run_cli(root, label, seed, "--epochs", "1", "--resume", jax_dir, *extra)
        by_path[label] = read_launches()
        check_resumed_cli(save, label, want_launches, by_path[label])

    # The converter, .pth.tar -> .msgpack -> .pth.tar.
    for net, prefix in (("disp", "dispnet"), ("pose", "exp_pose")):
        src = os.path.join(pth_dir, f"{prefix}_checkpoint.pth.tar")
        mid, back = os.path.join(root, f"{prefix}.msgpack"), os.path.join(root, f"{prefix}.pth.tar")
        for a, b in ((src, mid), (mid, back)):
            if convert_checkpoint.main([a, b, "--net", net]) != 0:
                raise AssertionError(f"convert_checkpoint {a} -> {b}")
        ref, got = load_torch_state_dict(src), load_torch_state_dict(back)
        same = set(ref) == set(got) and all(
            torch.equal(got[k], v) for k, v in ref.items() if not k.endswith("num_batches_tracked"))
        log(f"[checkpoints] convert_checkpoint {prefix} .pth.tar -> .msgpack -> .pth.tar: "
            f"bit-equal {same} ({len(ref)} tensors; BatchNorm's counters, which flax does not "
            "keep, come back as 0)")
        if not same:
            raise AssertionError(f"convert_checkpoint round trip of {prefix} differs")
    shutil.rmtree(root, ignore_errors=True)
    log(f"[checkpoints] phase {time.perf_counter() - t_phase:.1f} s | {smi}")
    return by_path


TOOLS_DIR = os.path.join("build", "chip_smoke_tools")
SYNTH_FRAMES, SYNTH_VAL_FRAMES = 24, 8
# profile_step's device window against the graph's device time, relative: the
# profiler's own cost per record (about 1,200 per step) lengthens the traced
# replays, by 4.2% in a rehearsal on an H100.
PROFILE_TOL = 0.10


def tools_phase(seed: int, smi: str, per_step: dict, graph_device_ms: float) -> dict:
    """The step's tools on the card: training from ``synthetic_scene``'s
    JPEG tree, ``overfit_check`` at its defaults, ``mfu_report``,
    ``profile_step`` against the graph's device time, ``ablate_step``."""
    t_phase = time.perf_counter()
    root = os.path.abspath(TOOLS_DIR)
    shutil.rmtree(root, ignore_errors=True)
    by_path = {}

    scene = os.path.join(root, "synthetic")
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        synthetic_scene.make_dataset(scene, SYNTH_FRAMES, seed, SYNTH_VAL_FRAMES)
    log(f"[tools] synthetic_scene: {SYNTH_FRAMES}+{SYNTH_VAL_FRAMES} frames at "
        f"{synthetic_scene.W}x{synthetic_scene.H} in {time.perf_counter() - t:.2f} s")
    # 22 snippets make 5 batches of 4: two epochs of 5 steps.
    zero_launches()
    save = run_cli(scene, "smoke_synthetic", seed, "--with-gt", "--epoch-size", "5",
                   data_args=("--device-augment",))
    by_path["synthetic_cli"] = read_launches()
    rows = read_rows(os.path.join(save, "progress_log_full.csv"))
    want = with_depth_validation({k: 10 * per_step[k] for k in WRAPPERS},
                                 by_path["synthetic_cli"])
    log(f"[tools] train CLI from the synthetic JPEG tree, --with-gt on its .npy depth: "
        f"launches {by_path['synthetic_cli']} (expected {want}), {len(rows)} loss rows, "
        f"last {rows[-1]}")
    if by_path["synthetic_cli"] != want or len(rows) != 10 or not all(
            np.isfinite(float(v)) for r in rows for v in r):
        raise AssertionError("train CLI from the synthetic scene")

    code, text, secs, by_path["overfit_check"] = run_main(overfit_check, ["--device", "cuda"],
                                                          "overfit_check")
    ratio, corr = printed(text, "photo loss:")[-1], printed(text, "depth correlation")[0]
    ms = printed(text, "ms per step after the first:")[0]
    # The scene's reference views warp once; the depth correlation runs
    # DispNet's forward once.
    want = {k: 300 * per_step[k] + (k == "warp_sample")
            + DECODER_INPUTS * (k == "decoder_input") for k in WRAPPERS}
    log(f"[tools] overfit_check (300 steps, 128x256, eager bf16) | {smi}: loss ratio {ratio}%, "
        f"depth correlation {corr}, {ms} ms per step, {secs:.1f} s; launches "
        f"{by_path['overfit_check']} (expected {want})")
    if code != 0 or "OVERFIT CHECK: PASS" not in text or by_path["overfit_check"] != want:
        raise AssertionError("overfit_check did not pass")

    zero_launches()
    mfu = mfu_report.report(B, CLI_FUSED_K, iters=5)
    by_path["mfu_report"] = read_launches()
    want = {k: (3 + 5) * CLI_FUSED_K * per_step[k] for k in WRAPPERS}
    log(f"[tools] mfu_report B{B} K={CLI_FUSED_K}: {mfu}; launches {by_path['mfu_report']}")
    if by_path["mfu_report"] != want or not 0 < mfu["mfu"] < 1:
        raise AssertionError(f"mfu_report: launches expected {want}")
    torch.cuda.empty_cache()

    zero_launches()
    prof = profile_step.profile(B, CLI_FUSED_K, steps=3, top=15, log=log)
    by_path["profile_step"] = read_launches()
    busy, window = sum(prof["groups"].values()), prof["window_ms"]
    log(f"[tools] profile_step K={CLI_FUSED_K} | {smi}: groups sum {busy:.4f} ms per step, idle "
        f"between the replays' records {window - busy:.4f} ms, together the device's window "
        f"{window:.4f} ms against the graph phase's {graph_device_ms:.4f} ms of device time "
        f"(CUDA events; tol {PROFILE_TOL:.0%}); {prof['kernels_per_step']:.0f} records per step; "
        f"complete {prof['complete']}; launches {by_path['profile_step']}")
    # The profiler drops device records now and then (a window whose records
    # fall short is reported as such, its busy time a lower bound).
    if not (abs(window - graph_device_ms) <= PROFILE_TOL * graph_device_ms and busy <= window):
        raise AssertionError(f"profile_step: busy {busy:.4f} and window {window:.4f} ms "
                             f"against {graph_device_ms:.4f}")
    if unlaunched(by_path["profile_step"]):
        raise AssertionError("profile_step: a kernel did not launch, or the cost volume did")
    torch.cuda.empty_cache()

    n, reps = 3, 2
    code, text, secs, by_path["ablate_step"] = run_main(
        ablate_step, ["--configs", "full,no_ssim,convs_only", "--n", str(n), "--reps", str(reps)],
        "ablate_step")
    times = {name: printed(text, name)[0] for name in ("full", "no_ssim", "convs_only")}
    # Each variant takes K (16) steps per call: 3 warm calls and n * reps timed.
    steps = ablate_step.FUSED * (3 + n * reps)
    want = {k: steps * per_step[k] * (2 if k.startswith("warp") else 1) for k in WRAPPERS}
    # All three run the networks; convs_only's loss, a sum of every scale's
    # depth, reaches every decoder input, heads included.
    want["decoder_input"] = 3 * steps * per_step["decoder_input"]
    want["decoder_input_bwd"] = steps * (2 * per_step["decoder_input_bwd"] + DECODER_INPUTS)
    log(f"[tools] ablate_step (K={ablate_step.FUSED}, device ms per step) | {smi}: {times}, "
        f"{secs:.1f} s; launches {by_path['ablate_step']} (expected {want}: full and no_ssim "
        "warp, full alone runs SSIM, all three run the networks)")
    if code != 0 or "FAILED" in text or by_path["ablate_step"] != want:
        raise AssertionError("ablate_step failed")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[tools] phase {time.perf_counter() - t_phase:.1f} s | {smi}")
    return by_path


# The configs phase: the repository's other published training
# configurations at their full published size. Each train CLI runs with the
# flags its script in sc_sfmlearner_release_tpu_torch/scripts/ passes,
# read by running the script with a recording ``python`` first on PATH;
# only TRAIN_SET, the ImageNet weights directory (seeded random files in
# torchvision's layout), --epochs, --epoch-size and --name are overridden.
CONFIGS_DIR = os.path.join("build", "chip_smoke_configs")
PORT_SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(train_cli.__file__)), "scripts")
TRAIN_MODULE = "sc_sfmlearner_release_tpu_torch.train"
CONFIG_FLAG_OVERRIDES = ("--epochs", "--epoch-size", "--name")
# Variables the scripts read that are unset for them, so that each
# script's own defaults hold (they set TRAIN_SET and IMAGENET_WEIGHTS_DIR).
SCRIPT_DEFAULTS_ENV = ("DEVICE", "FUSED_STEPS")
R50 = 50
R50_K = 16                  # train_resnet50_depth_256.sh's --fused-steps
# Its CLI's epochs: 2 dispatches of R50_K steps each, so the second epoch
# holds only replays (the first: the eager warm-up, then the capture).
R50_EPOCH_SIZE = 2 * R50_K
# Gradients of the fp32 ResNet-50 card step against the CPU's at CHECK_SHAPE
# (DispNet-50 and PoseNet-18, the scripts' auto-mask on), relative L2 per
# tensor, by GRAD_RTOL's recipe: on the CPU alone, perturbing the frames by
# 1e-6 moves them at this shape by up to 5.3e-2 (encoders) and 4.4e-3
# (decoders and heads), two trials (``JAX_PLATFORMS=cpu PYTHONPATH=. python
# tests/test_torch_configs.py card-gates``); the tolerances are about twice
# that.
GRAD_RTOL_R50 = {"encoders": 1e-1, "decoders": 1e-2}
# The same for the NYU pair step at NYU_CHECK_SHAPE (DispNet-18): 2.2e-2 and
# 3.7e-5, two trials; GRAD_RTOL's encoder gate (3e-2) is under twice that,
# its decoder gate stays.
GRAD_RTOL_NYU = {"encoders": 5e-2, "decoders": GRAD_RTOL["decoders"]}
# train_resnet50_depth_256.sh on a JPEG tree at 832x256 with .npy ground
# truth (--with-gt): 132 snippets, 33 batches of 4 for epochs of
# R50_EPOCH_SIZE steps.
R50_SCENES = (("2011_09_26_drive_0001_sync_02", 68, "train"),
              ("2011_09_26_drive_0009_sync_02", 68, "train"),
              ("2011_09_26_drive_0002_sync_02", 8, "val"))
# train_resnet50_pose_256.sh on an odometry dump's layout: sequences as
# scenes; one epoch of 4 steps, photometric validation (no --with-gt).
POSE_SCENES = (("00_02", 12, "train"), ("08_02", 12, "train"), ("09_02", 8, "val"))
POSE_STEPS = 4
NYU_B, NYU_N, NYU_H, NYU_W = 16, 1, 256, 320   # train_nyu.sh: -b16, pair folders, 320x256
NYU_WARPS = 2 * NYU_N * NYU_B
NYU_CHECK_SHAPE = (2, 1, 128, 160)  # the fp32 card-vs-CPU step at NYU's aspect
NYU_CLI_PAIRS = 40          # make_smoke_nyu --pairs: 2 scenes, 5 batches of 16 an epoch
CONFIG_EPOCHS = 2


def nyu_intrinsics(b: int, h: int, w: int) -> np.ndarray:
    """NYUv2's Kinect camera (fx 518.86, fy 519.47, cx 325.58, cy 253.74 at
    640x480) scaled to ``w`` x ``h``."""
    k = np.array([[518.86 * w / 640, 0.0, 325.58 * w / 640],
                  [0.0, 519.47 * h / 480, 253.74 * h / 480],
                  [0.0, 0.0, 1.0]], np.float32)
    return np.broadcast_to(k, (b, 3, 3)).copy()


def script_train_argv(script: str, train_set: str, weights_dir: str) -> list:
    """The arguments that ``sc_sfmlearner_release_tpu_torch/scripts/<script>``
    gives ``python -m sc_sfmlearner_release_tpu_torch.train``, as bash
    expands them with TRAIN_SET and IMAGENET_WEIGHTS_DIR set and DEVICE and
    FUSED_STEPS unset: the script runs once with a ``python`` first on PATH
    that writes its arguments instead of running them."""
    with tempfile.TemporaryDirectory() as tmp:
        record = os.path.join(tmp, "argv")
        shim = os.path.join(tmp, "python")
        with open(shim, "w") as f:
            f.write('#!/bin/sh\nprintf \'%s\\0\' "$@" >> "$SCRIPT_ARGV"\n')
        os.chmod(shim, 0o755)
        env = {k: v for k, v in os.environ.items() if k not in SCRIPT_DEFAULTS_ENV}
        env.update(PATH=f"{tmp}:{os.environ['PATH']}", SCRIPT_ARGV=record,
                   TRAIN_SET=train_set, IMAGENET_WEIGHTS_DIR=weights_dir)
        subprocess.run(["bash", os.path.join(PORT_SCRIPTS, script)], env=env, check=True,
                       capture_output=True, timeout=60)
        with open(record) as f:
            argv = f.read().split("\0")[:-1]
    if argv[:2] != ["-m", TRAIN_MODULE] or argv.count("-m") != 1:
        raise AssertionError(f"{script}: expected one python -m {TRAIN_MODULE} line, got {argv}")
    return argv[2:]


def config_argv(script: str, train_set: str, weights_dir: str, overrides: dict) -> list:
    """``script_train_argv`` with each flag of ``overrides`` (only
    CONFIG_FLAG_OVERRIDES) set to its value: in place where the script
    passes it, else appended."""
    if set(overrides) - set(CONFIG_FLAG_OVERRIDES):
        raise ValueError(f"only {CONFIG_FLAG_OVERRIDES} may be overridden, not {overrides}")
    argv = script_train_argv(script, train_set, weights_dir)
    for flag, value in overrides.items():
        if flag in argv:
            argv[argv.index(flag) + 1] = value
        else:
            argv += [flag, value]
    return argv


def write_imagenet_files(root: str, seed: int) -> str:
    """``resnet50.pth`` and ``resnet18.pth`` of seeded random weights in
    torchvision's layout (the fc layer included) under ``root``: what
    ``--with-pretrain 1`` grafts. Returns ``root``."""
    os.makedirs(root)
    for layers, features in ((R50, 2048), (18, 512)):
        g = torch.Generator().manual_seed(seed + layers)
        sd = {k: (torch.randn(v.shape, generator=g) * 0.05 if v.is_floating_point() else v)
              for k, v in ResNet(layers, 1).state_dict().items()
              if not k.endswith("num_batches_tracked")}
        for k in sd:
            if "running_var" in k:
                sd[k] = sd[k].abs() + 1.0
        sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, features), torch.zeros(1000)
        torch.save(sd, os.path.join(root, f"resnet{layers}.pth"))
    return root


def write_jpeg_tree(root: str, seed: int, scenes) -> str:
    """A KITTI-format tree at 832x256: per scene ``(name, frames, split)`` a
    camera panning over a texture, 2 pixels a frame, as JPEGs (the port's
    codec) with KITTI's ``cam.txt``; validation scenes also hold ``.npy``
    depth (far at the top, near at the bottom) for ``--with-gt``. Returns
    ``root``."""
    rng = np.random.RandomState(seed)
    lists = {"train": [], "val": []}
    for name, count, split in scenes:
        scene = os.path.join(root, name)
        os.makedirs(scene)
        texture = noise_texture(rng, H, W + 2 * count)
        for i in range(count):
            jpeg_io.encode(os.path.join(scene, f"{i:07d}.jpg"), texture[:, 2 * i:2 * i + W])
            if split == "val":
                depth = (80 - 75 * np.linspace(0, 1, H)[:, None]) * (1 + 0.1 * rng.rand(H, W))
                np.save(os.path.join(scene, f"{i:07d}.npy"), depth.astype(np.float32))
        np.savetxt(os.path.join(scene, "cam.txt"), kitti_intrinsics(1)[0])
        lists[split].append(name)
    for split, names in lists.items():
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return root


def nyu_kernels_phase(rng: np.random.RandomState, smi: str) -> dict:
    """The four kernels at train_nyu.sh's shapes (B16 N1 256x320: 32 warps
    of [256, 320], SSIM on [32, 3, 256, 320]) against their plain versions:
    the warp forward and backward on coordinates projected from an indoor
    pair (NYU's camera, a hand-held motion) and on random ones, both padding
    modes; SSIM forward and backward on an independent and a correlated
    ``y``, the backward against its plain version (and against autograd
    through the plain forward on the independent ``y``; on the correlated
    one that is reported beside a float64 autograd, as at
    ``SSIM_SHARD_SHAPE``). Each kernel's times and bound at these shapes."""
    dev = torch.device(DEVICE)
    pairs, h, w = NYU_WARPS, NYU_H, NYU_W
    depth = torch.from_numpy(rng.uniform(0.5, 10.0, (pairs, h, w, 1)).astype(np.float32)).to(dev)
    rgb = torch.from_numpy(rng.rand(pairs, h, w, 3).astype(np.float32)).to(dev)
    src = torch.cat([depth, rgb], -1).contiguous()
    # A wall from 1.5 m on the left to 6 m on the right.
    wall = np.linspace(1.5, 6.0, w, dtype=np.float32)[None, None, :, None]
    tgt_depth = torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(wall, (pairs, h, w, 1)))).to(dev)
    pose = torch.from_numpy(
        (rng.randn(pairs, 6) * [0.05, 0.02, 0.05, 0.01, 0.02, 0.01]).astype(np.float32)).to(dev)
    intr = torch.from_numpy(nyu_intrinsics(pairs, h, w)).to(dev)
    rand = torch.from_numpy(rng.uniform(-1.3, 1.3, (pairs, h, w, 2)).astype(np.float32)).to(dev)
    cases = []
    for mode in ("zeros", "border"):
        proj, _ = project_pixel_coords(tgt_depth, pose, intr, mode)
        cases += [(mode, "projected", proj.contiguous()), (mode, "random", rand)]
    dout = torch.from_numpy(rng.randn(pairs, h, w, 4).astype(np.float32)).to(dev)
    tag = f"[{pairs},{h},{w}]"
    errs = {"warp_sample": 0.0, "warp_sample_bwd": 0.0, "ssim_nchw": 0.0, "ssim_nchw_bwd": 0.0}
    for mode, label, coords in cases:
        got = warp_sample(src, coords, mode)
        errs["warp_sample"] = max(errs["warp_sample"], check_close(
            f"warp_sample {tag} {mode}/{label}", got, warp_sample_plain(src, coords, mode),
            KERNEL_TOL))
        dsrc, dcoords = warp_sample_bwd(src, coords, dout, mode, 1, True)
        (want_d, want_c), _ = plain_grads(
            lambda d, c: warp_sample_plain(d, c, mode, frozen=rgb), (depth, coords), dout)
        errs["warp_sample_bwd"] = max(
            errs["warp_sample_bwd"],
            check_rel(f"warp_sample_bwd {tag} {mode}/{label} d(coords)", dcoords, want_c,
                      GRAD_TOL),
            check_rel(f"warp_sample_bwd {tag} {mode}/{label} d(depth)", dsrc, want_d, GRAD_TOL))
    coords = cases[0][2]
    calls = {"warp_sample": (lambda: warp_sample(src, coords, "zeros"), "warp_sample",
                             warp_fwd_bound(pairs * h * w)),
             "warp_sample_bwd": (lambda: warp_sample_bwd(src, coords, dout, "zeros", 1, True),
                                 ("warp_sample_bwd", "Memset"), warp_bwd_bound(pairs * h * w))}

    shape = (pairs, 3, h, w)
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev)
    noise = torch.from_numpy((rng.randn(*shape) * 0.05).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    ys = (("independent", torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev)),
          ("correlated", (x + noise).clamp(0.0, 1.0)))
    tag = f"[{','.join(map(str, shape))}]"
    log(f"  ssim_nchw {tag}: {ssim_plan(x, ys[0][1])}; backward: "
        f"{ssim_bwd_plan(x, ys[0][1], g)}")
    for label, y in ys:
        errs["ssim_nchw"] = max(errs["ssim_nchw"], check_close(
            f"ssim_nchw {tag} {label}", ssim_nchw(x, y), ssim_nchw_plain(x, y), KERNEL_TOL))
        (want_x, want_y), _ = plain_grads(ssim_nchw_plain, (x, y), g)
        plain_x, plain_y = ssim_nchw_bwd_plain(x, y, g, need_x=True)
        _, dy_only = ssim_nchw_bwd(x, y, g)
        dx, dy = ssim_nchw_bwd(x, y, g, need_x=True)
        refs = [("plain", (plain_x, plain_y))]
        if label == "independent":
            refs.append(("autograd", (want_x, want_y)))
        else:
            report_against_float64(f"ssim_nchw_bwd {tag} {label}", x, y, g, (dx, dy),
                                   (want_x, want_y))
        for ref, (rx, ry) in refs:
            name = f"ssim_nchw_bwd {tag} {label}"
            errs["ssim_nchw_bwd"] = max(
                errs["ssim_nchw_bwd"],
                check_rel(f"{name} d/dy alone vs {ref}", dy_only, ry, GRAD_TOL),
                check_rel(f"{name} d/dy vs {ref}", dy, ry, GRAD_TOL),
                check_rel(f"{name} d/dx vs {ref}", dx, rx, GRAD_TOL))
    y = ys[1][1]
    calls["ssim_nchw"] = (lambda: ssim_nchw(x, y), "ssim_kernel", ssim_fwd_bound(x.numel()))
    calls["ssim_nchw_bwd"] = (lambda: ssim_nchw_bwd(x, y, g), "ssim_bwd_kernel",
                              ssim_bwd_bound(x.numel()))
    out = {}
    for name, (call, kernel, (bound_ms, bound_by)) in calls.items():
        ms = cuda_ms(call, KERNEL_ITERS)
        dev_ms, dev_by = device_ms(call, kernel)
        out[name] = {"max_abs_err": errs[name], "ms": ms, "device_ms": dev_ms,
                     "device_ms_by": dev_by, "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_share": bound_ms / dev_ms}
        log(f"[configs] {name} at NYU's B16 shapes | {smi}: kernel {ms:.4f} ms (events), "
            f"device {dev_ms:.4f} ms ({dev_by}, {100 * bound_ms / dev_ms:.0f}% of its bound "
            f"{bound_ms:.4f} ms, {bound_by}); max err {errs[name]:.3e}")
    return out


def mfu(flops: float, ms: float) -> float:
    """``flops`` per step at ``ms`` per step over the card's bf16 dense peak."""
    return flops / (ms * 1e-3) / (mfu_report.peak_tflops() * 1e12)


def check_config_cli(save: str, label: str, steps: int, layers: int, first: int = 1,
                     epochs: int = CONFIG_EPOCHS) -> None:
    """``check_cli_outputs`` at ``steps``, the time log's steps from
    ``first``, and a finite validation error per epoch."""
    check_cli_outputs(save, label, steps, layers)
    numbers = [int(r[0]) for r in read_rows(os.path.join(save, train_cli.TIME_LOG))]
    summary = read_rows(os.path.join(save, "progress_log_summary.csv"))
    if numbers != list(range(first, first + steps)) or len(summary) != epochs or not all(
            np.isfinite(float(v)) for r in summary for v in r):
        raise AssertionError(f"{label}: steps {numbers}, summary {summary}")
    log(f"[{label}] steps {numbers[0]}..{numbers[-1]}, validation per epoch "
        f"{[float(r[1]) for r in summary]}")


def run_config_cli(root: str, argv: list, label: str, want: dict) -> tuple:
    """The train CLI on ``argv`` with the launch counts at 0 just before it;
    its launches must equal ``want``. Returns (experiment directory,
    launches, peak memory GiB)."""
    log(f"[{label}] python -m {TRAIN_MODULE} {' '.join(argv)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    save = run_train(root, argv, label)
    launches = read_launches()
    if "--with-gt" in argv:
        want = with_depth_validation(want, launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{label}] launches {launches} (expected {want}); peak device memory {peak:.3f} GiB")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    return save, launches, peak


def configs_phase(seed: int, smi: str, per_step: dict, per_validation: dict):
    """The three other published training configurations on the card
    (``[configs]``). Returns their paths' launches and the kernels' numbers
    at NYU's shapes."""
    t_phase = time.perf_counter()
    root = os.path.abspath(CONFIGS_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    weights = write_imagenet_files(os.path.join(root, "imagenet"), seed)
    eval_paths = write_eval_data(os.path.join(root, "eval"), seed)
    auto = LossConfig(with_auto_mask=True)
    by_path, report, failures = {}, {}, []
    steps_of = lambda n: {k: n * per_step[k] for k in WRAPPERS}
    out = lambda *parts: os.path.join(root, *parts)

    log("[configs] the four kernels at train_nyu.sh's shapes")
    nyu_kernels = nyu_kernels_phase(np.random.RandomState(seed + 40), smi)

    # train_resnet50_depth_256.sh: DispNet-50, B4 N2 832x256, --fused-steps 16.
    log(f"[configs] ResNet-50 fp32 train step on the card against the CPU at B{CHECK_SHAPE[0]} "
        f"N{CHECK_SHAPE[1]} {CHECK_SHAPE[3]}x{CHECK_SHAPE[2]} (tol {GRAD_RTOL_R50})")
    check_step_against_cpu(seed + 41, np.random.RandomState(seed + 41), layers=R50, cfg=auto,
                           grad_rtol=GRAD_RTOL_R50)
    by_path["configs_r50_step"], times = bf16_step(
        "configs r50", make_nets(seed + 42, R50), make_batch(np.random.RandomState(seed + 42)),
        auto)
    report["r50_eager"] = times
    torch.cuda.empty_cache()
    times, launches, n_steps = graphed_bf16("configs r50", make_nets(seed + 43, R50), R50_K,
                                            seed, np.random.RandomState(seed + 43), auto)
    by_path["configs_r50_graph16"] = launches
    if launches != steps_of(n_steps):
        raise AssertionError(f"K={R50_K} graph launches {launches}, "
                             f"expected {steps_of(n_steps)}")
    flops = mfu_report.flop_model(B, N, H, W, num_layers=R50)["useful"]
    times["mfu"] = mfu(flops, times["graph_device_ms_per_step"])
    times["gflop_per_step"] = flops / 1e9
    report["r50_graph16"] = times
    log(f"[configs] ResNet-50 K={R50_K} graph | {smi}: {times['graph_device_ms_per_step']:.4f} "
        f"ms of device time per step, {flops / 1e9:.1f} GFLOP per step "
        f"(mfu_report.flop_model), MFU {100 * times['mfu']:.3f}% of "
        f"{mfu_report.peak_tflops()} TFLOP/s; peak {times['peak_memory_gib']:.3f} GiB; "
        f"launches over {n_steps} steps {launches}")
    log(f"[configs] ResNet-50 graphed fp32 K={GRAPH_K} against eager steps")
    failures += graph_check(seed + 44, np.random.RandomState(seed + 44), False, R50)[2]
    torch.cuda.empty_cache()

    tree = write_jpeg_tree(out("kitti"), seed, R50_SCENES)
    script = "train_resnet50_depth_256.sh"
    argv = config_argv(script, tree, weights, {"--epochs": str(CONFIG_EPOCHS), "--epoch-size":
                                                str(R50_EPOCH_SIZE), "--name": "r50_depth"})
    steps = CONFIG_EPOCHS * R50_EPOCH_SIZE
    save, by_path["configs_r50_cli"], peak = run_config_cli(root, argv, f"configs {script}",
                                                            steps_of(steps))
    check_config_cli(save, "configs r50 cli", steps, R50)
    report["r50_cli"] = {**cli_times(save, "r50_cli", R50_EPOCH_SIZE, R50_EPOCH_SIZE),
                         "peak_memory_gib": peak}
    argv = config_argv(script, tree, weights, {"--epochs": "1", "--epoch-size": str(R50_K),
                                               "--name": "r50_depth_resume"})
    resumed, by_path["configs_r50_cli_resume"], _ = run_config_cli(
        root, argv + ["--resume", save], f"configs {script} --resume", steps_of(R50_K))
    check_config_cli(resumed, "configs r50 cli resume", R50_K, R50, steps + 1, 1)
    log(f"[configs] {script} CLI | {smi}: {report['r50_cli']}")

    # test_kitti_depth.sh with the DispNet-50 just trained.
    text, _, by_path["configs_r50_test_disp"] = run_eval_cli(
        test_disp, ["--resnet-layers", str(R50), "--img-height", str(H), "--img-width", str(W),
                    "--pretrained-dispnet", os.path.join(save, "dispnet_model_best.pth.tar"),
                    "--dataset-dir", eval_paths["depth"], "--output-dir", out("r50_depth")],
        "configs test_disp r50")
    pred = np.load(out("r50_depth", "predictions.npy"))
    if pred.shape != (DEPTH_FRAMES, H, W) or not (np.isfinite(pred).all() and (pred > 0).all()):
        raise AssertionError(f"test_disp --resnet-layers 50: predictions {pred.shape}")
    text, _, by_path["configs_r50_eval_depth"] = run_eval_cli(
        eval_depth, ["--dataset", "kitti", "--pred_depth", out("r50_depth", "predictions.npy"),
                     "--gt_depth", eval_paths["gt"]], "configs eval_depth r50")
    if printed(text, "&").size != 7:
        raise AssertionError("eval_depth: 7 KITTI metrics expected")

    # train_resnet50_pose_256.sh: the same step without --fused-steps.
    tree = write_jpeg_tree(out("odometry"), seed + 1, POSE_SCENES)
    script = "train_resnet50_pose_256.sh"
    argv = config_argv(script, tree, weights, {"--epochs": "1", "--epoch-size": str(POSE_STEPS),
                                               "--name": "r50_pose"})
    val_batches = sum(-(-(n - N) // B) for _, n, split in POSE_SCENES if split == "val")
    want = {k: POSE_STEPS * per_step[k] + val_batches * per_validation[k] for k in WRAPPERS}
    save, by_path["configs_r50_pose_cli"], _ = run_config_cli(root, argv, f"configs {script}",
                                                              want)
    check_config_cli(save, "configs r50 pose cli", POSE_STEPS, R50, epochs=1)
    report["r50_pose_cli"] = cli_times(save, "r50_pose_cli", 1, POSE_STEPS)
    pose_file = os.path.join(save, "exp_pose_model_best.pth.tar")
    text, secs, by_path["configs_test_pose"] = run_eval_cli(
        test_pose, [pose_file, "--img-height", str(H), "--img-width", str(W), "--dataset-dir",
                    eval_paths["odom"], "--sequences", "09", "--output-dir", out("pose")],
        "configs test_pose")
    snippets = np.load(out("pose", "predictions.npy"))
    if snippets.shape != (ODOM_FRAMES - 4, 5, 3, 4) or not np.isfinite(snippets).all():
        raise AssertionError(f"test_pose predictions {snippets.shape}")
    text, secs, by_path["configs_test_vo"] = run_eval_cli(
        test_vo, ["--img-height", str(H), "--img-width", str(W), "--sequence", "09",
                  "--pretrained-posenet", pose_file, "--dataset-dir",
                  os.path.join(eval_paths["odom"], "sequences"), "--output-dir", out("vo")],
        "configs test_vo")
    traj = np.loadtxt(out("vo", "09.txt"))
    if traj.shape != (ODOM_FRAMES, 12) or not np.isfinite(traj).all():
        raise AssertionError(f"test_vo trajectory {traj.shape}")
    text, _, by_path["configs_eval_odom"] = run_eval_cli(
        eval_odom, ["--result", out("vo"), "--gt_dir", eval_paths["poses"], "--align", "7dof",
                    "--seqs", "9", "--no-plot", "--no-confirm"], "configs eval_odom")
    printed(text, "ATE (m):")
    log(f"[configs] {script} | {smi}: {report['r50_pose_cli']}; test_pose {snippets.shape[0]} "
        f"snippets, test_vo {traj.shape[0]} poses from its PoseNet-18")
    torch.cuda.empty_cache()

    # train_nyu.sh: DispNet-18, pair folders, B16 N1 256x320.
    log(f"[configs] NYU fp32 train step on the card against the CPU at B{NYU_CHECK_SHAPE[0]} "
        f"N{NYU_CHECK_SHAPE[1]} {NYU_CHECK_SHAPE[3]}x{NYU_CHECK_SHAPE[2]} (tol {GRAD_RTOL_NYU})")
    b, n, h, w = NYU_CHECK_SHAPE
    check_step_against_cpu(seed + 51, np.random.RandomState(seed + 51), shape=NYU_CHECK_SHAPE,
                           intrinsics=nyu_intrinsics(b, h, w), cfg=auto, grad_rtol=GRAD_RTOL_NYU)
    rng = np.random.RandomState(seed + 52)
    batch = {"tgt": rng.rand(NYU_B, NYU_H, NYU_W, 3).astype(np.float32),
             "refs": rng.rand(NYU_B, NYU_N, NYU_H, NYU_W, 3).astype(np.float32),
             "intrinsics": nyu_intrinsics(NYU_B, NYU_H, NYU_W)}
    by_path["configs_nyu_step"], times = bf16_step("configs nyu", make_nets(seed + 52), batch,
                                                   auto)
    flops = mfu_report.flop_model(NYU_B, NYU_N, NYU_H, NYU_W)["useful"]
    times["mfu"] = mfu(flops, times["train_step_bf16_device_ms"])
    times["gflop_per_step"] = flops / 1e9
    report["nyu_eager"] = times
    log(f"[configs] NYU B{NYU_B} N{NYU_N} {NYU_W}x{NYU_H} bf16 step | {smi}: "
        f"{times['train_step_bf16_device_ms']:.4f} ms of device time (a CUDA-graph replay), "
        f"{flops / 1e9:.1f} GFLOP, MFU {100 * times['mfu']:.3f}%; peak "
        f"{times['peak_memory_gib']:.3f} GiB")
    del batch
    torch.cuda.empty_cache()

    nyu_root = out("nyu")
    with contextlib.redirect_stdout(io.StringIO()):
        make_smoke_nyu.main([nyu_root, "--height", str(NYU_H), "--width", str(NYU_W),
                             "--pairs", str(NYU_CLI_PAIRS)])
    script = "train_nyu.sh"
    argv = config_argv(script, os.path.join(nyu_root, "rectified"), weights,
                       {"--epochs": str(CONFIG_EPOCHS), "--name": "nyu"})
    steps = CONFIG_EPOCHS * (2 * NYU_CLI_PAIRS // NYU_B)
    save, by_path["configs_nyu_cli"], peak = run_config_cli(root, argv, f"configs {script}",
                                                            steps_of(steps))
    check_config_cli(save, "configs nyu cli", steps, 18)
    report["nyu_cli"] = {**cli_times(save, "nyu_cli", 1, steps // CONFIG_EPOCHS),
                         "peak_memory_gib": peak}
    log(f"[configs] {script} CLI | {smi}: {report['nyu_cli']}")
    # test_nyu.sh's chain on the tree's test split.
    test_root = os.path.join(nyu_root, "test")
    _, _, by_path["configs_nyu_test_disp"] = run_eval_cli(
        test_disp, ["--resnet-layers", "18", "--img-height", str(NYU_H), "--img-width",
                    str(NYU_W), "--pretrained-dispnet",
                    os.path.join(save, "dispnet_model_best.pth.tar"), "--dataset-dir",
                    os.path.join(test_root, "color"), "--output-dir", out("nyu_results")],
        "configs test_disp nyu")
    pred = np.load(out("nyu_results", "predictions.npy"))
    if pred.shape != (4, NYU_H, NYU_W) or not np.isfinite(pred).all():
        raise AssertionError(f"test_disp nyu predictions {pred.shape}")
    text, _, by_path["configs_nyu_eval_depth"] = run_eval_cli(
        eval_depth, ["--dataset", "nyu", "--pred_depth", out("nyu_results", "predictions.npy"),
                     "--gt_depth", os.path.join(test_root, "depth.npy"), "--img_dir",
                     os.path.join(test_root, "color"), "--vis_dir", out("nyu_results")],
        "configs eval_depth nyu")
    if printed(text, "&").size != 6:
        raise AssertionError("eval_depth --dataset nyu: 6 NYU metrics expected")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[configs] summary | {smi}: {json.dumps(report)}")
    log(f"[configs] phase {time.perf_counter() - t_phase:.1f} s | {smi}")
    return by_path, nyu_kernels, failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="also print the eval and train steps' device time by kernel "
                        "(torch.profiler)")
    p.add_argument("--graph-seeds", type=int, default=0,
                   help="also repeat the fp32 graph-against-eager check, without and with "
                        "remat, from this many more seeds")
    p.add_argument("--cpu-check-seeds", type=int, default=0,
                   help="also repeat the fp32 train step's card-against-CPU check from this "
                        "many more seeds, and report its worst errors and gate crossings")
    p.add_argument("--cost-volume-only", action="store_true",
                   help="stop after the kernels' phase and the cost volume's")
    p.add_argument("--decoder-input-only", action="store_true",
                   help="run only the build and the decoder-input kernel's phase")
    if argv is None:
        argv = sys.argv[1:]
    if argv[:1] == ["--count-launches"]:
        return count_launches_main(argv[1:])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    smi = device_phase()
    build_phase()
    rng = np.random.RandomState(args.seed)
    if args.decoder_input_only:
        log("[decoder_input] DepthDecoder's inputs against the plain composition")
        print(json.dumps({"kernels": [decoder_input_phase(rng)]}), flush=True)
        return 0
    log("[kernels] against their plain versions at the main path's shapes")
    inputs = warp_inputs(rng)
    kernels = [warp_phase(inputs), warp_bwd_phase(inputs, rng), ssim_phase(rng),
               ssim_bwd_phase(rng)]
    del inputs
    log("[cost_volume] ManyDepth's cost volume against the public per-sample loop")
    cost_volume_kernel = cost_volume_phase(rng)
    if args.cost_volume_only:
        print(json.dumps({"kernels": [cost_volume_kernel]}), flush=True)
        return 0
    log("[decoder_input] DepthDecoder's inputs against the plain composition")
    decoder_input_kernel = decoder_input_phase(rng)
    by_path = slice_phase(args.seed, rng, args.profile)
    by_path["train_step"], step_device_ms = train_phase(args.seed, rng, args.profile)
    log("[augment] the device augmentation on the card against the CPU")
    augment_phase(args.seed, rng)
    log("[remat] an fp32 remat step on the card against a plain step")
    remat_phase(args.seed, rng)
    log("[graph] the train step as CUDA-graph replays of K steps against eager steps")
    # The graph checks' failures fail the run after the phases that follow.
    by_path["train_step_graphed"], failures, graph_device_ms = graph_phase(
        args.seed, rng, by_path["train_step"], step_device_ms)
    for s in range(args.graph_seeds):
        for remat in (False, True):
            found = graph_check(args.seed + 100 + s, rng, remat)[2]
            log(f"[graph] seed {args.seed + 100 + s}, remat {remat}: failures {found}")
            failures += found
        torch.cuda.empty_cache()
    if args.cpu_check_seeds:
        failures += cpu_check_seeds(args.seed, args.cpu_check_seeds)
    log("[cli] the train CLI from a packed dataset on disk, eager and with --fused-steps")
    cli_paths, packed_times = cli_phase(args.seed, by_path["train_step"],
                                        by_path["validation_step"])
    by_path.update(cli_paths)
    log("[distributed] the train CLI with --distributed at world size 1, two ranks, and the "
        "multi-device dry run")
    by_path.update(distributed_phase(args.seed, smi, by_path["train_step"],
                                     by_path["validation_step"], packed_times,
                                     step_device_ms))
    log("[spatial] width-sharded steps against one process, the train CLI with "
        "--spatial-shards 2 and the data x spatial dry run")
    by_path.update(spatial_phase(args.seed, smi, by_path["train_step"],
                                 by_path["validation_step"]))
    staging_phase(args.seed, rng)
    log("[eval] the evaluation and inference CLIs at full width from PNGs on disk")
    by_path.update(eval_phase(args.seed, smi))
    log("[prepare] raw KITTI, KITTI odometry and Cityscapes to the training layout, and "
        "the train CLI from the JPEG tree")
    by_path.update(prepare_phase(args.seed, smi, by_path["train_step"], packed_times))
    log("[checkpoints] the JAX package's .msgpack files: written, evaluated, restored, resumed "
        "and converted at full width")
    by_path.update(checkpoints_phase(args.seed, rng, smi, by_path["train_step"],
                                     by_path["validation_step"]))
    log("[tools] synthetic_scene, overfit_check, mfu_report, profile_step and ablate_step")
    by_path.update(tools_phase(args.seed, smi, by_path["train_step"], graph_device_ms))
    log("[scripts] the port's parity runbooks, SMOKE=1, on the card")
    by_path.update(scripts_phase(smi))
    log("[configs] the other published training configurations: ResNet-50 KITTI depth "
        "(--fused-steps 16) and pose, NYUv2 pair folders at B16")
    config_paths, nyu_kernels, found = configs_phase(args.seed, smi, by_path["train_step"],
                                                     by_path["validation_step"])
    by_path.update(config_paths)
    failures += found
    for k in kernels:
        k["launches"] = by_path["configs_r50_cli"][k["name"]]
        k["launches_per_train_step"] = by_path["train_step"][k["name"]]
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in by_path.items()}
        k["nyu_b16"] = nyu_kernels[k["name"]]
    decoder_input_kernel["launches_per_train_step"] = {
        k: by_path["train_step"][k] for k in ("decoder_input", "decoder_input_bwd")}
    decoder_input_kernel["launches_by_path"] = {
        path: {k: counts[k] for k in ("decoder_input", "decoder_input_bwd")}
        for path, counts in by_path.items()}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if failures:
        raise AssertionError(f"graph checks failed: {failures}")
    print(json.dumps({"kernels": kernels + [cost_volume_kernel, decoder_input_kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
