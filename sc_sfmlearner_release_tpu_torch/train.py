"""SC-Depth training CLI of the PyTorch port.

    python -m sc_sfmlearner_release_tpu_torch.train DIR --name NAME [flags]

The counterpart of the repository's ``train.py`` (the JAX trainer): the same
flags with the same defaults, the same experiment layout
(``checkpoints/<name>/<timestamp>/``), the same tab-separated logs
(``progress_log_summary.csv``, ``progress_log_full.csv``) and optional
TensorBoard, checkpoints in the reference's ``.pth.tar`` layout, and an
exact ``--resume``. ``--pretrained-disp/-pose`` also take the JAX trainer's
``.msgpack`` files and ``--resume`` its save directories
(``train_state.msgpack``), through the port's own msgpack codec. It
trains on one CUDA card (``--device cuda``, the default; it raises without
one) or on the CPU (``--device cpu``).

Not here: ``--sampler`` (the TPU band sampler); argparse rejects it.

``--distributed`` trains data-parallel over the processes that torchrun
starts, one card each (``torchrun --nproc_per_node=N -m
sc_sfmlearner_release_tpu_torch.train DIR ... --distributed``; NCCL on the
cards, gloo with ``--device cpu``). ``-b`` is the global batch, which N must
divide: each process loads its contiguous slice of every batch, and the
step computes what one process computes on the global batch (global
BatchNorm statistics, losses and validation means; gradients summed over
processes; ``parallel/distributed.py``). Every process loads
``--pretrained-*`` and ``--resume``, then takes process 0's networks and
optimizer state; only process 0 writes the experiment directory (logs,
TensorBoard, checkpoints, ``progress_log_*.csv``), and every process waits
at the end of each epoch until its checkpoint is written. Without
torchrun's environment ``--distributed`` exits with an error.

``--spatial-shards S`` (with ``--distributed``) also shards the image width,
as the JAX trainer's ``make_mesh_2d`` mesh does: the world splits into
``world / S`` data groups of S adjacent ranks, each group loads its rows of
every global batch at full width, each rank's step cuts its ``W / S``
columns of them (after ``--device-augment``), and the networks, warps and
losses exchange halos within the
group (``parallel/spatial.py``). S must divide the world size, ``world / S``
the global batch, and 32 * S the frames' width; anything else exits naming
the rule (GSPMD would pad an uneven split; the port refuses it). So
832x256 runs at S = 2 but not at S = 4 (832 / 32 = 26 columns at the
deepest level). ``--fused-steps K > 1`` under ``--distributed`` needs NCCL,
one card per rank: ranks that share a card run over gloo, whose
collectives a CUDA graph cannot capture, and the CLI refuses it there.

``--fused-steps K`` runs K optimizer steps per dispatch
(``make_train_step(fused_steps=K)``): on the card one CUDA-graph replay of
K steps (the first dispatch runs them eagerly, the second captures the
graph), on the CPU K eager steps. K is clamped to the epoch size, K batches
staged on the device are stacked there into one, and a trailing partial
group of an epoch is dropped. Checkpoints and progress lines come where a
dispatch crosses a multiple of ``--checkpoint-freq`` or ``--print-freq``
(the line shows the last of its K steps); the logs keep one row per
optimizer step. ``--profile-dir DIR`` writes a ``torch.profiler`` trace of
exactly one dispatch into DIR: the first after the warm-up (with
``--fused-steps``, after the warm-up and the capture), with the port's spans
of that dispatch (``utils/profiling.py``: the loader's threads, the
dispatch's wait and staging) as events of their own threads.

Each optimizer step's time and data wait go to ``progress_log_time.csv`` in
the experiment directory (``step``, ``data_wait_s``, ``step_s``; seconds):
each of a dispatch's K rows holds the dispatch's wait for its batches / K
and its host time / K, the wait included. Metrics stay on the device during
an epoch, so the card may run behind the host: the last dispatch of an
epoch also counts the wait for the epoch's metrics, and an epoch's rows add
up to its wall time from its first batch to its metrics on the host.

One divergence from the JAX trainer: with ``--packed`` and without
``--with-gt`` the validation snippets come from the packed directory's
``val`` split, not from JPEGs. ``pack_dataset`` stores the decoded frames,
so the batches are the same.

``--arch manydepth`` trains ManyDepth (``training/manydepth.py``: the
teacher, the cost-volume network and the pose network, four-scale minimum
reprojection, adaptive depth bins) instead of SC-Depth, with ManyDepth's
options (``--height/--width``, the frames resized on the device after
``--device-augment``, ``--num-scales`` (4 unless given), ``--num-depth-bins``,
``--disparity-smoothness``, ``--freeze-teacher-epoch``);
``scripts/train_manydepth_kitti.sh`` carries the published values. It logs
each step's metrics and saves ``manydepth.pth.tar`` each epoch, without
validation, on one process.

Example (reference scripts/train_resnet18_depth_256.sh):
  python -m sc_sfmlearner_release_tpu_torch.train $DATA_ROOT --resnet-layers 18 \\
      -b4 -s0.1 -c0.5 --epoch-size 1000 --sequence-length 3 --with-auto-mask 1 \\
      --with-gt --name resnet18_depth_256
"""

from __future__ import annotations

import argparse
import csv
import datetime
import glob
import os
import sys
import time

import numpy as np
import torch

from . import cli_device
from .data import (BatchLoader, PackedSequenceSet, PairSet, SequenceSet, ValidationSet,
                   transforms)
from .data.device_augment import AugmentConfig, make_device_augment
from .inference import restore_disp_state, restore_pose_state
from .models import DispNet, PoseNet
from .models.convert import graft_imagenet_encoder, load_torch_state_dict
from .parallel import device_prefetch, distributed
from .training import (
    LossConfig, create_train_state, make_eval_depth_step, make_eval_step,
    make_inference_fn, make_optimizer, make_train_step,
)
from .training.checkpoint import restore_train_state, save_checkpoint
from .training.step import METRIC_KEYS
from .utils import AverageMeter, enable_nan_debugging, make_logger, tensor2array, trace

TIME_LOG = "progress_log_time.csv"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Structure from Motion Learner training on KITTI and "
        "CityScapes Dataset (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("data", metavar="DIR", help="path to dataset")
    p.add_argument("--folder-type", choices=["sequence", "pair"], default="sequence")
    p.add_argument("--sequence-length", type=int, default=3)
    p.add_argument("-j", "--workers", type=int, default=8)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--epoch-size", type=int, default=0,
                   help="manual epoch size (dataset size if 0)")
    p.add_argument("-b", "--batch-size", type=int, default=4)
    p.add_argument("--lr", "--learning-rate", type=float, default=1e-4)
    p.add_argument("--momentum", type=float, default=0.9, help="adam beta1")
    p.add_argument("--beta", type=float, default=0.999, help="adam beta2")
    p.add_argument("--weight-decay", "--wd", type=float, default=0)
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-summary", default="progress_log_summary.csv")
    p.add_argument("--log-full", default="progress_log_full.csv")
    p.add_argument("--log-output", action="store_true")
    p.add_argument("--resnet-layers", type=int, default=18, choices=[18, 50])
    p.add_argument("--num-scales", "--number-of-scales", type=int, default=None,
                   help="scales of the loss (default 1; 4 with --arch manydepth)")
    p.add_argument("-p", "--photo-loss-weight", type=float, default=1)
    p.add_argument("-s", "--smooth-loss-weight", type=float, default=0.1)
    p.add_argument("-c", "--geometry-consistency-weight", type=float, default=0.5)
    p.add_argument("--with-ssim", type=int, default=1)
    p.add_argument("--with-mask", type=int, default=1)
    p.add_argument("--with-auto-mask", type=int, default=0)
    p.add_argument("--with-pretrain", type=int, default=1,
                   help="ImageNet-pretrained encoder init; weights are "
                   "resolved from --imagenet-weights-dir, then "
                   "$SCDEPTH_IMAGENET_DIR, then the torchvision hub cache "
                   "(~/.cache/torch/hub/checkpoints). Published reference "
                   "accuracy depends on this init — a missing weights "
                   "source is a hard error, never a silent random init")
    p.add_argument("--imagenet-weights-dir", default=None,
                   help="directory holding torchvision ImageNet weights "
                   "(resnet{18,50}.pth or hub-named resnet18-*.pth) for "
                   "encoder init")
    p.add_argument("--dataset", choices=["kitti", "nyu"], default="kitti")
    p.add_argument("--pretrained-disp", default=None,
                   help="path to pretrained DispNet (.msgpack or torch .pth.tar)")
    p.add_argument("--pretrained-pose", default=None,
                   help="path to pretrained PoseNet (.msgpack or torch .pth.tar)")
    p.add_argument("--resume", default=None,
                   help="checkpoint dir to resume full train state from (the port's "
                   "train_state.pth.tar or the JAX trainer's train_state.msgpack)")
    p.add_argument("--name", required=True)
    p.add_argument("--padding-mode", choices=["zeros", "border"], default="zeros")
    p.add_argument("--device-augment", action="store_true",
                   help="run flip/scale-crop/normalize on the device inside "
                   "the train step (the host only decodes)")
    p.add_argument("--packed", action="store_true",
                   help="read training frames from DIR/packed (raw uint8 "
                   "memmap built by `python -m sc_sfmlearner_release_tpu_torch."
                   "data.packed DIR`); per-step host work drops to a memcpy "
                   "and the host-to-device copy carries uint8. With "
                   "--device-augment the host ships raw uint8 and everything "
                   "else runs on the device")
    p.add_argument("--with-gt", action="store_true")
    p.add_argument("--skip-frames", type=int, default=1)
    p.add_argument("--val-batches", type=int, default=0,
                   help="cap validation batches (0 = all)")
    p.add_argument("--no-tensorboard", action="store_true")
    p.add_argument("--log-style", choices=["auto", "bars", "line"],
                   default="auto",
                   help="terminal UI: 'bars' = the reference's fixed-"
                   "position epoch/train/valid bars (logger.py), 'line' = "
                   "plain single-line updates; 'auto' picks bars on a TTY")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (host and card) of one "
                   "train dispatch after the warm-up into this directory "
                   "(view with TensorBoard or Perfetto)")
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly (the reference's "
                   "anomaly detection, opt-in)")
    p.add_argument("--precision", choices=["bf16", "fp32"], default="bf16",
                   help="convolution precision (parameters, BN statistics, "
                   "heads, geometry and losses always fp32)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="train on the CUDA card (raises without one) or on the CPU")
    p.add_argument("--fused-steps", type=int, default=1,
                   help="run N optimizer steps per device dispatch "
                   "(one CUDA-graph replay of N steps over N stacked batches); "
                   "hides host dispatch latency. Per-step metrics are still "
                   "logged individually")
    p.add_argument("--remat", action="store_true",
                   help="recompute activations in the backward pass "
                   "(torch.utils.checkpoint): slower per step, less memory")
    p.add_argument("--checkpoint-freq", type=int, default=0,
                   help="also save the full train state every N steps "
                   "(preemption resilience; 0 = per-epoch only)")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel training over the processes torchrun starts "
                   "(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT; one card "
                   "each, NCCL; gloo with --device cpu); each process feeds its "
                   "disjoint slice of every global batch (-b)")
    p.add_argument("--spatial-shards", type=int, default=1,
                   help="with --distributed: shard each image's width over this many "
                   "adjacent processes (halo exchanges around every conv, pad, pool, "
                   "SSIM and warp); it must divide the world size, world / S the "
                   "global batch, and 32 * S the frames' width")
    p.add_argument("--full-state-freq", type=int, default=1,
                   help="write the full resume state every N epochs (model "
                   "weights are written every epoch regardless); the full "
                   "state is ~3x the bytes")
    md = p.add_argument_group("ManyDepth (--arch manydepth; manydepth/options.py's defaults)")
    md.add_argument("--arch", choices=["sc_depth", "manydepth"], default="sc_depth",
                    help="the train step: SC-Depth's, or ManyDepth's (teacher, cost-volume "
                    "network and pose network; needs --device-augment)")
    md.add_argument("--height", type=int, default=192,
                    help="ManyDepth trains at this height: the augmented frames are resized "
                    "on the device")
    md.add_argument("--width", type=int, default=640)
    md.add_argument("--min-depth", type=float, default=0.1)
    md.add_argument("--max-depth", type=float, default=100.0)
    md.add_argument("--num-depth-bins", type=int, default=96)
    md.add_argument("--disparity-smoothness", type=float, default=1e-3)
    md.add_argument("--freeze-teacher-epoch", type=int, default=15,
                    help="from this epoch on the teacher and the pose network are frozen: "
                    "Adam over the multi-frame network alone, the trackers fixed")
    return p


def find_imagenet_weights(explicit_dir, num_layers: int):
    """Locate a torchvision ImageNet ``.pth`` for resnet{num_layers}.

    Search order: --imagenet-weights-dir, $SCDEPTH_IMAGENET_DIR, the
    torchvision hub cache (~/.cache/torch/hub/checkpoints). Accepts both
    plain ``resnet18.pth`` and hub-named ``resnet18-f37072fd.pth``.
    Returns the path or None.
    """
    candidates = [
        explicit_dir,
        os.environ.get("SCDEPTH_IMAGENET_DIR"),
        os.path.expanduser("~/.cache/torch/hub/checkpoints"),
    ]
    for d in candidates:
        if not d or not os.path.isdir(d):
            continue
        exact = os.path.join(d, f"resnet{num_layers}.pth")
        if os.path.isfile(exact):
            return exact
        hits = sorted(glob.glob(os.path.join(d, f"resnet{num_layers}-*.pth")))
        if hits:
            return hits[0]
    return None


def _missing_imagenet(name: str) -> SystemExit:
    return SystemExit(
        f"--with-pretrain 1 but no ImageNet weights for {name} were found. "
        "Published reference accuracy (Abs Rel 0.119/0.114) depends on this "
        "init — refusing to silently train from random weights.\n"
        "Stage torchvision .pth files (resnet18.pth / resnet50.pth, or "
        "hub-named resnet18-*.pth) in one of:\n"
        "  --imagenet-weights-dir DIR\n"
        "  $SCDEPTH_IMAGENET_DIR\n"
        "  ~/.cache/torch/hub/checkpoints  (torchvision's download cache)\n"
        "Or pass --with-pretrain 0 to train from scratch deliberately."
    )


def _load_net(net, restore, path: str) -> None:
    """Reference-layout ``.pth.tar`` or JAX ``.msgpack`` weights into ``net``."""
    try:
        state_dict = restore(path)
    except ValueError as exc:
        raise SystemExit(f"cannot load pretrained weights: {exc}") from exc
    net.load_state_dict(state_dict)


def _datasets(args):
    train_tf = (transforms.raw_train_transform() if args.device_augment
                else transforms.train_transform())
    valid_tf = transforms.valid_transform()
    packed_dir = None
    if args.packed:
        if args.folder_type != "sequence":
            raise SystemExit("--packed supports --folder-type sequence")
        packed_dir = os.path.join(args.data, "packed")
        if not os.path.isdir(packed_dir):
            raise SystemExit(
                f"--packed: {packed_dir} not found; build it once with "
                f"`python -m sc_sfmlearner_release_tpu_torch.data.packed {args.data}`")
        # Under --device-augment the packed loader ships raw uint8.
        train_set = PackedSequenceSet(
            packed_dir, train=True, sequence_length=args.sequence_length,
            skip_frames=args.skip_frames,
            transform=None if args.device_augment else train_tf)
    elif args.folder_type == "sequence":
        train_set = SequenceSet(args.data, train=True, sequence_length=args.sequence_length,
                                skip_frames=args.skip_frames, transform=train_tf,
                                dataset=args.dataset)
    else:
        train_set = PairSet(args.data, train=True, transform=train_tf)

    if args.with_gt:
        val_set = ValidationSet(args.data, transform=valid_tf, dataset=args.dataset)
    elif packed_dir is not None:
        # The packed frames are the decoded JPEGs: the same batches.
        val_set = PackedSequenceSet(packed_dir, train=False,
                                    sequence_length=args.sequence_length,
                                    skip_frames=args.skip_frames, transform=valid_tf)
    elif args.folder_type == "sequence":
        val_set = SequenceSet(args.data, train=False, sequence_length=args.sequence_length,
                              skip_frames=args.skip_frames, transform=valid_tf,
                              dataset=args.dataset)
    else:
        val_set = PairSet(args.data, train=False, transform=valid_tf)
    return train_set, val_set


def _networks(args):
    g = torch.Generator().manual_seed(args.seed)
    disp_net = DispNet(args.resnet_layers, generator=g)
    pose_net = PoseNet(18, generator=g)
    if args.with_pretrain:
        disp_pth = find_imagenet_weights(args.imagenet_weights_dir, args.resnet_layers)
        pose_pth = find_imagenet_weights(args.imagenet_weights_dir, 18)
        if disp_pth is None or pose_pth is None:
            if not (args.pretrained_disp and args.pretrained_pose):
                raise _missing_imagenet(f"resnet{args.resnet_layers}"
                                        if disp_pth is None else "resnet18")
            # Full warm-start checkpoints supersede the ImageNet init.
            print("=> --with-pretrain: no ImageNet weights found, but "
                  "both nets are warm-started from checkpoints")
        else:
            print(f"=> ImageNet encoder init: disp={disp_pth} pose={pose_pth}")
            graft_imagenet_encoder(disp_net, load_torch_state_dict(disp_pth),
                                   args.resnet_layers, 1)
            graft_imagenet_encoder(pose_net, load_torch_state_dict(pose_pth), 18, 2)
    if args.pretrained_disp:
        print("=> using pre-trained weights for DispNet")
        _load_net(disp_net, lambda path: restore_disp_state(path, args.resnet_layers),
                  args.pretrained_disp)
    if args.pretrained_pose:
        print("=> using pre-trained weights for PoseNet")
        _load_net(pose_net, restore_pose_state, args.pretrained_pose)
    return disp_net, pose_net


def _grouped(batches, k: int):
    """Group ``k`` consecutive staged ``(batch, n_valid)`` pairs into one
    batch stacked on a new leading axis, on the device (the JAX trainer's
    ``_stack_fused``); ``k = 1`` passes them through. A trailing partial
    group is dropped (training loaders drop the last batch anyway)."""
    if k == 1:
        yield from batches
        return
    group = []
    for batch, _ in batches:
        group.append(batch)
        if len(group) == k:
            yield {key: torch.stack([g[key] for g in group]) for key in group[0]}, None
            group = []


class _Dispatcher:
    """The train loop's dispatches of ``fused`` optimizer steps each, counted
    from step ``start``: one of them traced into ``profile_dir`` (after the
    warm-up and, with ``fused`` > 1, the capture), each's data wait and host
    time (``t_data``, ``t_step``, this epoch's), and one sync for an epoch's
    metrics."""

    def __init__(self, device: torch.device, fused: int, profile_dir=None, start: int = 0):
        self.device, self.fused, self.profile_dir, self.start = device, fused, profile_dir, start
        self.n_iter = 0
        self.profile_from = 2 * fused if fused > 1 else 1
        self.t_data, self.t_step = AverageMeter(), AverageMeter()

    def epoch(self, train_step, loader, epoch_size: int, keys, each=None):
        """One epoch of ``train_step`` over ``loader``'s batches, at most
        ``epoch_size`` steps; ``each(metrics, prev_iter, epoch_steps)`` after
        each dispatch. Returns one row of ``keys`` per optimizer step, and
        one ``[step, data_wait_s, step_s]`` row per optimizer step: each of a
        dispatch's K rows holds its wait / K and its host time / K, the last
        dispatch's with the wait for the epoch's metrics."""
        self.t_data, self.t_step = AverageMeter(), AverageMeter()
        pending, dispatches, steps = [], [], 0  # dispatches: [first step, wait, host time]
        end = time.perf_counter()
        for batch, _ in _grouped(device_prefetch(loader, self.device), self.fused):
            if steps >= epoch_size:
                break
            waited = time.perf_counter() - end
            self.t_data.update(waited)
            profile = bool(self.profile_dir) and self.n_iter >= self.profile_from
            # The trace spans exactly this dispatch, until the card has run it.
            with trace(self.profile_dir if profile else None):
                metrics = train_step(batch)
                if profile:
                    _synchronize(self.device)
                    self.profile_dir = None
            prev, self.n_iter = self.n_iter, self.n_iter + self.fused
            steps += self.fused
            pending.append(metrics)
            if each is not None:
                each(metrics, prev, steps)
            now = time.perf_counter()
            self.t_step.update(now - end)
            dispatches.append([self.start + prev + 1, waited, now - end])
            end = now
        # metrics stay on the device; one sync for the whole epoch's. Fused
        # metrics carry a leading [K] axis: one row per optimizer step either way.
        rows = []
        if pending:
            rows = torch.cat([torch.stack([m[k].reshape(-1) for k in keys], 1)
                              for m in pending]).double().cpu().tolist()
            dispatches[-1][2] += time.perf_counter() - end  # the wait for those metrics
        times = [[first + j, waited / self.fused, secs / self.fused]
                 for first, waited, secs in dispatches for j in range(self.fused)]
        return rows, times


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _write_rows(path: str, rows, mode: str = "a") -> None:
    with open(path, mode, newline="") as f:
        csv.writer(f, delimiter="\t").writerows(rows)


def _run_dir(args, is_main: bool = True) -> str:
    """The experiment directory, ``checkpoints/<name>/<timestamp>/``, made
    by process 0."""
    save_path = os.path.join("checkpoints", args.name,
                             datetime.datetime.now().strftime("%m-%d-%H:%M"))
    if is_main:
        os.makedirs(save_path, exist_ok=True)
        print(f"=> will save everything to {save_path}")
    return save_path


def _train_loader(args, device: torch.device, train_set):
    """The shuffled training batches of this process's data group (its rows
    at full width; the steps cut the columns), the epoch size in steps, and
    ``--fused-steps`` clamped to it."""
    loader = BatchLoader(train_set, args.batch_size, shuffle=True, num_workers=args.workers,
                         drop_last=True, seed=args.seed, pin_memory=device.type == "cuda",
                         process_index=distributed.data_index(),
                         process_count=distributed.data_count())
    epoch_size = args.epoch_size or len(loader)
    fused = max(args.fused_steps, 1)
    if fused > 1 and fused > epoch_size:
        # Trailing partial groups are dropped: a group larger than the
        # epoch would train zero steps per epoch.
        print(f"=> clamping --fused-steps {fused} to epoch size {epoch_size}")
        fused = max(1, epoch_size)
    return loader, epoch_size, fused


def _start_logs(args, save_path: str, full_header) -> None:
    """The header rows of ``progress_log_full.csv`` (one row of the step's
    metrics per optimizer step) and ``progress_log_time.csv``."""
    _write_rows(os.path.join(save_path, args.log_full), [list(full_header)], "w")
    _write_rows(os.path.join(save_path, TIME_LOG), [["step", "data_wait_s", "step_s"]], "w")


def _check_layout(args, device: torch.device, train_set) -> None:
    """The rules of ``--spatial-shards`` and ``--fused-steps`` under
    ``--distributed`` that need no process group; a SystemExit naming the
    rule that a run breaks."""
    shards = args.spatial_shards
    if shards < 1:
        raise SystemExit(f"--spatial-shards {shards}: must be at least 1")
    if shards > 1 and not args.distributed:
        raise SystemExit(f"--spatial-shards {shards} needs --distributed (torchrun's "
                         "processes share each image's width)")
    if (args.distributed and args.fused_steps > 1 and device.type == "cuda"
            and distributed.backend_for(device) == "gloo"):
        raise SystemExit(f"--fused-steps {args.fused_steps} under --distributed needs NCCL, "
                         "one card per process: these processes share cards through gloo, "
                         "whose collectives a CUDA graph cannot capture (use --fused-steps 1)")
    if shards > 1 and len(train_set):
        width = train_set.load(0, np.random.default_rng(0))["tgt"].shape[-2]
        if width % (32 * shards):
            raise SystemExit(f"--spatial-shards {shards}: the frames' width {width} is not a "
                             f"multiple of 32 * {shards} = {32 * shards} (every shard of the "
                             "deepest feature map needs whole columns)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.num_scales is None:
        args.num_scales = 4 if args.arch == "manydepth" else 1
    device = cli_device(args.device)
    datasets = _datasets(args)
    if args.arch == "manydepth":
        return _train_manydepth(args, device, datasets[0])
    _check_layout(args, device, datasets[0])
    if not args.distributed:
        return _train(args, device, datasets)
    try:
        # Before anything else touches the card: binds cuda:LOCAL_RANK.
        device = distributed.init_distributed(device, args.spatial_shards)
    except (RuntimeError, ValueError) as exc:
        raise SystemExit(f"--distributed: {exc}") from exc
    try:
        code = _train(args, device, datasets)
        distributed.barrier()
        return code
    finally:
        distributed.leave()


def _train(args, device: torch.device, datasets) -> int:
    proc_idx, proc_cnt = distributed.process_index(), distributed.process_count()
    shards, groups = distributed.spatial_count(), distributed.data_count()
    if proc_cnt > 1:
        print(f"=> process {proc_idx}/{proc_cnt} on {device}"
              + (f": data group {distributed.data_index()}/{groups}, column slice "
                 f"{distributed.spatial_index()}/{shards}" if shards > 1 else ""))
    if args.batch_size % groups:
        raise SystemExit(f"-b {args.batch_size} (the global batch) is not divisible by "
                         f"{groups} " + ("processes" if shards == 1 else
                                         "data groups (world / --spatial-shards)"))
    is_main = proc_idx == 0  # only process 0 writes checkpoints and logs
    if args.debug_nans:
        enable_nan_debugging()

    save_path = _run_dir(args, is_main)

    tb_writer = None
    output_writers = []
    # Under width sharding every process infers the logged images' columns:
    # the others hold None in place of process 0's writers.
    if not args.no_tensorboard and (is_main or shards > 1):
        try:
            from tensorboardX import SummaryWriter

            if is_main:
                tb_writer = SummaryWriter(save_path)
            if args.log_output:
                output_writers = [SummaryWriter(os.path.join(save_path, "valid", str(i)))
                                  if is_main else None for i in range(3)]
        except ImportError:
            pass

    # ---- data ------------------------------------------------------------
    train_set, val_set = datasets
    print(f"{len(train_set)} samples found in {len(train_set.scenes)} train scenes")
    print(f"{len(val_set)} samples found in {len(val_set.scenes)} valid scenes")
    train_loader, epoch_size, fused = _train_loader(args, device, train_set)
    val_loader = BatchLoader(val_set, args.batch_size, shuffle=False,
                             num_workers=args.workers, drop_last=False, seed=args.seed,
                             pin_memory=device.type == "cuda",
                             process_index=distributed.data_index(), process_count=groups)

    # ---- models / state --------------------------------------------------
    disp_net, pose_net = _networks(args)
    disp_net.to(device)
    pose_net.to(device)
    # A CUDA graph of the step needs Adam's step count on the card.
    optimizer = make_optimizer(disp_net, pose_net, args.lr, args.momentum, args.beta,
                               args.weight_decay,
                               capturable=fused > 1 and device.type == "cuda")
    state = create_train_state(disp_net, pose_net, optimizer, seed=args.seed)
    if args.resume:
        print(f"=> resuming full train state from {args.resume}")
        restore_train_state(args.resume, state)
        print(f"=> resumed at step {state.step}")
    # Every process starts from process 0's networks and optimizer state.
    distributed.replicate(disp_net, pose_net, optimizer)
    # Adam's count, read once (a capturable Adam keeps it on the card):
    # the loop counts steps on the host from here.
    start_step = state.step

    cfg = LossConfig(
        photo_weight=args.photo_loss_weight,
        smooth_weight=args.smooth_loss_weight,
        geometry_weight=args.geometry_consistency_weight,
        num_scales=args.num_scales,
        with_ssim=bool(args.with_ssim),
        with_mask=bool(args.with_mask),
        with_auto_mask=bool(args.with_auto_mask),
        padding_mode=args.padding_mode,
    )
    augment_fn = make_device_augment(AugmentConfig()) if args.device_augment else None
    train_step = make_train_step(disp_net, pose_net, optimizer, cfg, device=device,
                                 precision=args.precision, remat=args.remat,
                                 augment_fn=augment_fn, aug_seed=args.seed, fused_steps=fused)
    eval_step = make_eval_step(disp_net, pose_net, cfg, device=device,
                               precision=args.precision)
    eval_depth_step = make_eval_depth_step(disp_net, args.dataset, device=device,
                                           precision=args.precision)
    infer = make_inference_fn(disp_net, device=device, precision=args.precision)

    # ---- logging ---------------------------------------------------------
    if is_main:
        _write_rows(os.path.join(save_path, args.log_summary),
                    [["train_loss", "validation_loss"]], "w")
        _start_logs(args, save_path, ["train_loss", "photo_loss", "smooth_loss",
                                      "geometry_consistency_loss"])

    logger = make_logger(args.epochs, epoch_size, len(val_loader), style=args.log_style,
                         is_main=is_main)
    best_error = -1.0
    dispatcher = _Dispatcher(device, fused, args.profile_dir if is_main else None, start_step)

    for epoch in range(args.epochs):
        logger.start_epoch(epoch)
        train_loader.set_epoch(epoch)

        # ---- train -------------------------------------------------------
        losses = AverageMeter(precision=4)

        def each(metrics, prev_iter, epoch_steps):
            n_iter = prev_iter + fused
            if is_main and args.checkpoint_freq and (
                    n_iter // args.checkpoint_freq > prev_iter // args.checkpoint_freq):
                save_checkpoint(save_path, state, is_best=False, epoch=epoch)
            # did [prev_iter, n_iter) contain a multiple of print_freq?
            if (n_iter - 1) // args.print_freq > (prev_iter - 1) // args.print_freq:
                m = {k: float(v.reshape(-1)[-1]) for k, v in metrics.items()}
                losses.update(m["loss"], args.batch_size)
                if tb_writer is not None:
                    tb_writer.add_scalar("photometric_error", m["photo_loss"], n_iter)
                    tb_writer.add_scalar("disparity_smoothness_loss", m["smooth_loss"], n_iter)
                    tb_writer.add_scalar("geometry_consistency_loss", m["geometry_loss"],
                                         n_iter)
                    tb_writer.add_scalar("total_loss", m["loss"], n_iter)
                logger.train_update(min(epoch_steps, epoch_size),
                                    f"Time {dispatcher.t_step} Data {dispatcher.t_data} "
                                    f"Loss {losses}")

        full_rows, times = dispatcher.epoch(train_step, train_loader, epoch_size, METRIC_KEYS,
                                            each)
        logger.train_update(min(len(full_rows), epoch_size), "")
        train_loss = float(np.mean([r[0] for r in full_rows])) if full_rows else 0.0
        logger.write(f" * Avg Loss : {train_loss:.3f}")
        if is_main:
            _write_rows(os.path.join(save_path, args.log_full), full_rows)
            _write_rows(os.path.join(save_path, TIME_LOG), times)

        # ---- validate ----------------------------------------------------
        validate = _validate_with_gt if args.with_gt else _validate_without_gt
        errors, error_names = validate(
            args, device_prefetch(val_loader, device),
            eval_depth_step if args.with_gt else eval_step, logger, output_writers, infer,
            epoch)
        err_str = ", ".join(f"{n} : {e:.3f}" for n, e in zip(error_names, errors))
        logger.write(f" * Avg {err_str}")
        if tb_writer is not None:
            for err, name in zip(errors, error_names):
                tb_writer.add_scalar(name, err, epoch)

        decisive_error = errors[1]
        if best_error < 0:
            best_error = decisive_error
        is_best = decisive_error <= best_error
        best_error = min(best_error, decisive_error)
        if is_main:
            save_checkpoint(
                save_path, state, is_best, epoch=epoch + 1,
                full_state=(epoch + 1) % max(args.full_state_freq, 1) == 0
                or epoch + 1 == args.epochs,
            )
            _write_rows(os.path.join(save_path, args.log_summary),
                        [[train_loss, decisive_error]])
        # No process leaves an epoch before its checkpoint is on disk.
        distributed.barrier()

    logger.finish()
    for writer in [tb_writer] + output_writers:
        if writer is not None:
            writer.close()
    return 0


def _manydepth_rules(args) -> None:
    """What ``--arch manydepth`` trains with; a SystemExit naming a flag it
    does not take."""
    refused = [("--distributed", args.distributed), ("--resume", args.resume),
               ("--with-gt", args.with_gt), ("--remat", args.remat),
               ("--pretrained-disp/-pose", args.pretrained_disp or args.pretrained_pose),
               ("--folder-type pair", args.folder_type != "sequence")]
    for flag, on in refused:
        if on:
            raise SystemExit(f"--arch manydepth does not take {flag}")
    if not args.device_augment:
        raise SystemExit("--arch manydepth needs --device-augment (the resize and the "
                         "matching draws run on the device)")
    if args.sequence_length != 3 or args.resnet_layers != 18:
        raise SystemExit("--arch manydepth trains ResNet-18 networks on 3-frame snippets "
                         "(frames 0, -1, +1)")


def _train_manydepth(args, device: torch.device, train_set) -> int:
    """ManyDepth's training (``training/manydepth.py``) through the port's
    loader, ``device_prefetch``, the device augmentation and, with
    ``--fused-steps``, ``_GraphedSteps``: one row of its metrics per step in
    ``progress_log_full.csv``, the times in ``progress_log_time.csv``, and
    each epoch's networks, optimizer and trackers in ``manydepth.pth.tar``.
    No validation: the public trainer's is a depth evaluation of its own."""
    from .models.manydepth import ManyDepth
    from .training.manydepth import (METRIC_KEYS as MANYDEPTH_KEYS, ManyDepthConfig,
                                     MatchingAugment, make_manydepth_optimizer,
                                     make_manydepth_train_step, make_trackers)

    _manydepth_rules(args)
    save_path = _run_dir(args)
    print(f"{len(train_set)} samples found in {len(train_set.scenes)} train scenes")
    loader, epoch_size, fused = _train_loader(args, device, train_set)
    model = ManyDepth(args.resnet_layers, args.num_depth_bins,
                      generator=torch.Generator().manual_seed(args.seed))
    if args.with_pretrain:  # the public --weights_init pretrained: every ResNet from ImageNet
        pth = find_imagenet_weights(args.imagenet_weights_dir, 18)
        if pth is None:
            raise _missing_imagenet("resnet18")
        print(f"=> ImageNet encoder init: {pth}")
        sd = load_torch_state_dict(pth)
        for net, images in ((model.mono, 1), (model.multi, 1), (model.pose, 2)):
            graft_imagenet_encoder(net, sd, 18, images)
    model.to(device)
    cfg = ManyDepthConfig(height=args.height, width=args.width, num_scales=args.num_scales,
                          min_depth=args.min_depth, max_depth=args.max_depth,
                          num_depth_bins=args.num_depth_bins,
                          disparity_smoothness=args.disparity_smoothness)
    augment = MatchingAugment(make_device_augment(AugmentConfig()), args.height, args.width)
    trackers = make_trackers(cfg, device)
    capturable = fused > 1 and device.type == "cuda"

    def build(teacher: bool):
        """Adam over all three networks, or over the multi-frame network
        alone once the teacher is frozen, and the step over it."""
        optimizer = make_manydepth_optimizer(model if teacher else model.multi, args.lr,
                                             capturable)
        return optimizer, make_manydepth_train_step(model, optimizer, cfg, device,
                                                    args.precision, augment, args.seed, fused,
                                                    trackers, teacher)

    optimizer, train_step = build(args.freeze_teacher_epoch > 0)
    _start_logs(args, save_path, MANYDEPTH_KEYS)
    dispatcher = _Dispatcher(device, fused, args.profile_dir)
    for epoch in range(args.epochs):
        if epoch == args.freeze_teacher_epoch and epoch > 0:
            print(f"=> epoch {epoch}: freezing the teacher and the pose network")
            optimizer, train_step = build(False)
        loader.set_epoch(epoch)
        rows, times = dispatcher.epoch(train_step, loader, epoch_size, MANYDEPTH_KEYS)
        loss = float(np.mean([r[0] for r in rows])) if rows else 0.0
        print(f"epoch {epoch}: {len(rows)} steps, * Avg Loss : {loss:.4f}, depth bins "
              f"{rows[-1][-2]:.3f}-{rows[-1][-1]:.3f}" if rows else f"epoch {epoch}: no steps")
        _write_rows(os.path.join(save_path, args.log_full), rows)
        _write_rows(os.path.join(save_path, TIME_LOG), times)
        torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                    "trackers": trackers.cpu(), "epoch": epoch + 1, "step": dispatcher.n_iter,
                    "args": vars(args)}, os.path.join(save_path, "manydepth.pth.tar"))
    return 0


def _log_val_images(writers, infer, img_batch, i, epoch):
    """TB depth/disparity images for the first len(writers) val batches
    (reference behavior: train.py:328-337, 390-408); under width sharding
    every process infers (the disparity is gathered within its data group),
    and process 0 writes (the others' writers are None)."""
    if i >= len(writers):
        return
    disp = infer(img_batch)[0]
    w = writers[i]
    if w is None:
        return
    disp = disp[0, ..., 0].float().cpu().numpy()
    img = img_batch[0].float().cpu().numpy()
    if epoch == 0:
        w.add_image("val Input", tensor2array(img), 0, dataformats="HWC")
    w.add_image("val Dispnet Output Normalized",
                tensor2array(disp, max_value=None, colormap="magma"), epoch, dataformats="HWC")
    w.add_image("val Depth Output", tensor2array(1.0 / disp, max_value=10), epoch,
                dataformats="HWC")


def _validate_with_gt(args, batches, eval_depth_step, logger, output_writers=(), infer=None,
                      epoch=0):
    names = ["abs_diff", "abs_rel", "sq_rel", "a1", "a2", "a3"]
    meter = AverageMeter(i=len(names))
    for i, (batch, n_valid) in enumerate(batches):
        if args.val_batches and i >= args.val_batches:
            break
        batch["n_valid"] = n_valid
        metrics = eval_depth_step(batch)
        if output_writers:
            _log_val_images(output_writers, infer, batch["img"], i, epoch)
        meter.update([float(metrics[n]) for n in names], n=n_valid)
        if i % args.print_freq == 0:
            logger.valid_update(i + 1, f"Abs Error {meter.avg[0]:.4f}")
    return meter.avg, names


def _validate_without_gt(args, batches, eval_step, logger, output_writers=(), infer=None,
                         epoch=0):
    names = ["Total loss", "Photo loss", "Smooth loss", "Consistency loss"]
    meter = AverageMeter(i=4, precision=4)
    for i, (batch, n_valid) in enumerate(batches):
        if args.val_batches and i >= args.val_batches:
            break
        batch["n_valid"] = n_valid
        m = eval_step(batch)
        if output_writers:
            _log_val_images(output_writers, infer, batch["tgt"], i, epoch)
        photo = float(m["photo_loss"])
        meter.update([photo, photo, float(m["smooth_loss"]), float(m["geometry_loss"])],
                     n=n_valid)
        if i % args.print_freq == 0:
            logger.valid_update(i + 1, f"Loss {meter}")
    return meter.avg, names


if __name__ == "__main__":
    sys.exit(main())
