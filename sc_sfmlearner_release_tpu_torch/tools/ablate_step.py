"""Device time of the graphed train step with one component changed at a time.

The counterpart of the repository's ``tools/ablate_step.py``: each variant
of :data:`CONFIGS` is the JAX tool's variant of the same name (its
``build``), as far as the port has it, built at B4 N2 832x256 (ResNet-18,
bf16 convolutions, Adam, SSIM, the self-discovered and auto masks, device
augmentation of uint8 frames) and run as ``make_train_step(fused_steps=K)``,
one CUDA-graph replay of K steps (K = 16 unless the variant or
``--fused`` says otherwise). Its time is the device time per optimizer
step from CUDA events around ``--n`` back-to-back replays after the
warm-up and the capture, the median of ``--reps`` such windows, with
their spread.

``convs_only`` and its kin keep the networks' forward, backward and
optimizer only: the loss is the sum of the target frames' depths and the
poses (x 1e-6), in place of the warp, SSIM and losses. Left out: the JAX
tool's ``band*`` sampler variants, the ``*unpacked*`` and packed-decoder
variants and the ``stem``/``enc_only`` splits, which time TPU formulations
the port does not have (ROADMAP); an unknown name raises.

A variant that fails prints a ``FAILED`` line and the others still run;
the exit code is non-zero if any failed.

    python -m sc_sfmlearner_release_tpu_torch.tools.ablate_step [--configs full,no_ssim,...]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from .. import cli_device, disable_tf32
from ..data.device_augment import AugmentConfig, make_device_augment, step_generator
from ..models import DispNet, PoseNet
from ..training import LossConfig, make_optimizer, make_train_step
from ..training.step import (
    METRIC_KEYS, SNIPPET_KEYS, _GraphedSteps, _to_device, compute_depth, compute_pose_with_inv,
    conv_autocast,
)
from ..utils.profiling import card_line

B, N, H, W = 4, 2, 256, 832
FUSED = 16
LR = 1e-4
KITTI_K = ((241.67, 0.0, W / 2), (0.0, 246.28, H / 2), (0.0, 0.0, 1.0))  # as the JAX tool

CONFIGS: Dict[str, dict] = {
    "full": {},
    "no_ssim": {"ssim": False},
    "no_masks": {"mask": False, "auto_mask": False},
    "plain_l1": {"ssim": False, "mask": False, "auto_mask": False},
    "no_augment": {"augment": False},
    "convs_only": {"convs_only": True},
    "convs_only_noaug": {"convs_only": True, "augment": False},
    "disp_only": {"convs_only": True, "nets": "disp"},
    "pose_only": {"convs_only": True, "nets": "pose"},
    "convs_frozen_bn": {"convs_only": True, "train_bn": False},
    "convs_sgd": {"convs_only": True, "opt": "sgd"},
    "remat": {"remat": True},
    "b8": {"batch": 8},
    "b16": {"batch": 16},
    "b16_f8": {"batch": 16, "fused": 8},
    "remat_b16": {"remat": True, "batch": 16},
    "r50": {"layers": 50},
}


def parse_configs(text: str) -> List[str]:
    names = [n.strip() for n in text.split(",") if n.strip()]
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        raise ValueError(f"unknown configs {unknown}; the port has {sorted(CONFIGS)}")
    return names


def host_batch(k: int, b: int, augment: bool, seed: int = 0, hw=(H, W)) -> dict:
    """Noise frames (uint8 for the device augmentation, else float [0, 1])
    of ``hw`` with the JAX tool's camera, ``k`` batches stacked on a
    leading axis when ``k`` > 1."""
    r = np.random.RandomState(seed)
    lead = (k,) if k > 1 else ()
    h, w = hw
    cam = np.array(KITTI_K, np.float32) * np.array([[w / W], [h / H], [1]], np.float32)
    batch = {"tgt": r.randint(0, 256, lead + (b, h, w, 3), np.uint8),
             "refs": r.randint(0, 256, lead + (b, N, h, w, 3), np.uint8),
             "intrinsics": np.broadcast_to(cam, lead + (b, 3, 3)).copy()}
    if not augment:
        batch["tgt"] = batch["tgt"].astype(np.float32) / 255.0
        batch["refs"] = batch["refs"].astype(np.float32) / 255.0
    return batch


def _convs_step(disp, pose, optimizer, variant: dict, device, augment_fn, k: int):
    """The JAX tool's ``convs_only`` step: the networks' forward (BatchNorm
    on batch statistics unless ``train_bn`` is False), a sum loss, the
    backward and the optimizer; K steps per call as one CUDA graph on the
    card, eagerly on the CPU or with K = 1."""
    nets, train_bn = variant.get("nets", "both"), variant.get("train_bn", True)

    def update(snippet):
        optimizer.zero_grad(set_to_none=True)
        disp.train(train_bn)
        pose.train(train_bn)
        total = torch.zeros((), device=device)
        with conv_autocast(device, "bf16"):
            if nets in ("both", "disp"):
                tgt_depth, _ = compute_depth(disp, snippet["tgt"], snippet["refs"])
                total = total + sum(t.float().sum() for t in tgt_depth)
            if nets in ("both", "pose"):
                poses, poses_inv = compute_pose_with_inv(pose, snippet["tgt"], snippet["refs"])
                total = total + poses.float().sum() + poses_inv.float().sum()
        loss = total * 1e-6
        loss.backward()
        optimizer.step()
        return {key: loss.detach() for key in METRIC_KEYS}

    if k > 1 and device.type == "cuda":
        return _GraphedSteps(k, device, optimizer, update, augment_fn, 0)
    count = 0

    def eager(batch):
        nonlocal count
        out = []
        for i in range(k):
            raw = {key: _to_device(batch[key][i] if k > 1 else batch[key], device)
                   for key in SNIPPET_KEYS}
            snippet = (augment_fn(step_generator(0, count), raw) if augment_fn is not None
                       else {key: v.float() for key, v in raw.items()})
            out.append(update(snippet))
            count += 1
        return {key: torch.stack([m[key] for m in out]) for key in METRIC_KEYS}

    return eager


def build(variant: dict, device="cuda", fused: int = None, hw=(H, W)):
    """(step, batch on the device, K, B) of one variant at ``hw``: ``fused``
    overrides the variant's K (the JAX tool's FUSED, 16)."""
    device = torch.device(device)
    k = fused or variant.get("fused", FUSED)
    b = variant.get("batch", B)
    augment = variant.get("augment", True)
    disable_tf32()
    disp = DispNet(variant.get("layers", 18), generator=torch.Generator().manual_seed(0))
    pose = PoseNet(18, generator=torch.Generator().manual_seed(1))
    disp.to(device)
    pose.to(device)
    graphed = k > 1 and device.type == "cuda"
    if variant.get("opt") == "sgd":
        optimizer = torch.optim.SGD(list(disp.parameters()) + list(pose.parameters()), lr=LR)
    else:
        optimizer = make_optimizer(disp, pose, lr=LR, capturable=graphed)
    augment_fn = make_device_augment(AugmentConfig()) if augment else None
    if variant.get("convs_only"):
        step = _convs_step(disp, pose, optimizer, variant, device, augment_fn, k)
    else:
        cfg = LossConfig(num_scales=1, with_ssim=variant.get("ssim", True),
                         with_mask=variant.get("mask", True),
                         with_auto_mask=variant.get("auto_mask", True))
        step = make_train_step(disp, pose, optimizer, cfg, device=device,
                               remat=variant.get("remat", False), augment_fn=augment_fn,
                               fused_steps=k)
    batch = {key: torch.from_numpy(v).to(device)
             for key, v in host_batch(k, b, augment, hw=hw).items()}
    return step, batch, k, b


def step_times(step, batch, k: int, n: int, reps: int) -> List[float]:
    """Device ms per optimizer step over ``reps`` windows of ``n`` calls
    (CUDA events), after the warm-up, the capture and one replay."""
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            metrics = step(batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (n * k))
    if not torch.isfinite(metrics["loss"]).all():
        raise FloatingPointError(f"non-finite losses {metrics['loss'].tolist()}")
    return times


def measure(name: str, n: int, reps: int, fused: int = None) -> dict:
    """Build and time one variant; prints its line and returns its numbers."""
    t_build = time.perf_counter()
    step, batch, k, b = build(CONFIGS[name], "cuda", fused)
    times = step_times(step, batch, k, n, reps)
    ms = float(np.median(times))
    spread = (max(times) - min(times)) / ms
    print(f"{name:18s} {ms:8.3f} ms/step   ({b / ms * 1e3:6.1f} snippets/s)  "
          f"[K={k}, build+warm+time {time.perf_counter() - t_build:.0f}s, spread {spread:.1%}]",
          flush=True)
    return {"name": name, "ms_per_step": ms, "times": times, "fused": k, "batch": b}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--configs", default="full,no_ssim,plain_l1,no_augment,convs_only")
    p.add_argument("--n", type=int, default=12, help="replays per timed window")
    p.add_argument("--reps", type=int, default=3, help="timed windows")
    p.add_argument("--fused", type=int, default=None,
                   help="steps per replay for every variant (default: 16, or the variant's)")
    args = p.parse_args(argv)
    names = parse_configs(args.configs)
    cli_device("cuda")
    print(f"device: {card_line()}", flush=True)
    failed = []
    for name in names:
        try:
            measure(name, args.n, args.reps, args.fused)
        except Exception as exc:  # keep going; report the failure
            print(f"{name:18s} FAILED: {type(exc).__name__}: {exc}", flush=True)
            failed.append(name)
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
