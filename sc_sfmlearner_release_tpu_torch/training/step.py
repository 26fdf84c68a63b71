"""Validation and inference steps (forward only).

The counterpart of the JAX package's ``training/step.py``: depth for all
snippet frames in one batched DispNet call, all 2N directed poses in one
batched PoseNet call (frame-major folding, so BatchNorm sees the same
batches as in JAX), then the 3-term loss.

Batch layout (numpy arrays or tensors):
  batch = {
    "tgt":        [B, H, W, 3]     target frames
    "refs":       [B, N, H, W, 3]  reference frames
    "intrinsics": [B, 3, 3]
    "n_valid":    optional int, samples past it are loader padding
  }

Precision: ``"bf16"`` (the default, as the JAX trainer's ``--precision``)
runs the convolutions under bf16 autocast; BatchNorm, the heads, geometry
and losses stay fp32. ``"fp32"`` runs everything in fp32. The entry points
turn TF32 off for matmuls and cuDNN.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import disable_tf32, resolve_device
from ..ops.losses import photo_and_geometry_loss, smooth_loss

PRECISIONS = ("bf16", "fp32")
Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Static loss configuration (the reference's loss flags)."""

    photo_weight: float = 1.0
    smooth_weight: float = 0.1
    geometry_weight: float = 0.5
    num_scales: int = 1
    with_ssim: bool = True
    with_mask: bool = True
    with_auto_mask: bool = False
    padding_mode: str = "zeros"


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}: expected one of {PRECISIONS}")


def conv_autocast(device: torch.device, precision: str):
    """bf16 autocast for the convolutions, or nothing for ``"fp32"``."""
    _check_precision(precision)
    if precision == "fp32":
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=torch.bfloat16)


def _frames_to_batch(tgt: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 3]`` + ``[B, N, H, W, 3]`` -> frame-major ``[(1+N)*B, H, W, 3]``."""
    all_f = torch.cat([tgt[:, None], refs], dim=1)
    return all_f.transpose(0, 1).reshape((-1,) + tgt.shape[1:])


def _split_frames(x: torch.Tensor, b: int, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`_frames_to_batch` for per-frame outputs."""
    return x[:b], x[b:].reshape((n, b) + x.shape[1:]).transpose(0, 1)


def compute_depth(
    disp_net, tgt: torch.Tensor, refs: torch.Tensor
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """All-frames depth in one batched DispNet call: per-scale lists
    ``tgt_depth[s]`` ``[B, h, w, 1]`` and ``ref_depths[s]`` ``[B, N, h, w, 1]``."""
    b, n = tgt.shape[0], refs.shape[1]
    tgt_depth, ref_depths = [], []
    for disp in disp_net(_frames_to_batch(tgt, refs)):
        t, r = _split_frames(1.0 / disp, b, n)
        tgt_depth.append(t)
        ref_depths.append(r)
    return tgt_depth, ref_depths


def compute_pose_with_inv(
    pose_net, tgt: torch.Tensor, refs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All 2N directed poses in one batched PoseNet call: (poses ``[B, N, 6]``
    target -> ref, poses_inv ``[B, N, 6]`` ref -> target)."""
    b, n = tgt.shape[0], refs.shape[1]
    flat = lambda a: a.transpose(0, 1).reshape((-1,) + a.shape[2:])
    tgt_rep = flat(tgt[:, None].expand(refs.shape))
    ref_f = flat(refs)
    out = pose_net(torch.cat([tgt_rep, ref_f]), torch.cat([ref_f, tgt_rep]))
    poses = out[: n * b].reshape(n, b, 6).transpose(0, 1)
    poses_inv = out[n * b:].reshape(n, b, 6).transpose(0, 1)
    return poses, poses_inv


def total_loss(
    disp_net, pose_net, batch: Batch, cfg: LossConfig,
    sample_mask: Optional[torch.Tensor] = None, precision: str = "bf16",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted 3-term loss of a batch: (total, metrics)."""
    tgt, refs, intrinsics = batch["tgt"], batch["refs"], batch["intrinsics"]
    with conv_autocast(tgt.device, precision):
        tgt_depth, ref_depths = compute_depth(disp_net, tgt, refs)
        poses, poses_inv = compute_pose_with_inv(pose_net, tgt, refs)
    photo, geom = photo_and_geometry_loss(
        tgt, refs, intrinsics, tgt_depth, ref_depths, poses, poses_inv,
        num_scales=cfg.num_scales, with_ssim=cfg.with_ssim,
        with_mask=cfg.with_mask, with_auto_mask=cfg.with_auto_mask,
        padding_mode=cfg.padding_mode, sample_mask=sample_mask,
    )
    smooth = smooth_loss(tgt_depth, tgt, ref_depths, refs, sample_mask)
    total = cfg.photo_weight * photo + cfg.smooth_weight * smooth + cfg.geometry_weight * geom
    metrics = {"loss": total, "photo_loss": photo, "smooth_loss": smooth, "geometry_loss": geom}
    return total, metrics


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return torch.as_tensor(x, device=device)


def make_eval_step(
    disp_net, pose_net, cfg: LossConfig = LossConfig(), device=None,
    precision: str = "bf16",
) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Photometric validation without ground truth: the same losses with
    both networks in eval mode, auto-mask off and scale 0 only. If the batch
    carries ``"n_valid"``, the padded samples past it are masked out of
    every mean. Moves both networks to ``device`` and puts them in eval
    mode. Returns ``eval_step(batch) -> metrics`` (0-d tensors)."""
    device = resolve_device(device)
    _check_precision(precision)
    disable_tf32()
    disp_net.to(device).eval()
    pose_net.to(device).eval()
    eval_cfg = dataclasses.replace(cfg, with_auto_mask=False, num_scales=1)

    def eval_step(batch) -> Dict[str, torch.Tensor]:
        b = {k: _to_device(batch[k], device).float() for k in ("tgt", "refs", "intrinsics")}
        sample_mask = None
        if "n_valid" in batch:
            sample_mask = (
                torch.arange(b["tgt"].shape[0], device=device) < int(batch["n_valid"])
            ).float()
        with torch.no_grad():
            _, metrics = total_loss(disp_net, pose_net, b, eval_cfg, sample_mask, precision)
        return metrics

    return eval_step


def make_inference_fn(
    disp_net, device=None, precision: str = "bf16"
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Single-image depth inference: ``infer(img [B, H, W, 3])`` returns
    (disp, depth), both ``[B, H, W, 1]`` at scale 0."""
    device = resolve_device(device)
    _check_precision(precision)
    disable_tf32()
    disp_net.to(device).eval()

    def infer(img) -> Tuple[torch.Tensor, torch.Tensor]:
        x = _to_device(img, device).float()
        with torch.no_grad(), conv_autocast(device, precision):
            disp = disp_net(x)[0]
        return disp, 1.0 / disp

    return infer
