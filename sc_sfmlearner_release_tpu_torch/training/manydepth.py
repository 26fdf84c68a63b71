"""ManyDepth's train step (Watson et al., CVPR 2021; the public code's
``Trainer.process_batch`` and ``compute_losses`` with its defaults).

One optimizer step on a 3-frame snippet (frames 0, -1, +1), after the
device augmentation and the resize to the training size
(``data.device_augment.resize_nchw``):

* poses 0 -> -1 (``PoseNet`` on ``[f-1, f0]``, inverted) and 0 -> +1 (on
  ``[f0, f1]``), axis-angle and translation through
  ``ops.geometry.transformation_from_parameters``; each call is one frame
  id's B pairs, so BatchNorm takes that call's statistics;
* the matching augmentation, from the step's host draws: a sample with
  u < 0.25 looks up frame 0 itself (static camera), one with u < 0.5 gets
  the matching pose 0 (an empty cost volume); both set the augmentation
  mask;
* the teacher (``mono``) on frame 0, and the multi-frame network
  (``multi``) over the cost volume of frame 0 against frame -1, with the
  detached pose 0 -> -1 (the public code's matching pose, the same
  numbers) and the depth bins linear between the adaptive trackers;
* both paths' losses at four scales, each disparity upsampled bilinearly
  to the full size: the per-pixel minimum over the two references of
  0.85 SSIM + 0.15 L1 (references warped with border padding), masked on
  the teacher by the auto-mask (minimum against the identity loss, plus
  tie-breaking noise of 1e-5 N(0, 1)) and on the multi path by the
  consistency mask times (1 - the augmentation mask); the pixels that mask
  drops get |d_multi - d_mono| (the teacher's depth detached); the
  edge-aware smoothness of disp / mean(disp) weighted 1e-3 / 2^s; each path
  averaged over scales, the two summed;
* Adam over all three networks, then the trackers move 1% towards the
  teacher's full-size depth range of the batch (max(0.1, 0.9 min), 1.1
  max), on the card.

Shared where the public code computes the same numbers twice: the matching
pose is the loss pose 0 -> -1 detached, and the identity losses, which
depend only on the frames, are computed once for both paths and all
scales. The multi path's auto-mask and its tie noise, which the public
code computes and then replaces by ones, are not computed.

Host branches and syncs of the public code are device ops here: the
per-sample augmentation loop is a ``where`` over the batch, the skip of a
zero matching pose is the kernel's mask (a zero pose projects every pixel
outside the frame), and the trackers are device tensors the step updates.

Draws: each step's CPU generator (``data.device_augment.step_generator``
of the seed and the step) gives, after the augmentation's own draws, one
U[0, 1) per sample (the matching augmentation) and two integers below
2^24, the key of the tie noise, which the card computes from a
counter-based hash of (key, element) by Box-Muller (:func:`tie_noise`).
Both travel in the augmentation's per-step map (:class:`MatchingAugment`),
so a CUDA-graph replay reads them from its static inputs.

``METRIC_KEYS``: the total and each path's loss, the share of
quarter-resolution pixels the cost volume's confidence mask keeps, the
share of full-size pixels handed to the consistency loss (%), and the
trackers after the step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..data.device_augment import DeviceAugment, resize_nchw
from ..models.manydepth import ManyDepth
from ..ops import warp_sample
from ..ops.cost_volume import depth_bins
from ..ops.geometry import transformation_from_parameters
from ..ops.losses import (automask, disp_to_depth, edge_aware_smoothness, masked_mean,
                          reprojection_loss)
from .step import conv_autocast, dispatch

METRIC_KEYS = ("loss", "mono_loss", "multi_loss", "confident_pct", "masked_pct", "bins_min",
               "bins_max")
MEAN, STD = 0.45, 0.225
STATIC_BELOW, EMPTY_BELOW = 0.25, 0.5
NOISE = 1e-5
KEY_BITS = 24
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ManyDepthConfig:
    """ManyDepth's options (``manydepth/options.py``) that the step reads;
    the trackers start where the public trainer starts them."""

    height: int = 192
    width: int = 640
    num_scales: int = 4
    min_depth: float = 0.1
    max_depth: float = 100.0
    num_depth_bins: int = 96
    disparity_smoothness: float = 1e-3
    tracker_start: Tuple[float, float] = (0.1, 10.0)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash on int64 tensors (values below 2^32; every
    product stays below 2^59)."""
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def tie_noise(key: torch.Tensor, shape) -> torch.Tensor:
    """``1e-5 N(0, 1)`` of ``shape`` on ``key``'s device from the two
    integers of ``key`` (float, below 2^24): element ``i`` hashes ``2 i`` and
    ``2 i + 1`` after the key, and Box-Muller turns the two 24-bit uniforms
    into a normal."""
    k = key.long()
    base = _mix32(_mix32(k[0]) ^ k[1])
    i = torch.arange(math.prod(shape), device=key.device, dtype=torch.int64) * 2
    a = _mix32((i + base) & _M32)
    b = _mix32((i + 1 + base) & _M32)
    u1 = ((a >> 8).float() + 0.5) * 2.0 ** -KEY_BITS
    u2 = (b >> 8).float() * 2.0 ** -KEY_BITS
    return (torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2) * NOISE).view(shape)


class MatchingAugment:
    """The device augmentation (:class:`DeviceAugment`), then the resize to
    the training size, with the step's matching draws: ``augment(generator,
    batch)`` and its two halves for a CUDA graph (``host_map``,
    ``apply_map``), as ``DeviceAugment`` has them. The snippet comes out NCHW
    with ``match_u`` ``[B]`` and ``noise_key`` ``[2]``."""

    EXTRA = 3  # u, then the noise key's two integers

    def __init__(self, augment: DeviceAugment, height: int, width: int):
        self.augment, self.height, self.width = augment, height, width

    def map_width(self, h: int, w: int) -> int:
        return self.augment.map_width(h, w) + self.EXTRA

    def host_map(self, generator: torch.Generator, batch_size: int, h: int,
                 w: int) -> torch.Tensor:
        affine = self.augment.host_map(generator, batch_size, h, w)
        u = torch.rand(batch_size, generator=generator)
        key = torch.randint(0, 2 ** KEY_BITS, (2,), generator=generator).float()
        return torch.cat([affine, u[:, None], key[None].expand(batch_size, 2)], 1)

    def apply_map(self, batch, packed: torch.Tensor):
        _, h, w, _ = batch["tgt"].shape
        n = self.augment.map_width(h, w)
        out = resize_nchw(self.augment.apply_map(batch, packed[:, :n]), self.height, self.width)
        out["match_u"], out["noise_key"] = packed[:, n], packed[0, n + 1:]
        return out

    def __call__(self, generator: torch.Generator, batch):
        b, h, w, _ = batch["tgt"].shape
        return self.apply_map(batch, self.host_map(generator, b, h, w).to(batch["tgt"].device))


def make_manydepth_optimizer(nets: torch.nn.Module, lr: float = 1e-4,
                             capturable: bool = False) -> torch.optim.Adam:
    """The public trainer's ``Adam(parameters_to_train, learning_rate)``
    (betas 0.9, 0.999, eps 1e-8) over ``nets``: the whole
    :class:`ManyDepth`, or its ``multi`` network once the teacher is
    frozen; ``capturable`` for a CUDA-graph capture of the step, as
    ``make_optimizer``'s."""
    return torch.optim.Adam(nets.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=capturable)


def make_trackers(cfg: ManyDepthConfig, device) -> torch.Tensor:
    """The depth-bin trackers ``[min, max]`` at their start, on ``device``."""
    return torch.tensor(cfg.tracker_start, dtype=torch.float32, device=device)


def _inv_k(k: torch.Tensor) -> torch.Tensor:
    """Inverse of zero-skew intrinsics ``[B, 3, 3]``."""
    fx, fy, cx, cy = k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([1 / fx, zero, -cx / fx, zero, 1 / fy, -cy / fy, zero, zero, one],
                       1).view(-1, 3, 3)


def _scaled_k(k: torch.Tensor, s: float) -> torch.Tensor:
    return torch.cat([k[:, :2] * s, k[:, 2:]], 1)


def _pose(net, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``PoseNet`` on NCHW frames ``[a, b]``: ``[B, 6]`` (axis-angle, then
    translation)."""
    return net.decoder(net.encoder(torch.cat([a, b], 1))[-1])


def _rays(k: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``inv_K @ [x, y, 1]`` of every pixel: ``[B, 3, h w]``."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=k.device),
                            torch.arange(w, dtype=torch.float32, device=k.device),
                            indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones_like(xs).reshape(-1)])
    return _inv_k(k) @ pix


def _warp_coords(depth: torch.Tensor, rays: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Pixels of ``depth`` ``[B, 1, H, W]`` projected by each of ``proj``
    ``[R, B, 3, 4]``: ``[R B, H, W, 2]`` normalized for ``warp_sample``
    (``align_corners=False``), the pixel coordinates of the public code's
    ``align_corners=True`` grid."""
    b, _, h, w = depth.shape
    cam = depth.view(b, 1, -1) * rays
    cam = torch.cat([cam, torch.ones_like(cam[:, :1])], 1)
    p = proj @ cam[None]
    pix = p[:, :, :2] / (p[:, :, 2:3] + 1e-7)  # [R, B, 2, H W]
    grid = torch.stack([(2.0 * pix[:, :, 0] + 1.0) / w - 1.0,
                        (2.0 * pix[:, :, 1] + 1.0) / h - 1.0], -1)
    return grid.reshape(-1, h, w, 2)


def manydepth_loss(model: ManyDepth, snippet, trackers: torch.Tensor, cfg: ManyDepthConfig,
                   precision: str = "bf16", train_teacher: bool = True,
                   record: Optional[dict] = None):
    """``(total, metrics, new trackers)`` of one resized, normalized NCHW
    snippet (``tgt [B, 3, H, W]``, ``refs [B, 2, 3, H, W]`` = frames -1, +1,
    ``intrinsics``, ``match_u``, ``noise_key``). Puts the networks in train
    mode (the teacher and pose in eval mode, without gradients, when not
    ``train_teacher``: the public code's frozen teacher). ``record``, if
    given, receives the step's discrete decisions for a comparison:
    ``lowest_cost``, ``confidence``, ``consistency`` (before the
    augmentation mask) and the teacher's ``automask`` of each scale."""
    tgt, refs, k = snippet["tgt"], snippet["refs"], snippet["intrinsics"]
    b, _, h, w = tgt.shape
    scales = cfg.num_scales
    prev, nxt = refs[:, 0], refs[:, 1]
    model.multi.train()
    model.mono.train(train_teacher)
    model.pose.train(train_teacher)
    teacher = contextlib.nullcontext() if train_teacher else torch.no_grad()
    with teacher, conv_autocast(tgt.device, precision):
        pose_prev = _pose(model.pose, prev, tgt)
        pose_next = _pose(model.pose, tgt, nxt)
        mono_disps = model.mono(tgt)
    t_prev = transformation_from_parameters(pose_prev[:, :3], pose_prev[:, 3:], invert=True)
    t_next = transformation_from_parameters(pose_next[:, :3], pose_next[:, 3:])

    u = snippet["match_u"]
    aug = (u < EMPTY_BELOW).float().view(b, 1, 1, 1)
    lookup = torch.where((u < STATIC_BELOW).view(b, 1, 1, 1), tgt, prev)
    keep_pose = ((u < STATIC_BELOW) | (u >= EMPTY_BELOW)).float().view(b, 1, 1)
    k4 = _scaled_k(k, 0.25)
    proj_match = k4 @ (t_prev.detach() * keep_pose)[:, :3]
    bins = depth_bins(trackers[0], trackers[1], cfg.num_depth_bins)
    with conv_autocast(tgt.device, precision):
        multi_disps, lowest, confidence = model.multi(tgt, lookup, proj_match, _inv_k(k4), bins)

    color = tgt * STD + MEAN
    target = color.repeat(2, 1, 1, 1)  # pairs reference-major: frame -1's B, then +1's
    ref_color = (refs * STD + MEAN).transpose(0, 1).reshape(2 * b, 3, h, w)
    source = ref_color.permute(0, 2, 3, 1).contiguous()
    with torch.no_grad():
        identity = reprojection_loss(ref_color, target).view(2, b, 1, h, w).min(0)[0]
    rays = _rays(k, h, w)
    proj = torch.stack([k @ t_prev[:, :3], k @ t_next[:, :3]])
    colors = [color] + [F.avg_pool2d(color, 2 ** s) for s in range(1, scales)]

    def path(disps, proj):
        depths, reproj = [], []
        for s in range(scales):
            up = F.interpolate(disps[s], (h, w), mode="bilinear", align_corners=False)
            depth = disp_to_depth(up, cfg.min_depth, cfg.max_depth)[1]
            warped = warp_sample(source, _warp_coords(depth, rays, proj), "border")
            loss = reprojection_loss(warped.permute(0, 3, 1, 2).contiguous(), target)
            depths.append(depth)
            reproj.append(loss.view(2, b, 1, h, w).min(0)[0])
        return depths, reproj

    def smooth(disp, s):
        norm = disp / (disp.mean(2, True).mean(3, True) + 1e-7)
        return cfg.disparity_smoothness * edge_aware_smoothness(norm, colors[s]) / (2 ** s)

    with teacher:
        mono_depths, mono_reproj = path(mono_disps, proj)
    multi_depths, multi_reproj = path(multi_disps, proj.detach())

    mono0 = mono_depths[0].detach()
    matching = 1 / F.interpolate(lowest[:, None], (h, w), mode="nearest")
    agree = (((matching - mono0) / mono0) < 1.0) & (((mono0 - matching) / matching) < 1.0)
    consistency = F.interpolate(confidence[:, None], (h, w), mode="nearest") * agree.float()
    reproj_mask = consistency * (1 - aug)
    handed = 1 - reproj_mask

    noise = tie_noise(snippet["noise_key"], (scales, b, 1, h, w)) if train_teacher else None
    mono_total = multi_total = 0.0
    for s in range(scales):
        if train_teacher:
            mask = automask(mono_reproj[s], identity + noise[s])
            if record is not None:
                record[("automask", s)] = mask
            mono_total = mono_total + (masked_mean(mono_reproj[s], mask)
                                       + smooth(mono_disps[s], s))
        cons = ((multi_depths[s] - mono_depths[s].detach()).abs() * handed).mean()
        multi_total = multi_total + ((masked_mean(multi_reproj[s], reproj_mask) + cons)
                                     + smooth(multi_disps[s], s))
    if record is not None:
        record.update(lowest_cost=lowest, confidence=confidence, consistency=consistency)
    multi_loss = multi_total / scales
    mono_loss = mono_total / scales if train_teacher else torch.zeros_like(multi_loss)
    total = multi_loss + mono_loss if train_teacher else multi_loss

    with torch.no_grad():
        if train_teacher:
            lo = torch.clamp(mono0.amin((2, 3)).mean() * 0.9, min=cfg.min_depth)
            hi = mono0.amax((2, 3)).mean() * 1.1
            new = torch.stack([trackers[0] * 0.99 + lo * 0.01, trackers[1] * 0.99 + hi * 0.01])
        else:
            new = trackers.clone()
        metrics = {"loss": total.detach(), "mono_loss": mono_loss.detach(),
                   "multi_loss": multi_loss.detach(),
                   "confident_pct": confidence.mean() * 100.0,
                   "masked_pct": handed.mean() * 100.0, "bins_min": new[0], "bins_max": new[1]}
    return total, metrics, new


def make_manydepth_train_step(
    model: ManyDepth, optimizer: torch.optim.Optimizer, cfg: ManyDepthConfig = ManyDepthConfig(),
    device=None, precision: str = "bf16", augment_fn: Optional[MatchingAugment] = None,
    aug_seed: int = 0, fused_steps: int = 1, trackers: Optional[torch.Tensor] = None,
    train_teacher: bool = True,
) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """ManyDepth's train step over ``model`` and ``optimizer`` (Adam over
    all three networks): ManyDepth's loss, the trackers' update and one
    optimizer step a snippet, dispatched as SC-Depth's is
    (:func:`~.step.dispatch`: raw batches, uint8 from a packed loader, on
    the device, ``augment_fn`` a :class:`MatchingAugment` drawing from the
    CPU generator of (``aug_seed``, step); ``fused_steps=K > 1`` takes K
    stacked batches a call, on CUDA one CUDA-graph replay of K steps with a
    ``capturable`` optimizer, on the CPU K eager steps). ``trackers``
    (``make_trackers``'s by default) is the state the step updates in
    place, and the returned step's ``.trackers``; ``train_teacher=False`` is
    the public code's frozen teacher (its loss, its gradients and the
    trackers' updates off). Returns ``step(batch) -> metrics``
    (:data:`METRIC_KEYS`, detached)."""
    if not isinstance(augment_fn, MatchingAugment):
        raise TypeError("ManyDepth's step takes its draws from a MatchingAugment")
    device = resolve_device(device)
    model.to(device)
    trackers = make_trackers(cfg, device) if trackers is None else trackers

    def update(snippet) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        loss, metrics, new = manydepth_loss(model, snippet, trackers, cfg, precision,
                                            train_teacher)
        with torch.no_grad():  # before the update, as the public process_batch does
            trackers.copy_(new)
        loss.backward()
        optimizer.step()
        return metrics

    step = dispatch(update, optimizer, device, augment_fn, aug_seed, fused_steps, METRIC_KEYS)
    step.trackers = trackers
    return step
