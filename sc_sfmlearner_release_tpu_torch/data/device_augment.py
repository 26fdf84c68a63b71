"""Training augmentation on the device, inside the train step.

The counterpart of the JAX package's ``data/device_augment.py``: the
snippet-coherent random horizontal flip and random scale-crop of the host
transforms (``data/transforms.py``, reference custom_transforms.py:46-84),
with the matching intrinsics updates, then the reference's Normalize. The
host only decodes (or, from a packed dataset, slices uint8 frames); the
card does the rest.

Flip, zoom and crop compose into ONE affine map from output pixel centers
to input pixel centers, separable per axis:

    zoom to (floor(H*sy), floor(W*sx)), crop at integer (ox, oy)
      =>  in_x = (out_x + ox + 0.5) / sx_eff - 0.5,   sx_eff = floor(W*sx)/W
    flip folds in as  in_x -> (W-1) - in_x

(pixel centers, as PIL and ``align_corners=False``), sampled bilinearly on
float with the positions clamped to the border (PIL's edge handling). The
JAX package writes each axis as a dense one-hot contraction because a TPU
has no fast gather; a GPU gathers natively, so here each axis is two index
gathers of the clamped taps ``floor(pos)`` and ``floor(pos) + 1`` and
``w0 * a + w1 * b`` in fp32: vertical first, then horizontal, as JAX does.
All 1+N frames of a snippet share one draw and go through one resample.

Intrinsics follow the host path in its order (flip: cx -> W - cx; zoom:
row 0 *= sx, row 1 *= sy; crop: cx -= ox, cy -= oy) with the effective
scale ``floor(W*sx)/W``, the scale the resampled image has.

Randomness: one draw per sample from an explicit CPU ``torch.Generator``.
The train step seeds it from (seed, step) (``step_generator``), so the
stream is deterministic for a given seed and step on any device, and a
resumed run continues it. It is not JAX's ``jax.random`` stream.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from .transforms import IMAGENET_MEAN, IMAGENET_STD

Batch = Dict[str, torch.Tensor]
IMAGE_KEYS = ("tgt", "refs", "img")


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    max_scale: float = 1.15
    flip: bool = True
    scale_crop: bool = True
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of the draws of train step ``step``."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def sample_draws(generator: torch.Generator, batch_size: int, cfg: AugmentConfig) -> Batch:
    """Per-sample draws on the CPU, as the host transforms draw them: flip ~
    Bernoulli(0.5), (sx, sy) ~ U(1, max_scale), and U[0, 1) offsets that
    become integer crop offsets once the valid range is known. All three are
    drawn whatever ``cfg`` turns off, so the stream does not depend on it."""
    flip = torch.rand(batch_size, generator=generator) < 0.5
    scales = 1.0 + torch.rand(batch_size, 2, generator=generator) * (cfg.max_scale - 1.0)
    offsets = torch.rand(batch_size, 2, generator=generator)
    if not cfg.flip:
        flip = torch.zeros_like(flip)
    if not cfg.scale_crop:
        scales = torch.ones_like(scales)
    return {"flip": flip, "scales": scales, "offsets01": offsets}


@functools.lru_cache(maxsize=16)
def _mean_std(mean: Tuple[float, ...], std: Tuple[float, ...], device: torch.device):
    """The normalization's constants on ``device``, made once: copying them
    there in every call would stall the host (and a CUDA-graph capture)."""
    return (torch.tensor(mean, dtype=torch.float32, device=device),
            torch.tensor(std, dtype=torch.float32, device=device))


def _affine_coords(draws: Batch, h: int, w: int):
    """Per-sample effective scales, integer offsets and the sampling
    positions ``in_x [B, W]``, ``in_y [B, H]`` (the map is separable)."""
    sx, sy = draws["scales"][:, 0], draws["scales"][:, 1]
    scaled_w = torch.floor(w * sx)
    scaled_h = torch.floor(h * sy)
    sx_eff = scaled_w / w
    sy_eff = scaled_h / h
    ox = torch.floor(draws["offsets01"][:, 0] * (scaled_w - w + 1.0))
    oy = torch.floor(draws["offsets01"][:, 1] * (scaled_h - h + 1.0))
    out_x = torch.arange(w, dtype=torch.float32, device=sx.device)
    out_y = torch.arange(h, dtype=torch.float32, device=sx.device)
    in_x = (out_x[None, :] + ox[:, None] + 0.5) / sx_eff[:, None] - 0.5
    in_y = (out_y[None, :] + oy[:, None] + 0.5) / sy_eff[:, None] - 0.5
    in_x = torch.where(draws["flip"][:, None], (w - 1.0) - in_x, in_x)
    return in_x, in_y, sx_eff, sy_eff, ox, oy


def _affine_packed(draws: Batch, h: int, w: int) -> torch.Tensor:
    """:func:`_affine_coords` where the draws lie (the CPU, from the step's
    generator), packed into one ``[B, W + H + 5]`` tensor (``in_x``,
    ``in_y``, then per sample ``sx_eff, sy_eff, ox, oy, flip``) that moves
    to the device in one copy. Resolving them on the CPU keeps the
    positions the same on every device: CUDA divides a tensor by a Python
    number as a multiplication by its reciprocal, which moves a position by
    an ulp (and a frame by up to 5e-4 at 832 columns)."""
    in_x, in_y, sx_eff, sy_eff, ox, oy = _affine_coords(draws, h, w)
    per_sample = torch.stack([sx_eff, sy_eff, ox, oy, draws["flip"].float()], 1)
    return torch.cat([in_x, in_y, per_sample], 1)


def _unpack_affine(packed: torch.Tensor, h: int, w: int):
    """Inverse of :func:`_affine_packed`, on the device it lies on."""
    in_x, in_y, per_sample = packed.split([w, h, 5], 1)
    sx_eff, sy_eff, ox, oy, flip = per_sample.unbind(1)
    return in_x, in_y, sx_eff, sy_eff, ox, oy, flip > 0.5


def _affine_on(device: torch.device, draws: Batch, h: int, w: int):
    """The affine map of ``draws``, made on the CPU and moved to ``device``."""
    packed = _affine_packed(draws, h, w).to(device, non_blocking=True)
    return _unpack_affine(packed, h, w)


def _resample_axis(frames: torch.Tensor, pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Bilinear resample of ``frames [B, ...]`` along ``dim`` at ``pos
    [B, n]``: the taps ``floor(pos)`` and ``floor(pos) + 1`` of the position
    clamped to ``[0, size - 1]``, the second tap clamped too."""
    size = frames.shape[dim]
    pos = pos.clamp(0.0, size - 1.0)
    p0 = torch.floor(pos)
    frac = pos - p0
    i0 = p0.long()
    i1 = (i0 + 1).clamp(max=size - 1)
    view = [1] * frames.dim()
    view[0], view[dim] = pos.shape
    expand = list(frames.shape)
    expand[dim] = pos.shape[1]
    a = frames.gather(dim, i0.view(view).expand(expand))
    b = frames.gather(dim, i1.view(view).expand(expand))
    return (1.0 - frac).view(view) * a + frac.view(view) * b


def _update_intrinsics(intrinsics, w: int, sx_eff, sy_eff, ox, oy, flip) -> torch.Tensor:
    """Host-path intrinsics updates, in host-path order (flip, then zoom,
    then crop)."""
    fx, fy = intrinsics[:, 0, 0], intrinsics[:, 1, 1]
    cx, cy = intrinsics[:, 0, 2], intrinsics[:, 1, 2]
    cx = torch.where(flip, w - cx, cx)
    fx = fx * sx_eff
    cx = cx * sx_eff - ox
    fy = fy * sy_eff
    cy = cy * sy_eff - oy
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx, zeros, cx], -1), torch.stack([zeros, fy, cy], -1),
                        torch.stack([zeros, zeros, ones], -1)], 1)


def augment_with_draws(batch: Batch, draws: Batch, cfg: AugmentConfig) -> Batch:
    """Apply resolved draws to a raw [0, 1] float batch (``tgt [B, H, W, 3]``,
    ``refs [B, N, H, W, 3]``, ``intrinsics [B, 3, 3]``); returns the
    normalized batch. The draws are resolved into the affine map where
    they lie, and the map moves to the batch's device."""
    _, h, w, _ = batch["tgt"].shape
    return _apply_affine(batch, _affine_on(batch["tgt"].device, draws, h, w), cfg)


def _apply_affine(batch: Batch, affine, cfg: AugmentConfig) -> Batch:
    """The device's share of :func:`augment_with_draws`: resample,
    normalize and update the intrinsics by the map :func:`_unpack_affine`
    unpacked."""
    tgt, refs, intrinsics = batch["tgt"], batch["refs"], batch["intrinsics"]
    w = tgt.shape[2]
    in_x, in_y, sx_eff, sy_eff, ox, oy, flip = affine

    frames = torch.cat([tgt[:, None], refs], dim=1).float()  # [B, 1+N, H, W, 3]
    sampled = _resample_axis(frames, in_y, 2)
    sampled = _resample_axis(sampled, in_x, 3)
    mean, std = _mean_std(tuple(cfg.mean), tuple(cfg.std), tgt.device)
    sampled = (sampled - mean) / std

    out = dict(batch)
    out["tgt"] = sampled[:, 0]
    out["refs"] = sampled[:, 1:]
    out["intrinsics"] = _update_intrinsics(intrinsics.float(), w, sx_eff, sy_eff, ox, oy, flip)
    return out


def _to_unit_float(batch: Batch) -> Batch:
    """uint8 [0, 255] image entries -> float32 [0, 1], on their device, so
    the host can ship uint8 (4x fewer bytes than float32)."""
    out = dict(batch)
    for k in IMAGE_KEYS:
        if k in out and out[k].dtype == torch.uint8:
            out[k] = out[k].float() / 255.0
    return out


class DeviceAugment:
    """``augment(generator, batch) -> batch`` for raw train batches, float
    [0, 1] or uint8 [0, 255] straight from a packed loader; the train step
    (``make_train_step(augment_fn=...)``) passes the step's generator.

    Its two halves serve a step captured in a CUDA graph, which cannot copy
    from pageable memory: :meth:`host_map` makes one step's affine map on
    the CPU, :meth:`apply_map` is the rest, on the device, given that map
    on the batch's device. ``apply_map(batch, host_map(g, ...))`` is
    ``augment(g, batch)``."""

    def __init__(self, cfg: AugmentConfig):
        self.cfg = cfg

    def __call__(self, generator: torch.Generator, batch: Batch) -> Batch:
        batch = _to_unit_float(batch)
        draws = sample_draws(generator, batch["tgt"].shape[0], self.cfg)
        return augment_with_draws(batch, draws, self.cfg)

    def host_map(self, generator: torch.Generator, batch_size: int, h: int,
                 w: int) -> torch.Tensor:
        """The draws of ``generator`` resolved into the packed affine map,
        ``[batch_size, w + h + 5]`` fp32 on the CPU."""
        return _affine_packed(sample_draws(generator, batch_size, self.cfg), h, w)

    def apply_map(self, batch: Batch, packed: torch.Tensor) -> Batch:
        """Convert, resample, normalize and update the intrinsics of
        ``batch`` by :meth:`host_map`'s map, moved to the batch's device."""
        _, h, w, _ = batch["tgt"].shape
        return _apply_affine(_to_unit_float(batch), _unpack_affine(packed, h, w), self.cfg)


def make_device_augment(cfg: AugmentConfig) -> DeviceAugment:
    """The device augmentation of ``cfg`` (:class:`DeviceAugment`)."""
    return DeviceAugment(cfg)


def normalize_batch(batch: Batch, mean: Tuple[float, float, float] = IMAGENET_MEAN,
                    std: Tuple[float, float, float] = IMAGENET_STD) -> Batch:
    """Normalize only (validation under --device-augment). Accepts float
    [0, 1] or uint8 [0, 255] image entries."""
    out = _to_unit_float(batch)
    for k in IMAGE_KEYS:
        if k in out:
            m, s = _mean_std(tuple(mean), tuple(std), out[k].device)
            out[k] = (out[k] - m) / s
    return out
