"""ManyDepth's plane-sweep cost volume, forward only (no gradient flows
through it: the public code builds it under ``no_grad``).

``cost_volume`` launches the hand-written CUDA kernel of
``csrc/cost_volume.cu`` on CUDA tensors and runs ``cost_volume_plain`` on
CPU tensors. The plain version is the public code's
(``ResnetEncoderMatching.match_features`` with one lookup frame, then
``compute_confidence_mask`` and the lowest-cost disparity) written as its
per-sample loop: each sample's lookup features repeated over the D bins and
sampled by ``F.grid_sample`` (align_corners=True, zeros padding), a
``[D, C, h, w]`` tensor a sample. The kernel computes the same numbers in
one launch without that tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

EPS = 1e-7


def depth_bins(min_depth: torch.Tensor, max_depth: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` depths linear from ``min_depth`` to ``max_depth`` (0-d tensors,
    on their device): ManyDepth's ``depth_binning linear``."""
    steps = torch.arange(n, dtype=torch.float32, device=min_depth.device) / (n - 1)
    return min_depth + (max_depth - min_depth) * steps


def cost_volume_plain(cur: torch.Tensor, lookup: torch.Tensor, proj: torch.Tensor,
                      inv_k: torch.Tensor, bins: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`cost_volume`."""
    b, c, h, w = cur.shape
    d = bins.shape[0]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=cur.device),
                            torch.arange(w, dtype=torch.float32, device=cur.device),
                            indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones(h * w, device=cur.device)])
    inner = torch.zeros((h, w), device=cur.device)
    inner[2:-2, 2:-2] = 1.0
    volumes, lowest, confidence = [], [], []
    for i in range(b):
        cam = bins.view(d, 1, 1) * (inv_k[i] @ pix)[None]  # [D, 3, hw]
        cam = torch.cat([cam, torch.ones((d, 1, h * w), device=cur.device)], 1)
        p = proj[i] @ cam
        xy = p[:, :2] / (p[:, 2:3] + EPS)
        gx = (xy[:, 0] / (w - 1) - 0.5) * 2
        gy = (xy[:, 1] / (h - 1) - 0.5) * 2
        grid = torch.stack([gx, gy], -1).view(d, h, w, 2)
        warped = F.grid_sample(lookup[i:i + 1].expand(d, c, h, w), grid, mode="bilinear",
                               padding_mode="zeros", align_corners=True)
        xv = (grid[..., 0] / 2 + 0.5) * (w - 1)
        yv = (grid[..., 1] / 2 + 0.5) * (h - 1)
        edge = ((xv >= 2.0) & (xv <= w - 2) & (yv >= 2.0) & (yv <= h - 2)).float() * inner
        diffs = (warped - cur[i:i + 1]).abs().mean(1) * edge
        vol = diffs / ((diffs > 0).float() + EPS)
        missing = (vol == 0).float()
        vol = vol * (1 - missing) + vol.max(0)[0][None] * missing
        conf = ((vol * (1 - missing) > 0).sum(0) == d).float()
        viz = torch.where(vol == 0, torch.full_like(vol, 100.0), vol)
        lowest.append(1.0 / bins[viz.argmin(0)])
        volumes.append(vol * conf[None])
        confidence.append(conf)
    return torch.stack(volumes), torch.stack(lowest), torch.stack(confidence)


@functools.cache
def _kernel():
    lib = _build.load("cost_volume")
    fn = lib.cost_volume_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def cost_volume(cur: torch.Tensor, lookup: torch.Tensor, proj: torch.Tensor,
                inv_k: torch.Tensor, bins: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The cost volume of current features ``cur`` against ``lookup``, both
    ``[B, C, h, w]``, over the depths ``bins`` ``[D]``: ``proj`` ``[B, 3, 4]``
    is ``(K @ T)[:3]`` (T current -> lookup, K at the features' scale),
    ``inv_k`` ``[B, 3, 3]``. Returns ``(volume [B, D, h, w]`` filled and
    times the confidence, ``lowest_cost [B, h, w]`` (1 / depth of each
    pixel's lowest-cost bin), ``confidence [B, h, w]`` (1 where every bin
    was observed)). No gradient. On CUDA C must be 64 (ResNet-18/34's
    quarter-resolution features)."""
    tensors = (cur, lookup, proj, inv_k, bins)
    tensors = tuple(t.detach().float().contiguous() for t in tensors)
    if all(t.device.type == "cpu" for t in tensors):
        with torch.no_grad():
            return cost_volume_plain(*tensors)
    _build.check_tensors("cost_volume", tensors)
    cur, lookup, proj, inv_k, bins = tensors
    b, c, h, w = cur.shape
    d = bins.shape[0]
    if lookup.shape != cur.shape or proj.shape != (b, 3, 4) or inv_k.shape != (b, 3, 3) \
            or bins.dim() != 1:
        raise ValueError(f"cost_volume: bad shapes {[tuple(t.shape) for t in tensors]}")
    if c != 64:
        raise ValueError(f"cost_volume: the kernel takes 64 channels, got {c}")
    volume = torch.empty((b, d, h, w), dtype=torch.float32, device=cur.device)
    lowest = torch.empty((b, h, w), dtype=torch.float32, device=cur.device)
    confidence = torch.empty((b, h, w), dtype=torch.float32, device=cur.device)
    lib, fn = _kernel()
    code = fn(cur.data_ptr(), lookup.data_ptr(), proj.data_ptr(), inv_k.data_ptr(),
              bins.data_ptr(), volume.data_ptr(), lowest.data_ptr(), confidence.data_ptr(),
              b, c, d, h, w, _build.stream(cur))
    _build.check(lib, code, "cost_volume")
    cost_volume.launches += 1
    return volume, lowest, confidence


cost_volume.launches = 0
