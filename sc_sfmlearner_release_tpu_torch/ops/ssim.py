"""SSIM dissimilarity map, 3x3 mean-pool formulation.

The counterpart of the JAX package's ``ops/ssim.py`` and of its Pallas
kernel ``ops/pallas_ssim.py``: reflection-pad by 1, 3x3 means for the local
statistics, ``clip((1 - SSIM) / 2, 0, 1)`` (0 = identical).

``ssim_nchw`` launches the hand-written CUDA kernel ``csrc/ssim.cu`` on
CUDA tensors and runs ``ssim_nchw_plain`` on CPU tensors. On CUDA tensors
that need a gradient it goes through an autograd Function whose backward
launches ``csrc/ssim_bwd.cu`` (``ssim_nchw_bwd``): d/dy, and d/dx only when
x needs one. ``ssim_nchw_bwd_plain`` is that kernel's algorithm in tensor
ops, which ``ssim_nchw_bwd`` runs on CPU tensors. There is no fallback to
the plain path on a CUDA tensor. ``ssim_nchw_sharded`` is the map of
width-sharded images (``parallel/spatial.py``), through the same kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import distributed
from . import _build

C1 = 0.01**2
C2 = 0.03**2


def _mean3(a: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """3x3 stride-1 mean of a padded ``[..., H+2, W+2]`` tensor, summed and
    scaled as the kernel does (rows, then columns, from the top-left tap)."""
    s = a[..., 0:h, 0:w]
    for dy in range(3):
        for dx in range(3):
            if dy or dx:
                s = s + a[..., dy:dy + h, dx:dx + w]
    return s * (1.0 / 9.0)


def ssim_nchw_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ssim_nchw`: ``[F, C, H, W]`` -> same shape.
    Its autograd is the reference for :func:`ssim_nchw_bwd`."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect")
    yp = F.pad(y, (1, 1, 1, 1), mode="reflect")
    mu_x = _mean3(xp, h, w)
    mu_y = _mean3(yp, h, w)
    sigma_x = _mean3(xp * xp, h, w) - mu_x * mu_x
    sigma_y = _mean3(yp * yp, h, w) - mu_y * mu_y
    sigma_xy = _mean3(xp * yp, h, w) - mu_x * mu_y
    n = (2.0 * mu_x * mu_y + C1) * (2.0 * sigma_xy + C2)
    d = (mu_x * mu_x + mu_y * mu_y + C1) * (sigma_x + sigma_y + C2)
    return torch.clamp((1.0 - n / d) / 2.0, 0.0, 1.0)


def _fold3(m: torch.Tensor, dim: int) -> torch.Tensor:
    """Adjoint of a reflect-padded 3-tap window sum along ``dim``: each index
    sums the windows that read it, zero beyond the edges; index 1 reads
    window 0 once more and index n-2 window n-1 (the pad's reflected taps)."""
    n = m.shape[dim]
    p = F.pad(m.movedim(dim, -1), (1, 1)).movedim(-1, dim)
    s = (p.narrow(dim, 0, n) + p.narrow(dim, 1, n)) + p.narrow(dim, 2, n)
    s.narrow(dim, 1, 1).add_(m.narrow(dim, 0, 1))
    s.narrow(dim, n - 2, 1).add_(m.narrow(dim, n - 1, 1))
    return s


def ssim_nchw_bwd_plain(
    x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, need_x: bool = False
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain version of :func:`ssim_nchw_bwd`, the kernel's algorithm in
    tensor ops: the window statistics and the clip's mask as the forward
    computes them, the per-window coefficients of ``csrc/ssim_bwd.cu``, and
    their transposed 3x3 sum through the reflect pad. ``(d/dx or None,
    d/dy)`` of ``sum(g * ssim_nchw_plain(x, y))``."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect")
    yp = F.pad(y, (1, 1, 1, 1), mode="reflect")
    mu_x = _mean3(xp, h, w)
    mu_y = _mean3(yp, h, w)
    sigma_x = _mean3(xp * xp, h, w) - mu_x * mu_x
    sigma_y = _mean3(yp * yp, h, w) - mu_y * mu_y
    sigma_xy = _mean3(xp * yp, h, w) - mu_x * mu_y
    a = 2.0 * mu_x * mu_y + C1
    b = 2.0 * sigma_xy + C2
    d1 = mu_x * mu_x + mu_y * mu_y + C1
    d2 = sigma_x + sigma_y + C2
    d = d1 * d2
    r = (a * b) / d
    val = (1.0 - r) / 2.0
    # t: 2/9 of d loss / d n; each map is d loss / d (one window sum).
    t = torch.where((val >= 0.0) & (val <= 1.0), g, torch.zeros_like(g)) * (-1.0 / 9.0) / d
    tr = t * r
    dm = t * b - t * a
    dv = tr * d1 - tr * d2
    fold = lambda m: _fold3(_fold3(m, -1), -2)
    t_yy2, t_xy = fold(-tr * d1), fold(t * a)  # 2 a_yy and a_xy, summed
    dy = (fold(mu_x * dm + mu_y * dv) + y * t_yy2) + x * t_xy
    dx = (fold(mu_y * dm + mu_x * dv) + x * t_yy2) + y * t_xy if need_x else None
    return dx, dy


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """SSIM dissimilarity on NHWC ``[B, H, W, C]`` images (plain)."""
    to_nchw = lambda a: a.permute(0, 3, 1, 2)
    return ssim_nchw_plain(to_nchw(x), to_nchw(y)).permute(0, 2, 3, 1)


@functools.cache
def _fwd_kernel():
    lib = _build.load("ssim")
    fn = lib.ssim_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _bwd_kernel():
    lib = _build.load("ssim_bwd")
    fn = lib.ssim_bwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(name: str, tensors) -> None:
    _build.check_tensors(name, tensors)
    x = tensors[0]
    if x.dim() != 4 or any(t.shape != x.shape for t in tensors):
        raise ValueError(f"{name}: bad shapes {[tuple(t.shape) for t in tensors]}")
    f, c, h, w = x.shape
    if h < 2 or w < 2:
        raise ValueError(f"{name}: reflect padding needs H, W >= 2, got {h}x{w}")


def _launch_fwd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    f, c, h, w = x.shape
    out = torch.empty_like(x)
    lib, fwd = _fwd_kernel()
    code = fwd(x.data_ptr(), y.data_ptr(), out.data_ptr(), f * c, h, w, _build.stream(x))
    _build.check(lib, code, "ssim_nchw")
    ssim_nchw.launches += 1
    return out


def ssim_nchw_bwd(
    x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, need_x: bool = False
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """``(d/dx or None, d/dy)`` of ``sum(g * ssim_nchw(x, y))``, all
    ``[F, C, H, W]``: the backward kernel on one CUDA device, its plain
    version :func:`ssim_nchw_bwd_plain` on CPU tensors."""
    if all(t.device.type == "cpu" for t in (x, y, g)):
        return ssim_nchw_bwd_plain(x, y, g, need_x)
    _check("ssim_nchw_bwd", (x, y, g))
    f, c, h, w = x.shape
    dy = torch.empty_like(y)
    dx = torch.empty_like(x) if need_x else None
    lib, bwd = _bwd_kernel()
    code = bwd(x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr() if need_x else None,
               dy.data_ptr(), f * c, h, w, _build.stream(x))
    _build.check(lib, code, "ssim_nchw_bwd")
    ssim_nchw_bwd.launches += 1
    return dx, dy


ssim_nchw_bwd.launches = 0


class _Ssim(torch.autograd.Function):
    """Forward kernel, backward kernel."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return _launch_fwd(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        need_x, need_y = ctx.needs_input_grad
        dx, dy = ssim_nchw_bwd(x, y, g.contiguous(), need_x)
        return dx, dy if need_y else None


def ssim_nchw(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """SSIM dissimilarity map of ``x`` and ``y`` ``[F, C, H, W]`` float32."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return ssim_nchw_plain(x, y)
    _check("ssim_nchw", (x, y))
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        return _Ssim.apply(x, y)
    return _launch_fwd(x, y)


ssim_nchw.launches = 0


def ssim_nchw_sharded(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """:func:`ssim_nchw` of this shard's columns of width-sharded images:
    the x and y tiles widened by one halo column on their inner sides (one
    exchange for both), the map of the widened tiles cropped back. The
    kernels' own reflect pad then falls on columns the crop drops, or on
    the image's edges. ``ssim_nchw`` without width sharding."""
    if distributed.spatial_count() == 1:
        return ssim_nchw(x, y)
    c, w = x.shape[1], x.shape[-1]
    xy = distributed.halo(torch.cat([x, y], 1), 1, 1)
    xe, ye = xy[:, :c], xy[:, c:]
    if not x.requires_grad:  # no d/dx from the backward kernel
        xe = xe.detach()
    first = 1 if distributed.spatial_index() > 0 else 0
    return ssim_nchw(xe.contiguous(), ye.contiguous())[..., first:first + w]
