"""SSIM dissimilarity map, 3x3 mean-pool formulation.

The counterpart of the JAX package's ``ops/ssim.py`` and of its Pallas
kernel ``ops/pallas_ssim.py``: reflection-pad by 1, 3x3 means for the local
statistics, ``clip((1 - SSIM) / 2, 0, 1)`` (0 = identical).

``ssim_nchw`` launches the hand-written CUDA kernel ``csrc/ssim.cu`` on
CUDA tensors and runs ``ssim_nchw_plain`` on CPU tensors. The kernel has no
backward yet: on a CUDA tensor that requires grad with grad mode on, the
wrapper raises rather than fall back to the plain path.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

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
    """Plain version of :func:`ssim_nchw`: ``[F, C, H, W]`` -> same shape."""
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


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """SSIM dissimilarity on NHWC ``[B, H, W, C]`` images (plain)."""
    to_nchw = lambda a: a.permute(0, 3, 1, 2)
    return ssim_nchw_plain(to_nchw(x), to_nchw(y)).permute(0, 2, 3, 1)


@functools.cache
def _kernel():
    lib = _build.load("ssim")
    fn = lib.ssim_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def ssim_nchw(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """SSIM dissimilarity map of ``x`` and ``y`` ``[F, C, H, W]`` float32."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return ssim_nchw_plain(x, y)
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(
            f"ssim_nchw: x on {x.device}, y on {y.device}; both must be on "
            "one CUDA device (or both on the CPU)"
        )
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        raise RuntimeError(
            "ssim_nchw: the CUDA kernel has no backward yet; call it under "
            "torch.no_grad()"
        )
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"ssim_nchw: needs float32, got {x.dtype}, {y.dtype}")
    if x.dim() != 4 or x.shape != y.shape:
        raise ValueError(
            f"ssim_nchw: bad shapes x {tuple(x.shape)}, y {tuple(y.shape)}"
        )
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("ssim_nchw: x and y must be contiguous")
    f, c, h, w = x.shape
    if h < 2 or w < 2:
        raise ValueError(f"ssim_nchw: reflect padding needs H, W >= 2, got {h}x{w}")
    if f * c > 65535 or x.numel() >= 2**31:
        raise ValueError(f"ssim_nchw: too large, shape {tuple(x.shape)}")

    out = torch.empty_like(x)
    lib, fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), f * c, h, w, stream)
    _build.check(lib, code, "ssim_nchw")
    ssim_nchw.launches += 1
    return out


ssim_nchw.launches = 0
