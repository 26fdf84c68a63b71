"""The warp sampler: bilinear sampling of a packed source at warp coordinates.

``warp_sample`` launches the hand-written CUDA kernels of
``csrc/warp_sample.cu`` on CUDA tensors and runs ``warp_sample_plain``
(``ops/grid_sample.py``) on CPU tensors. ``inverse_warp2`` samples
``[source depth, R, G, B]`` as one 4-channel source, so one launch samples
both for all directed pairs.

Gradients: on CUDA tensors that need one, ``warp_sample`` goes through an
autograd Function whose forward launches ``warp_sample_fwd`` and whose
backward launches ``warp_sample_bwd`` (the wrapper of the same name): d(coords)
summed over every channel, and d(source) for the channels of ``src`` only.
Channels passed as ``frozen`` are sampled behind them and get no gradient
(the camera images), so none is computed or written for them. There is no
fallback to the plain path on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .grid_sample import grid_sample

PADDING_MODES = ("zeros", "border")


def warp_sample_plain(
    src: torch.Tensor, coords: torch.Tensor, padding_mode: str = "zeros",
    frozen: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`warp_sample`; its autograd is the plain
    version of :func:`warp_sample_bwd`."""
    if frozen is not None:
        src = torch.cat([src, frozen.detach()], dim=-1)
    return grid_sample(src, coords, padding_mode)


@functools.cache
def _kernels():
    lib = _build.load("warp_sample")
    fwd = lib.warp_sample_fwd
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.warp_sample_bwd
    bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return lib, fwd, bwd


def _check_shapes(src: torch.Tensor, coords: torch.Tensor) -> None:
    if src.dim() != 4 or coords.dim() != 4 or coords.shape[-1] != 2 \
            or coords.shape[0] != src.shape[0]:
        raise ValueError(
            f"warp_sample: bad shapes src {tuple(src.shape)}, "
            f"coords {tuple(coords.shape)}"
        )


def _launch_fwd(src: torch.Tensor, coords: torch.Tensor, padding_mode: str) -> torch.Tensor:
    f, h, w, c = src.shape
    ho, wo = coords.shape[1], coords.shape[2]
    out = torch.empty((f, ho, wo, c), dtype=src.dtype, device=src.device)
    lib, fwd, _ = _kernels()
    code = fwd(src.data_ptr(), coords.data_ptr(), out.data_ptr(), f, h, w, c,
               ho, wo, int(padding_mode == "border"), _build.stream(src))
    _build.check(lib, code, "warp_sample")
    warp_sample.launches += 1
    return out


def warp_sample_bwd(
    src: torch.Tensor, coords: torch.Tensor, dout: torch.Tensor,
    padding_mode: str = "zeros", grad_channels: int = 1, need_coords: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch the backward kernel: ``(d src[..., :grad_channels], d coords)``.

    ``src`` ``[F, H, W, C]``, ``coords`` ``[F, Ho, Wo, 2]`` and ``dout``
    ``[F, Ho, Wo, C]`` on one CUDA device. Returns ``None`` in place of the
    source gradient when ``grad_channels`` is 0 and of the coordinates'
    when ``need_coords`` is false. CUDA only; its plain version is the
    autograd of :func:`warp_sample_plain`.
    """
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    _build.check_tensors("warp_sample_bwd", (src, coords, dout))
    _check_shapes(src, coords)
    f, h, w, c = src.shape
    ho, wo = coords.shape[1], coords.shape[2]
    if tuple(dout.shape) != (f, ho, wo, c):
        raise ValueError(f"warp_sample_bwd: dout {tuple(dout.shape)}, "
                         f"expected {(f, ho, wo, c)}")
    if not 0 <= grad_channels <= c:
        raise ValueError(f"warp_sample_bwd: grad_channels {grad_channels} of {c}")
    if grad_channels == 0 and not need_coords:
        return None, None
    dsrc = torch.empty((f, h, w, grad_channels), dtype=src.dtype, device=src.device) \
        if grad_channels else None
    dcoords = torch.empty_like(coords) if need_coords else None
    lib, _, bwd = _kernels()
    code = bwd(src.data_ptr(), coords.data_ptr(), dout.data_ptr(),
               dcoords.data_ptr() if need_coords else None,
               dsrc.data_ptr() if grad_channels else None,
               f, h, w, c, grad_channels, ho, wo, int(padding_mode == "border"),
               _build.stream(src))
    _build.check(lib, code, "warp_sample_bwd")
    warp_sample_bwd.launches += 1
    return dsrc, dcoords


warp_sample_bwd.launches = 0


class _WarpSample(torch.autograd.Function):
    """Forward kernel, backward kernel; ``frozen`` channels get no gradient."""

    @staticmethod
    def forward(ctx, src, frozen, coords, padding_mode):
        packed = src if frozen is None else torch.cat([src, frozen], dim=-1)
        ctx.save_for_backward(packed, coords)
        ctx.padding_mode = padding_mode
        ctx.grad_channels = src.shape[-1]
        return _launch_fwd(packed, coords, padding_mode)

    @staticmethod
    def backward(ctx, dout):
        packed, coords = ctx.saved_tensors
        need_src, _, need_coords, _ = ctx.needs_input_grad
        dsrc, dcoords = warp_sample_bwd(
            packed, coords, dout.contiguous(), ctx.padding_mode,
            ctx.grad_channels if need_src else 0, need_coords)
        return dsrc, None, dcoords, None


def warp_sample(
    src: torch.Tensor, coords: torch.Tensor, padding_mode: str = "zeros",
    frozen: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample ``src`` ``[F, H, W, G]`` at ``coords`` ``[F, Ho, Wo, 2]``.

    Returns ``[F, Ho, Wo, G + D]``: the channels of ``src``, then those of
    ``frozen`` ``[F, H, W, D]`` if given, which are sampled without
    gradient. The semantics of ``F.grid_sample`` (bilinear,
    ``align_corners=False``) with ``zeros`` or ``border`` padding, on NHWC
    tensors.
    """
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    tensors = (src, coords) if frozen is None else (src, coords, frozen)
    if all(t.device.type == "cpu" for t in tensors):
        return warp_sample_plain(src, coords, padding_mode, frozen)
    _build.check_tensors("warp_sample", tensors)
    _check_shapes(src, coords)
    if frozen is not None and (frozen.dim() != 4 or frozen.shape[:3] != src.shape[:3]):
        raise ValueError(f"warp_sample: frozen {tuple(frozen.shape)} does not match "
                         f"src {tuple(src.shape)}")
    if frozen is not None:
        frozen = frozen.detach()
    if torch.is_grad_enabled() and (src.requires_grad or coords.requires_grad):
        return _WarpSample.apply(src, frozen, coords, padding_mode)
    packed = src if frozen is None else torch.cat([src, frozen], dim=-1)
    return _launch_fwd(packed, coords, padding_mode)


warp_sample.launches = 0
