"""The warp sampler: bilinear sampling of a packed source at warp coordinates.

``warp_sample`` launches the hand-written CUDA kernel ``csrc/warp_sample.cu``
on CUDA tensors and runs ``warp_sample_plain`` (``ops/grid_sample.py``) on
CPU tensors. ``inverse_warp2`` packs ``[source depth, R, G, B]`` into one
4-channel source, so one launch samples both for all directed pairs.

The kernel has no backward yet: on a CUDA tensor that requires grad with
grad mode on, the wrapper raises rather than fall back to the plain path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .grid_sample import grid_sample

PADDING_MODES = ("zeros", "border")


def warp_sample_plain(
    src: torch.Tensor, coords: torch.Tensor, padding_mode: str = "zeros"
) -> torch.Tensor:
    """Plain version of :func:`warp_sample`."""
    return grid_sample(src, coords, padding_mode)


@functools.cache
def _kernel():
    lib = _build.load("warp_sample")
    fn = lib.warp_sample_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def warp_sample(
    src: torch.Tensor, coords: torch.Tensor, padding_mode: str = "zeros"
) -> torch.Tensor:
    """Sample ``src`` ``[F, H, W, C]`` at ``coords`` ``[F, Ho, Wo, 2]``.

    Returns ``[F, Ho, Wo, C]``; the semantics of ``F.grid_sample``
    (bilinear, ``align_corners=False``) with ``zeros`` or ``border``
    padding, on NHWC tensors.
    """
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    if src.device.type == "cpu" and coords.device.type == "cpu":
        return warp_sample_plain(src, coords, padding_mode)
    if src.device.type != "cuda" or coords.device != src.device:
        raise ValueError(
            f"warp_sample: src on {src.device}, coords on {coords.device}; "
            "both must be on one CUDA device (or both on the CPU)"
        )
    if torch.is_grad_enabled() and (src.requires_grad or coords.requires_grad):
        raise RuntimeError(
            "warp_sample: the CUDA kernel has no backward yet; call it "
            "under torch.no_grad()"
        )
    if src.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError(
            f"warp_sample: needs float32, got src {src.dtype}, coords {coords.dtype}"
        )
    if src.dim() != 4 or coords.dim() != 4 or coords.shape[-1] != 2 \
            or coords.shape[0] != src.shape[0]:
        raise ValueError(
            f"warp_sample: bad shapes src {tuple(src.shape)}, "
            f"coords {tuple(coords.shape)}"
        )
    if not (src.is_contiguous() and coords.is_contiguous()):
        raise ValueError("warp_sample: src and coords must be contiguous")
    f, h, w, c = src.shape
    ho, wo = coords.shape[1], coords.shape[2]
    if src.numel() >= 2**31 or coords.numel() >= 2**31:
        raise ValueError("warp_sample: tensors must hold fewer than 2^31 elements")

    out = torch.empty((f, ho, wo, c), dtype=src.dtype, device=src.device)
    lib, fn = _kernel()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(src.data_ptr(), coords.data_ptr(), out.data_ptr(), f, h, w, c,
                  ho, wo, int(padding_mode == "border"), stream)
    _build.check(lib, code, "warp_sample")
    warp_sample.launches += 1
    return out


warp_sample.launches = 0
