"""The input of one ``DepthDecoder`` convolution: the previous block's
output upsampled (nearest, x1 or x2), the encoder's skip after it on the
channels, reflect-padded by 1, in the dtype the convolution computes in.

``decoder_input`` launches the hand-written CUDA kernel of
``csrc/decoder_input.cu`` on CUDA tensors, through an autograd Function
whose backward launches the same source's backward kernel
(``decoder_input_bwd``). It writes the padded input once, channels-last
(NHWC strides), so cuDNN runs the convolution in NHWC without transposing
it, and the decoder's activations and gradients stay channels-last.
``decoder_input_plain`` is the composition the kernel replaces (``F.interpolate``,
``torch.cat``, ``parallel/spatial.py``'s ``reflect_pad1``, then autocast's cast
inside the convolution); CPU tensors take it.

Under width sharding the source and the skip first take one column from
each neighbouring shard (``distributed.halo``, whose backward sends the
halo's gradient back); the kernel reflects only at the image's edges and
reads the halo elsewhere, as ``reflect_pad1`` pads a shard.

The dtype is the one the convolution computes in: autocast's on the card
where it is on (bf16 in the train step), else fp32 (``precision="fp32"``).
The kernel takes fp32 sources, bf16 sources under autocast, fp32 skips
(BatchNorm's output) and channel counts in multiples of 8: every
``DepthDecoder`` input's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import distributed
from ..parallel.spatial import reflect_pad1
from . import _build

CODES = {torch.float32: 0, torch.bfloat16: 1}
LAST = torch.channels_last


def decoder_input_plain(x: Optional[torch.Tensor], skip: Optional[torch.Tensor] = None,
                        scale: int = 1) -> torch.Tensor:
    """Plain version of :func:`decoder_input`: ``reflect_pad1`` of
    ``torch.cat([upsample(x), skip], 1)``, of whichever of them is given."""
    if x is not None and scale != 1:
        x = F.interpolate(x, scale_factor=scale, mode="nearest")
    if x is None or skip is None:
        return reflect_pad1(x if skip is None else skip)
    return reflect_pad1(torch.cat([x, skip], dim=1))


def uses_kernel(t: torch.Tensor) -> bool:
    """Whether :func:`decoder_input` launches the kernel for an input on
    ``t``'s device: a CUDA tensor."""
    return t.device.type == "cuda"


def conv_dtype() -> torch.dtype:
    """The dtype a convolution on the card computes in: autocast's where it
    is on, else fp32."""
    if torch.is_autocast_enabled("cuda"):
        return torch.get_autocast_dtype("cuda")
    return torch.float32


def halo_sides() -> Tuple[int, int]:
    """The halo columns this width shard takes on its left and its right:
    1 where a neighbouring shard holds them, 0 at the image's edges."""
    i, s = distributed.spatial_index(), distributed.spatial_count()
    return int(i > 0), int(i < s - 1)


@functools.cache
def _kernels():
    lib = _build.load("decoder_input")
    args = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    for fn in (lib.decoder_input_fwd, lib.decoder_input_bwd):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib, lib.decoder_input_fwd, lib.decoder_input_bwd


def _last(t: torch.Tensor) -> torch.Tensor:
    """``t`` channels-last and 16-byte aligned, as the kernels read and
    write NHWC (a copy only for a view that is neither)."""
    t = t.contiguous(memory_format=LAST)
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=LAST)


class _Shape:
    """The launch's sizes and dtypes, from the inputs with their ``left``
    and ``right`` halo columns (``w`` and ``W``: the shard's own)."""

    def __init__(self, x, skip, scale, out_dtype, left=0, right=0):
        ref = x if x is not None else skip
        halo = left + right
        self.n = ref.shape[0]
        self.cs, self.h, self.w = ((x.shape[1], x.shape[2], x.shape[3] - halo)
                                   if x is not None else (0, 0, 0))
        self.ck = skip.shape[1] if skip is not None else 0
        self.H, self.W = ((skip.shape[2], skip.shape[3] - halo) if skip is not None
                          else (self.h * scale, self.w * scale))
        self.scale, self.left, self.right = scale, left, right
        self.src_dtype = x.dtype if x is not None else None
        self.out_dtype = out_dtype

    def args(self):
        src_code = CODES.get(self.src_dtype, 0)  # an absent source's pointer is null
        return (self.n, self.cs, self.h, self.w, self.scale, self.ck, self.H, self.W,
                self.left, self.right, src_code, CODES[self.out_dtype])


def _launch_fwd(x, skip, s: _Shape) -> torch.Tensor:
    ref = x if x is not None else skip
    out = torch.empty((s.n, s.cs + s.ck, s.H + 2, s.W + 2), dtype=s.out_dtype,
                      device=ref.device, memory_format=LAST)
    lib, fwd, _ = _kernels()
    code = fwd(x.data_ptr() if x is not None else None,
               skip.data_ptr() if skip is not None else None, out.data_ptr(), *s.args(),
               _build.stream(ref))
    _build.check(lib, code, "decoder_input")
    decoder_input.launches += 1
    return out


def decoder_input_bwd(g: torch.Tensor, s: _Shape, need_src: bool, need_skip: bool):
    """``(d/dx or None, d/dskip or None)`` from the assembled input's
    gradient ``g`` (channels-last, the output's dtype): one launch of the
    backward kernel; d/dx channels-last in the source's dtype, d/dskip
    contiguous fp32, each with its halo columns."""
    halo = s.left + s.right
    dx = (torch.empty((s.n, s.cs, s.h, s.w + halo), dtype=s.src_dtype, device=g.device,
                      memory_format=LAST) if need_src else None)
    dskip = (torch.empty((s.n, s.ck, s.H, s.W + halo), device=g.device)
             if need_skip else None)
    if dx is None and dskip is None:
        return None, None
    lib, _, bwd = _kernels()
    code = bwd(g.data_ptr(), dx.data_ptr() if dx is not None else None,
               dskip.data_ptr() if dskip is not None else None, *s.args(),
               _build.stream(g))
    _build.check(lib, code, "decoder_input_bwd")
    decoder_input_bwd.launches += 1
    return dx, dskip


decoder_input_bwd.launches = 0


class _DecoderInput(torch.autograd.Function):
    """Forward kernel, backward kernel; nothing saved but the sizes."""

    @staticmethod
    def forward(ctx, x, skip, s: _Shape):
        ctx.shape = s
        return _launch_fwd(x, skip, s)

    @staticmethod
    def backward(ctx, g):
        s = ctx.shape
        g = _last(g.to(s.out_dtype))
        dx, dskip = decoder_input_bwd(g, s, ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return dx, dskip, None


def _check(x, skip, scale: int, out_dtype: torch.dtype) -> None:
    tensors = [t for t in (x, skip) if t is not None]
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"decoder_input: tensors on {[str(t.device) for t in tensors]}; all "
                         "must be on one CUDA device (or all on the CPU)")
    if ((x is not None and x.dtype not in CODES) or out_dtype not in CODES
            or (skip is not None and skip.dtype != torch.float32)
            or (x is not None and x.dtype == torch.bfloat16 and out_dtype != x.dtype)):
        raise TypeError(f"decoder_input: takes fp32 sources, bf16 ones under autocast and fp32 "
                        f"skips into fp32 or bf16, got {[t.dtype for t in tensors]} into "
                        f"{out_dtype}")
    if any(t.dim() != 4 for t in tensors) or scale not in (1, 2) or (x is None and scale != 1):
        raise ValueError(f"decoder_input: 4-d inputs and scale 1 or 2 (2 only with a source), "
                         f"got {[tuple(t.shape) for t in tensors]} at scale {scale}")
    if x is not None and x.shape[1] % 8 or sum(t.shape[1] for t in tensors) % 8:
        raise ValueError(f"decoder_input: the kernel takes channels in multiples of 8, got "
                         f"{[t.shape[1] for t in tensors]}")
    if x is not None and skip is not None and (
            skip.shape[0] != x.shape[0] or skip.shape[2:] != (x.shape[2] * scale,
                                                               x.shape[3] * scale)):
        raise ValueError(f"decoder_input: skip {tuple(skip.shape)} does not follow the source "
                         f"{tuple(x.shape)} at scale {scale}")
    n, c = tensors[0].shape[0], sum(t.shape[1] for t in tensors)
    h, w = (skip.shape[2:] if skip is not None else (x.shape[2] * scale, x.shape[3] * scale))
    if max(t.numel() for t in tensors) >= 2**31 or n * c * (h + 2) * (w + 2) >= 2**31:
        raise ValueError("decoder_input: tensors must hold fewer than 2^31 elements")


def decoder_input(x: Optional[torch.Tensor], skip: Optional[torch.Tensor] = None,
                  scale: int = 1) -> torch.Tensor:
    """The padded input ``[N, Cs + Ck, H + 2, W + 2]`` of a decoder
    convolution: ``x`` ``[N, Cs, H / scale, W / scale]`` (the previous
    block's output; None: the skip alone) upsampled by ``scale`` (1 or 2,
    nearest), then ``skip`` ``[N, Ck, H, W]`` (None: the source alone),
    reflect-padded by 1 (under width sharding: the halo inside the image).
    On the card, channels-last in the convolution's dtype
    (:func:`conv_dtype`); plain elsewhere (:func:`uses_kernel`)."""
    ref = x if x is not None else skip
    if not uses_kernel(ref):
        return decoder_input_plain(x, skip, scale)
    out_dtype = conv_dtype()
    _check(x, skip, scale, out_dtype)
    left, right = halo_sides()
    if left or right:
        x, skip = (distributed.halo(t, 1, 1) if t is not None else None for t in (x, skip))
    x = _last(x) if x is not None else None
    skip = skip.contiguous() if skip is not None else None
    s = _Shape(x, skip, scale, out_dtype, left, right)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, skip)):
        return _DecoderInput.apply(x, skip, s)
    return _launch_fwd(x, skip, s)


decoder_input.launches = 0
