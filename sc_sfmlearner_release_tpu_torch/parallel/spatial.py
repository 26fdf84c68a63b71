"""Halo-aware 2-D ops on width-sharded tensors (``--spatial-shards``).

Under width sharding (``distributed.init_distributed(spatial_shards=S)``)
each process holds one equal column slice of every image and of every
feature map of the networks, at a column offset of ``spatial_index *
width``. Where the JAX program over ``make_mesh_2d``'s mesh lets GSPMD
exchange halos, these ops take the neighbours' edge columns through
``distributed.halo`` and pad only at the image's own edges:

  * :func:`conv2d`: zeros beyond the image (the convolution's padding);
  * :func:`max_pool2d`: -inf beyond the image;
  * :func:`reflect_pad1`: reflection at the image's edges, the halo inside.

A stride-2 window's halo is asymmetric: output column j of a k-wide,
p-padded window reads input columns ``2j - p ... 2j - p + k - 1``, so a
shard whose offset and width are even needs ``p`` columns on its left and
``k - 2 - p`` on its right (3 and 2 for the encoder's 7x7/s2/p3 ``conv1``,
1 and 0 for the 3x3/s2/p1 max-pool, none for the 1x1/s2 downsample).
:func:`column_offset` and :func:`global_width` give the shard's place in
the image for the geometry and the losses, and :func:`mean_hw` the mean
over a map's height and whole width. Without width sharding each op is
the plain one.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import distributed


def column_offset(width: int) -> int:
    """The image column of this shard's first column, for shards ``width``
    columns wide."""
    return distributed.spatial_index() * width


def global_width(width: int) -> int:
    """The image's width, from a shard's ``width``."""
    return width * distributed.spatial_count()


def _edges() -> Tuple[bool, bool]:
    """Whether this shard holds the image's left edge, and its right edge."""
    i = distributed.spatial_index()
    return i == 0, i == distributed.spatial_count() - 1


def halo_widths(kernel: int, stride: int, padding: int, width: int) -> Tuple[int, int]:
    """The columns a window of ``kernel``, ``stride`` and ``padding`` reads
    beyond a shard ``width`` wide, left and right. A stride needs the
    shard's offset and width to be multiples of it."""
    if width % stride:
        raise ValueError(f"a stride-{stride} window over a shard {width} columns wide: "
                         "the train CLI needs W to be a multiple of 32 * --spatial-shards")
    return padding, max(0, kernel - 1 - padding - (stride - 1))


def _widen(x: torch.Tensor, left: int, right: int, **pad) -> torch.Tensor:
    """``x`` with ``left``/``right`` halo columns from the neighbours and,
    at the image's edges, ``F.pad``'s ``pad`` in their place."""
    first, last = _edges()
    x = distributed.halo(x, left, right)
    edge = (left if first else 0, right if last else 0)
    return F.pad(x, edge + (0, 0), **pad) if any(edge) else x


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv(x)`` on this shard's columns of NCHW ``x``: the halo the
    window needs, zeros beyond the image (the convolution's own padding)."""
    if distributed.spatial_count() == 1:
        return conv(x)
    left, right = halo_widths(conv.kernel_size[1], conv.stride[1], conv.padding[1],
                              x.shape[-1])
    x = _widen(x, left, right)
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, (conv.padding[0], 0),
                    conv.dilation, conv.groups)


def max_pool2d(x: torch.Tensor, pool: nn.MaxPool2d) -> torch.Tensor:
    """``pool(x)`` on this shard's columns: the halo, -inf beyond the image."""
    if distributed.spatial_count() == 1:
        return pool(x)
    k, s, p = pool.kernel_size, pool.stride, pool.padding
    left, right = halo_widths(k, s, p, x.shape[-1])
    x = _widen(x, left, right, value=float("-inf"))
    return F.max_pool2d(x, k, s, (p, 0))


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """Reflect-pad the last two axes of ``x`` by 1. A size-1 axis (the
    deepest feature map of a 32-row image) replicates its only element, as
    numpy's and the JAX package's reflect do; ``F.pad`` refuses it. Under
    width sharding the image's width is at least 2: the shard takes one
    halo column from each neighbour and reflects only at the image's edges,
    over the halo where the shard is one column wide."""
    if distributed.spatial_count() > 1:
        x = _widen(x, 1, 1, mode="reflect")
    elif x.shape[-1] > 1 and x.shape[-2] > 1:
        return F.pad(x, (1, 1, 1, 1), mode="reflect")
    else:
        x = F.pad(x, (1, 1, 0, 0), mode="reflect" if x.shape[-1] > 1 else "replicate")
    return F.pad(x, (0, 0, 1, 1), mode="reflect" if x.shape[-2] > 1 else "replicate")


def mean_hw(x: torch.Tensor, h_dim: int, w_dim: int, keepdim: bool = False) -> torch.Tensor:
    """The mean of ``x`` over its height and the image's whole width, the
    same on every shard of a data group (a spatial sum of the shards'
    sums); ``x.mean`` without width sharding."""
    dims = (h_dim, w_dim)
    if distributed.spatial_count() == 1:
        return x.mean(dim=dims, keepdim=keepdim)
    count = x.shape[h_dim] * global_width(x.shape[w_dim])
    return distributed.spatial_sum(x.sum(dim=dims, keepdim=keepdim)) / count
