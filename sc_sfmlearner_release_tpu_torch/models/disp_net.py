"""Monocular disparity network: ResNet encoder and multi-scale skip decoder.

The counterpart of the JAX package's ``models/disp_net.py``: decoder
channels 16..256, reflection-padded 3x3 convs with ELU, nearest x2
upsampling with encoder skips, and per-scale heads
``disp = 10 * sigmoid(x) + 0.01``. Returns 4 scales, fine to coarse.
Parameter names follow the reference checkpoint (``decoder.decoder.<i>``).
Only the unpacked math is ported; the JAX package's lane-packed decoder
computes the same numbers. Each convolution's input (the upsampling, the
skip concatenation and the reflect pad) is ``ops/decoder_input.py``'s: one
kernel on the card, written channels-last, the plain composition on the
CPU. Under width sharding (``parallel/spatial.py``) the pads take their
halos from the neighbouring shards; the nearest upsampling and the skip
concatenations stay on the shard's own columns.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.decoder_input import decoder_input
from .resnet import ResNetEncoder, default_generator, encoder_channels, torch_default_conv_init_

ALPHA = 10.0
BETA = 0.01
DEC_CHANNELS = (16, 32, 64, 128, 256)
SCALES = (0, 1, 2, 3)


class Conv3x3(nn.Module):
    """A 3x3 valid conv on ``decoder_input(x, skip, scale)``: ``x``
    upsampled by ``scale``, ``skip`` after it, reflection-padded by 1
    (under width sharding the halo inside the image)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3)

    def forward(self, x: Optional[torch.Tensor], skip: Optional[torch.Tensor] = None,
                scale: int = 1) -> torch.Tensor:
        return self.conv(decoder_input(x, skip, scale))


class ConvBlock(nn.Module):
    """``Conv3x3`` then ELU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv3x3(cin, cout)

    def forward(self, x: Optional[torch.Tensor], skip: Optional[torch.Tensor] = None,
                scale: int = 1) -> torch.Tensor:
        return F.elu(self.conv(x, skip, scale))


class DepthDecoder(nn.Module):
    """Skip-connected decoder. ``self.decoder`` is ordered as the
    reference's: ``[upconv_4_0, upconv_4_1, ..., upconv_0_1, dispconv_0..3]``.
    ``head``: ``"sc_depth"`` gives SC-Depth's ``10 * sigmoid(x) + 0.01``,
    ``"sigmoid"`` Monodepth2's plain ``sigmoid(x)`` (ManyDepth's decoders)."""

    def __init__(self, num_ch_enc: Sequence[int], head: str = "sc_depth"):
        super().__init__()
        if head not in ("sc_depth", "sigmoid"):
            raise ValueError(f"unknown head {head!r}")
        self.head = head
        mods = []
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else DEC_CHANNELS[i + 1]
            mods.append(ConvBlock(cin, DEC_CHANNELS[i]))
            cin = DEC_CHANNELS[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            mods.append(ConvBlock(cin, DEC_CHANNELS[i]))
        mods += [Conv3x3(DEC_CHANNELS[s], 1) for s in SCALES]
        self.decoder = nn.ModuleList(mods)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        outputs = {}
        x = None  # upconv_4_0 pads the deepest feature alone
        for k, i in enumerate(range(4, -1, -1)):
            x = self.decoder[2 * k](x, feats[-1] if x is None else None)
            x = self.decoder[2 * k + 1](x, feats[i - 1] if i > 0 else None, scale=2)
            if i in SCALES:
                disp = torch.sigmoid(self.decoder[10 + i](x).float())
                outputs[i] = disp if self.head == "sigmoid" else ALPHA * disp + BETA
        return tuple(outputs[s] for s in SCALES)


class DispNet(nn.Module):
    """Depth network: ``[B, H, W, 3]`` -> 4-scale disparities
    ``[B, H/2^s, W/2^s, 1]`` (fine to coarse); use ``[0]`` for inference."""

    def __init__(self, num_layers: int = 18, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.encoder = ResNetEncoder(num_layers, 1, generator=g)
        self.decoder = DepthDecoder(encoder_channels(num_layers))
        for m in self.decoder.modules():
            if isinstance(m, nn.Conv2d):
                torch_default_conv_init_(m, g)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        disps = self.decoder(self.encoder(x.permute(0, 3, 1, 2)))
        return tuple(d.permute(0, 2, 3, 1) for d in disps)
