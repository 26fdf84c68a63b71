"""Monocular disparity network: ResNet encoder and multi-scale skip decoder.

The counterpart of the JAX package's ``models/disp_net.py``: decoder
channels 16..256, reflection-padded 3x3 convs with ELU, nearest x2
upsampling with encoder skips, and per-scale heads
``disp = 10 * sigmoid(x) + 0.01``. Returns 4 scales, fine to coarse.
Parameter names follow the reference checkpoint (``decoder.decoder.<i>``).
Only the unpacked math is ported; the JAX package's lane-packed decoder
computes the same numbers.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import ResNetEncoder, default_generator, encoder_channels, torch_default_conv_init_

ALPHA = 10.0
BETA = 0.01
DEC_CHANNELS = (16, 32, 64, 128, 256)
SCALES = (0, 1, 2, 3)


class Conv3x3(nn.Module):
    """Reflection-pad 1, then a 3x3 valid conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class ConvBlock(nn.Module):
    """``Conv3x3`` then ELU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv3x3(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(x))


class DepthDecoder(nn.Module):
    """Skip-connected decoder. ``self.decoder`` is ordered as the
    reference's: ``[upconv_4_0, upconv_4_1, ..., upconv_0_1, dispconv_0..3]``."""

    def __init__(self, num_ch_enc: Sequence[int]):
        super().__init__()
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
        x = feats[-1]
        for k, i in enumerate(range(4, -1, -1)):
            x = self.decoder[2 * k](x)
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            if i > 0:
                x = torch.cat([x, feats[i - 1]], dim=1)
            x = self.decoder[2 * k + 1](x)
            if i in SCALES:
                disp = self.decoder[10 + i](x)
                outputs[i] = ALPHA * torch.sigmoid(disp.float()) + BETA
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
