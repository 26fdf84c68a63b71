"""6-DoF relative pose network.

The counterpart of the JAX package's ``models/pose_net.py``: a 2-image
ResNet encoder (6-channel input), then a 1x1 squeeze to 256 + ReLU, two 3x3
convs + ReLU, a 1x1 conv to 6 channels, the mean over H and W, times 0.01.
Output ``[B, 6]`` = (tx, ty, tz, rx, ry, rz), target -> source. Parameter
names follow the reference checkpoint (``decoder.net.<i>``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import ResNetEncoder, default_generator, encoder_channels, torch_default_conv_init_


class PoseDecoder(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.net = nn.ModuleList([
            nn.Conv2d(cin, 256, 1),           # squeeze
            nn.Conv2d(256, 256, 3, 1, 1),     # pose_0
            nn.Conv2d(256, 256, 3, 1, 1),     # pose_1
            nn.Conv2d(256, 6, 1),             # pose_2
        ])

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.net[0](feat))
        x = F.relu(self.net[1](x))
        x = F.relu(self.net[2](x))
        x = self.net[3](x)
        return 0.01 * x.float().mean(dim=(2, 3)).reshape(-1, 6)


class PoseNet(nn.Module):
    """Relative pose of ``img2`` from ``img1``, both ``[B, H, W, 3]``."""

    def __init__(self, num_layers: int = 18, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.encoder = ResNetEncoder(num_layers, 2, generator=g)
        self.decoder = PoseDecoder(encoder_channels(num_layers)[-1])
        for m in self.decoder.modules():
            if isinstance(m, nn.Conv2d):
                torch_default_conv_init_(m, g)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        x = torch.cat([img1, img2], dim=-1).permute(0, 3, 1, 2)
        return self.decoder(self.encoder(x)[-1])
