"""ResNet feature-pyramid encoder (NCHW inside).

The counterpart of the JAX package's ``models/resnet.py``: a
torchvision-layout ResNet (18/34/50/101/152) truncated to its 5 feature
stages, with an optional multi-image input (the first conv takes
``3 * num_input_images`` channels). Parameter names follow the reference's
checkpoints (``encoder.conv1``, ``encoder.layer1.0.bn1``,
``encoder.layer2.0.downsample.0`` ...), so the port's state dicts are the
reference's. Only the unpacked math is ported.

BatchNorm computes in fp32 whatever its input dtype: convolutions may run
in bf16 under autocast, the normalization does not.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

STAGE_BLOCKS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
BOTTLENECK = {18: False, 34: False, 50: True, 101: True, 152: True}


def encoder_channels(num_layers: int) -> Tuple[int, ...]:
    """Per-stage output channels."""
    base = (64, 64, 128, 256, 512)
    if BOTTLENECK[num_layers]:
        return (64,) + tuple(c * 4 for c in base[1:])
    return base


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


@torch.no_grad()
def kaiming_normal_fan_out_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """torchvision's ResNet conv init: normal, std sqrt(2 / fan_out)."""
    fan_out = weight.shape[0] * weight[0, 0].numel()
    w = torch.empty(weight.shape).normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
    weight.copy_(w)


@torch.no_grad()
def torch_default_conv_init_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """``nn.Conv2d``'s own init: uniform in +-1/sqrt(fan_in), weight and bias."""
    bound = 1.0 / math.sqrt(conv.weight[0].numel())
    conv.weight.copy_(torch.empty(conv.weight.shape).uniform_(-bound, bound, generator=generator))
    if conv.bias is not None:
        conv.bias.copy_(torch.empty(conv.bias.shape).uniform_(-bound, bound, generator=generator))


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) computed in fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: stride on the 3x3 conv, expansion 4."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """torchvision-layout ResNet body: conv1/bn1/maxpool, layer1..layer4."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1):
        super().__init__()
        if num_layers not in STAGE_BLOCKS:
            raise ValueError(f"unsupported num_layers: {num_layers}")
        block = Bottleneck if BOTTLENECK[num_layers] else BasicBlock
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3 * num_input_images, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        blocks = STAGE_BLOCKS[num_layers]
        self.layer1 = self._make_layer(block, 64, blocks[0])
        self.layer2 = self._make_layer(block, 128, blocks[1], 2)
        self.layer3 = self._make_layer(block, 256, blocks[2], 2)
        self.layer4 = self._make_layer(block, 512, blocks[3], 2)

    def _make_layer(self, block, planes: int, n: int, stride: int = 1) -> nn.Sequential:
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * block.expansion, 1, stride, bias=False),
                BatchNorm2d(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * block.expansion
        layers += [block(self.inplanes, planes) for _ in range(1, n)]
        return nn.Sequential(*layers)


class ResNetEncoder(nn.Module):
    """5-stage feature pyramid ``[relu(bn1(conv1)), layer1..layer4]`` at
    strides 2..32 with channels ``encoder_channels(num_layers)``. Takes and
    returns NCHW."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = ResNet(num_layers, num_input_images)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        g = default_generator(generator)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_normal_fan_out_(m.weight, g)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        e = self.encoder
        feats = [F.relu(e.bn1(e.conv1(x)))]
        feats.append(e.layer1(e.maxpool(feats[-1])))
        feats.append(e.layer2(feats[-1]))
        feats.append(e.layer3(feats[-1]))
        feats.append(e.layer4(feats[-1]))
        return feats
