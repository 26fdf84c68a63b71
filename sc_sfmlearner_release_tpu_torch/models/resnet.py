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

Under width sharding (``parallel/spatial.py``) ``conv1``, the max-pool and
every 3x3 convolution take their halos from the neighbouring shards; the
1x1 convolutions (the stride-2 downsample too) need none.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import distributed, spatial

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
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) computed in fp32, with
    flax's running statistics.

    In train mode it normalises with the batch's biased variance, as both
    frameworks do, and moves ``running_var`` towards the *biased* variance
    as flax's ``BatchNorm`` does (torch's own uses the unbiased one, off by
    n/(n-1): 2.9% at n = 36 values per channel). The batch statistics come
    out of the one ``F.batch_norm`` call, into scratch buffers it overwrites
    (momentum 1); the running buffers then move by ``momentum``.

    Under a process group (``parallel.distributed``) the train-mode
    statistics are the global batch's, as in the JAX program over a data
    mesh: :meth:`_global_forward`. Each layer's forward and backward then
    make one all-reduce each: 40 of each a step for the two ResNet-18
    encoders' 20 layers each.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        if distributed.is_distributed():
            return self._global_forward(x)
        batch_mean = torch.zeros_like(self.running_mean)
        batch_var = torch.zeros_like(self.running_var)
        out = F.batch_norm(x, batch_mean, batch_var, self.weight, self.bias, True, 1.0,
                           self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.lerp_(batch_mean, self.momentum)
            self.running_var.lerp_(batch_var * ((n - 1) / n), self.momentum)
            self.num_batches_tracked.add_(1)
        return out

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode on the statistics of every process's batch
        (:class:`_GlobalBatchNorm`); the running statistics move by the
        same rule as above, towards the global mean and biased variance."""
        out, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return out


def _channels(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalization of ``x`` ``[N, C, H, W]`` (fp32) over
    the global batch, whose other rows (and, under width sharding, other
    columns) lie on the other processes; every process holds as many
    values per channel (the loader's row slices are equal, and so are the
    column slices), so the global statistics are the means of the
    processes' own.

    Forward: this process's per-channel mean and mean of squares, summed
    over processes in one all-reduce; the global mean and biased variance,
    and ``x`` normalized by them. Backward: this process's ``sum(dy)`` and
    ``sum(dy * (x - mean))`` per channel, summed over processes in one
    all-reduce, give the input gradient of the global batch's
    normalization; the weight and bias gradients are this process's
    shares (the train step sums them with every other gradient).

    On CUDA each pass over the activations is one of PyTorch's fused
    batch-norm kernels (``batch_norm_stats``, ``batch_norm_elemt``,
    ``batch_norm_backward_reduce``, ``batch_norm_backward_elemt``: the
    kernels of ``nn.SyncBatchNorm``, which refuses CPU tensors), in the
    activations' own memory format; on the CPU the same arithmetic in
    tensor ops. Returns the output and, without gradient, the global mean
    and biased variance."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c, processes = x.shape[1], distributed.process_count()
        if x.is_cuda:
            mean, invstd = torch.batch_norm_stats(x, eps)
            mean_sq = torch.addcmul(invstd.pow(-2) - eps, mean, mean)
        else:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            mean_sq = torch.addcmul(var, mean, mean)
        stats = distributed.global_sum(torch.cat([mean, mean_sq])) / processes
        mean = stats[:c]
        var = torch.clamp(torch.addcmul(stats[c:], mean, mean, value=-1.0), min=0.0)
        invstd = torch.rsqrt(var + eps)
        if x.is_cuda:
            out = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        else:
            scale = weight * invstd
            out = torch.addcmul(_channels(bias - mean * scale), x, _channels(scale))
        ctx.count = x.numel() // c * processes
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _mean_grad, _var_grad):
        x, weight, mean, invstd = ctx.saved_tensors
        c, count = x.shape[1], ctx.count
        # The input's memory format: the fused kernels' channels-last forms
        # read NHWC activations, a gradient in another format is copied.
        layout = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
                  else torch.contiguous_format)
        dy = dy.contiguous(memory_format=layout)
        if x.is_cuda:
            sum_dy, sum_dy_xmu, grad_weight, grad_bias = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, weight, True, True, True)
        else:
            xmu = x - _channels(mean)
            sum_dy, sum_dy_xmu = dy.sum((0, 2, 3)), (dy * xmu).sum((0, 2, 3))
            grad_weight, grad_bias = sum_dy_xmu * invstd, sum_dy
        sums = distributed.global_sum(torch.cat([sum_dy, sum_dy_xmu]))
        sum_dy, sum_dy_xmu = sums[:c], sums[c:]
        if x.is_cuda:
            counts = torch.full((1,), count, dtype=torch.int32, device=x.device)
            dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight, sum_dy,
                                                 sum_dy_xmu, counts)
        else:
            dx = (dy - _channels(sum_dy / count)
                  - xmu * _channels(invstd * invstd * sum_dy_xmu / count)) * _channels(
                      weight * invstd)
        return dx, grad_weight, grad_bias, None


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
        out = F.relu(self.bn1(spatial.conv2d(x, self.conv1)))
        out = self.bn2(spatial.conv2d(out, self.conv2))
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
        out = F.relu(self.bn2(spatial.conv2d(out, self.conv2)))
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
        feats = [F.relu(e.bn1(spatial.conv2d(x, e.conv1)))]
        feats.append(e.layer1(spatial.max_pool2d(feats[-1], e.maxpool)))
        feats.append(e.layer2(feats[-1]))
        feats.append(e.layer3(feats[-1]))
        feats.append(e.layer4(feats[-1]))
        return feats
