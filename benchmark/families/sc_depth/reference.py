"""The plain PyTorch reference of the ``sc_depth`` family's training cells.

SC-Depth's train step written out in plain ``torch`` ops, independent of
the port: the ResNet encoders (BasicBlock and Bottleneck) with train-mode
BatchNorm on the batch's statistics, DispNet's decoder and PoseNet's head,
the inverse warp through ``F.grid_sample``, SSIM through ``F.avg_pool2d``,
the photometric, geometry-consistency and smoothness losses, and Adam.
Modules carry the reference checkpoints' names (the port's too), so
``weights.init_weights`` gives both sides the same weights.

Precision: ``"fp32"`` computes everything in float32 with TF32 off;
``"bf16"`` runs each convolution on bfloat16 operands with a bfloat16
output, as autocast does, and everything else in float32 (the
configurations' precision, so the reference); ``"fp8"`` rounds each convolution's input, weight and output
to float8 e4m3 and the gradient of its output to e5m2 (one scale per
tensor; the rounding of the input and weight passes the gradient straight
through) and computes the rest in float32: the control, one precision
below the configuration's bf16 convolutions. Imports neither JAX nor anything of the port.

``Step`` is what the shared ``follow.py`` calls: the networks at a
precision, Adam over their leaves and one batch's loss.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.weights import init_weights

PRECISIONS = ("fp32", "bf16", "fp8")


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to a float8 ``dtype`` with one scale for the tensor."""
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """Forward: ``x`` rounded to e4m3. Backward: with ``grad``, the gradient
    rounded to e5m2 (a convolution's output), else passed straight through
    (its input and weight): float8 operands and results in all three of
    the convolution's products, as bf16 autocast has bf16 ones."""

    @staticmethod
    def forward(ctx, x, grad):
        ctx.grad = grad
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return (_round(g, torch.float8_e5m2) if ctx.grad else g), None


class Conv2d(nn.Conv2d):
    precision = "fp32"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "bf16":  # as autocast runs it: bf16 in and out
            b = None if self.bias is None else self.bias.bfloat16()
            return F.conv2d(x.bfloat16(), self.weight.bfloat16(), b, self.stride, self.padding)
        if self.precision != "fp8":
            return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)
        out = F.conv2d(_Fp8.apply(x, False), _Fp8.apply(self.weight, False), self.bias,
                       self.stride, self.padding)
        return _Fp8.apply(out, True)


class BatchNorm2d(nn.BatchNorm2d):
    """Train mode on the batch's mean and biased variance (running
    statistics are not read)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
        xhat = (x - mean) * torch.rsqrt(var + self.eps)
        return xhat * self.weight[:, None, None] + self.bias[:, None, None]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample=None):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample=None):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


BLOCKS = {18: (BasicBlock, (2, 2, 2, 2)), 50: (Bottleneck, (3, 4, 6, 3))}


class ResNet(nn.Module):
    def __init__(self, layers: int, inputs: int):
        super().__init__()
        block, counts = BLOCKS[layers]
        self.inplanes = 64
        self.conv1 = Conv2d(3 * inputs, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.layer1 = self._layer(block, 64, counts[0], 1)
        self.layer2 = self._layer(block, 128, counts[1], 2)
        self.layer3 = self._layer(block, 256, counts[2], 2)
        self.layer4 = self._layer(block, 512, counts[3], 2)

    def _layer(self, block, planes, n, stride):
        down = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            down = nn.Sequential(Conv2d(self.inplanes, planes * block.expansion, 1, stride,
                                        bias=False), BatchNorm2d(planes * block.expansion))
        mods = [block(self.inplanes, planes, stride, down)]
        self.inplanes = planes * block.expansion
        mods += [block(self.inplanes, planes) for _ in range(1, n)]
        return nn.Sequential(*mods)


class Encoder(nn.Module):
    def __init__(self, layers: int, inputs: int):
        super().__init__()
        self.encoder = ResNet(layers, inputs)

    def forward(self, x) -> List[torch.Tensor]:
        e = self.encoder
        feats = [F.relu(e.bn1(e.conv1(x)))]
        feats.append(e.layer1(F.max_pool2d(feats[-1], 3, 2, 1)))
        for layer in (e.layer2, e.layer3, e.layer4):
            feats.append(layer(feats[-1]))
        return feats


def channels(layers: int) -> Tuple[int, ...]:
    return (64, 64, 128, 256, 512) if layers == 18 else (64, 256, 512, 1024, 2048)


class Conv3x3(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3)

    def forward(self, x):
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv3x3(cin, cout)

    def forward(self, x):
        return F.elu(self.conv(x))


DEC = (16, 32, 64, 128, 256)


class DepthDecoder(nn.Module):
    def __init__(self, enc: Sequence[int]):
        super().__init__()
        mods = []
        for i in range(4, -1, -1):
            mods.append(ConvBlock(enc[-1] if i == 4 else DEC[i + 1], DEC[i]))
            mods.append(ConvBlock(DEC[i] + (enc[i - 1] if i > 0 else 0), DEC[i]))
        mods += [Conv3x3(DEC[s], 1) for s in range(4)]
        self.decoder = nn.ModuleList(mods)

    def forward(self, feats, scales: int) -> List[torch.Tensor]:
        """Disparities of the ``scales`` finest scales, fine to coarse."""
        out, x = {}, feats[-1]
        for k, i in enumerate(range(4, -1, -1)):
            x = F.interpolate(self.decoder[2 * k](x), scale_factor=2, mode="nearest")
            if i > 0:
                x = torch.cat([x, feats[i - 1]], 1)
            x = self.decoder[2 * k + 1](x)
            if i < scales:
                out[i] = 10.0 * torch.sigmoid(self.decoder[10 + i](x).float()) + 0.01
        return [out[s] for s in range(scales)]


class DispNet(nn.Module):
    def __init__(self, layers: int):
        super().__init__()
        self.encoder = Encoder(layers, 1)
        self.decoder = DepthDecoder(channels(layers))

    def forward(self, x, scales: int):
        return self.decoder(self.encoder(x), scales)


class PoseNet(nn.Module):
    def __init__(self, layers: int = 18):
        super().__init__()
        self.encoder = Encoder(layers, 2)
        cin = channels(layers)[-1]
        self.decoder = nn.Module()
        self.decoder.net = nn.ModuleList([Conv2d(cin, 256, 1), Conv2d(256, 256, 3, 1, 1),
                                          Conv2d(256, 256, 3, 1, 1), Conv2d(256, 6, 1)])

    def forward(self, x):
        net = self.decoder.net
        y = self.encoder(x)[-1]
        for conv in net[:3]:
            y = F.relu(conv(y))
        return 0.01 * net[3](y).float().mean(dim=(2, 3))


def set_precision(nets, precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    for net in nets:
        for m in net.modules():
            if isinstance(m, Conv2d):
                m.precision = precision


# ---- geometry (NCHW images, [B, 1, H, W] depths) -----------------------------

def euler2mat(a: torch.Tensor) -> torch.Tensor:
    x, y, z = a[:, 0], a[:, 1], a[:, 2]
    o, i = torch.zeros_like(x), torch.ones_like(x)
    rz = torch.stack([z.cos(), -z.sin(), o, z.sin(), z.cos(), o, o, o, i], 1).view(-1, 3, 3)
    ry = torch.stack([y.cos(), o, y.sin(), o, i, o, -y.sin(), o, y.cos()], 1).view(-1, 3, 3)
    rx = torch.stack([i, o, o, o, x.cos(), -x.sin(), o, x.sin(), x.cos()], 1).view(-1, 3, 3)
    return rx @ ry @ rz


def inverse_warp2(img, depth, ref_depth, pose, k):
    """Warp the source (``img`` ``[F, 3, H, W]``, ``ref_depth``) into the
    target frame by the target ``depth`` and ``pose`` (target -> source):
    (image, valid mask, projected source depth, computed depth)."""
    f, _, h, w = img.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(w, dtype=torch.float32, device=img.device),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)]).view(1, 3, -1)
    cam = (torch.linalg.inv(k) @ pix) * depth.view(f, 1, -1)
    proj = k @ torch.cat([euler2mat(pose[:, 3:]), pose[:, :3, None]], 2)
    p = proj[:, :, :3] @ cam + proj[:, :, 3:]
    z = p[:, 2].clamp(min=1e-3)
    xn = 2.0 * (p[:, 0] / z) / (w - 1) - 1.0
    yn = 2.0 * (p[:, 1] / z) / (h - 1) - 1.0
    xn = torch.where(xn.abs() > 1, torch.full_like(xn, 2.0), xn)
    yn = torch.where(yn.abs() > 1, torch.full_like(yn, 2.0), yn)
    grid = torch.stack([xn, yn], -1).view(f, h, w, 2)
    src = torch.cat([ref_depth, img.detach()], 1)
    sampled = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=False)
    valid = (grid.abs().amax(-1) <= 1).float()[:, None]
    return sampled[:, 1:], valid, sampled[:, :1], z.view(f, 1, h, w)


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    xp, yp = F.pad(x, (1, 1, 1, 1), mode="reflect"), F.pad(y, (1, 1, 1, 1), mode="reflect")
    pool = lambda a: F.avg_pool2d(a, 3, 1)
    mx, my = pool(xp), pool(yp)
    sx, sy, sxy = pool(xp * xp) - mx * mx, pool(yp * yp) - my * my, pool(xp * yp) - mx * my
    n = (2 * mx * my + c1) * (2 * sxy + c2)
    d = (mx * mx + my * my + c1) * (sx + sy + c2)
    return ((1 - n / d) / 2).clamp(0, 1)


def _masked_mean(diff, mask, share=None):
    """The mean of ``diff`` under ``mask``; with ``share`` (``[B]`` 0/1),
    only those rows' part of it (one rank's share of the global mean)."""
    m = mask.expand_as(diff)
    total = m.sum()
    num = diff * m if share is None else diff * m * share.view(-1, 1, 1, 1)
    mean = num.sum() / total.clamp(min=1.0)
    return torch.where(total > 10000.0, mean, torch.zeros_like(mean))


def _resize_nearest(x, h, w):
    if x.shape[-2:] == (h, w):
        return x
    iy = torch.floor((torch.arange(h, device=x.device) + 0.5) * x.shape[-2] / h).long()
    ix = torch.floor((torch.arange(w, device=x.device) + 0.5) * x.shape[-1] / w).long()
    return x[..., iy, :][..., ix]


def photo_geometry(tgt, refs, k, tgt_depth, ref_depths, poses, poses_inv, cfg, share=None):
    """Both directions of every (target, reference) pair, each direction's
    masked means taken over the batch, summed over pairs and scales."""
    n = refs.shape[1]
    h, w = tgt.shape[-2:]
    photo = geom = torch.zeros((), device=tgt.device)
    for s in range(cfg["num_scales"]):
        td = _resize_nearest(tgt_depth[s], h, w)
        for g in range(2 * n):
            j = g % n
            rd = _resize_nearest(ref_depths[s][:, j], h, w)
            if g < n:
                t_img, s_img, t_d, s_d, pose = tgt, refs[:, j], td, rd, poses[:, j]
            else:
                t_img, s_img, t_d, s_d, pose = refs[:, j], tgt, rd, td, poses_inv[:, j]
            warped, valid, projected, computed = inverse_warp2(s_img, t_d, s_d, pose, k)
            diff_img = (t_img - warped).abs().clamp(0, 1)
            diff_depth = ((computed - projected).abs() / (computed + projected)).clamp(0, 1)
            if cfg["with_auto_mask"]:
                static = (t_img - s_img).abs().mean(1, keepdim=True)
                valid = (diff_img.mean(1, keepdim=True) < static).float() * valid
            if cfg["with_ssim"]:
                diff_img = 0.15 * diff_img + 0.85 * ssim(t_img, warped)
            if cfg["with_mask"]:
                diff_img = diff_img * (1 - diff_depth)
            photo = photo + _masked_mean(diff_img, valid, share)
            geom = geom + _masked_mean(diff_depth, valid, share)
    return photo, geom


def _smooth(depth, img, share=None):
    d = depth / (depth.mean(dim=(2, 3), keepdim=True) + 1e-7)
    gx = (d[..., :-1] - d[..., 1:]).abs() * torch.exp(
        -(img[..., :-1] - img[..., 1:]).abs().mean(1, keepdim=True))
    gy = (d[..., :-1, :] - d[..., 1:, :]).abs() * torch.exp(
        -(img[..., :-1, :] - img[..., 1:, :]).abs().mean(1, keepdim=True))
    if share is not None:
        gx, gy = gx * share.view(-1, 1, 1, 1), gy * share.view(-1, 1, 1, 1)
    return gx.mean() + gy.mean()


def loss(disp_net, pose_net, tgt, refs, k, cfg,
         share=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted 3-term loss of a batch: ``tgt`` ``[B, 3, H, W]``,
    ``refs`` ``[B, N, 3, H, W]``, ``k`` ``[B, 3, 3]``, normalized frames.
    ``share`` (``[B]`` 0/1) keeps only those rows' share of every mean, as
    one rank of several computes before the ranks' sum."""
    b, n = refs.shape[:2]
    frames = torch.cat([tgt[None], refs.transpose(0, 1)]).flatten(0, 1)  # frame-major
    depths = [1.0 / d for d in disp_net(frames, cfg["num_scales"])]
    tgt_depth = [d[:b] for d in depths]
    ref_depths = [d[b:].view(n, b, *d.shape[1:]).transpose(0, 1) for d in depths]
    tgt_rep = tgt[None].expand(n, *tgt.shape).flatten(0, 1)
    ref_f = refs.transpose(0, 1).flatten(0, 1)
    out = pose_net(torch.cat([torch.cat([tgt_rep, ref_f]), torch.cat([ref_f, tgt_rep])], 1))
    poses = out[:n * b].view(n, b, 6).transpose(0, 1)
    poses_inv = out[n * b:].view(n, b, 6).transpose(0, 1)
    photo, geom = photo_geometry(tgt, refs, k, tgt_depth, ref_depths, poses, poses_inv, cfg,
                                 share)
    smooth = _smooth(tgt_depth[0], tgt, share) + sum(
        _smooth(ref_depths[0][:, i], refs[:, i], share) for i in range(n))
    total = (cfg["photo_loss_weight"] * photo + cfg["smooth_loss_weight"] * smooth
             + cfg["geometry_consistency_weight"] * geom)
    return total, {"photo": photo, "smooth": smooth, "geometry": geom}


class Adam:
    """torch's Adam (L2 weight decay coupled), step by step."""

    def __init__(self, params, lr, betas, eps=1e-8, weight_decay=0.0):
        self.params, self.lr, self.betas, self.eps, self.wd = params, lr, betas, eps, weight_decay
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = [0] * len(params)

    @torch.no_grad()
    def load(self, m, v, t) -> None:
        """Each leaf's first and second moments and step count."""
        for i, p in enumerate(self.params):
            self.m[i].copy_(m[i].to(p.device))
            self.v[i].copy_(v[i].to(p.device))
        self.t = [int(s) for s in t]

    @torch.no_grad()
    def step(self) -> None:
        b1, b2 = self.betas
        for i, p in enumerate(self.params):
            if p.grad is None:
                continue
            g = p.grad if not self.wd else p.grad + self.wd * p
            self.t[i] += 1
            self.m[i].mul_(b1).add_(g, alpha=1 - b1)
            self.v[i].mul_(b2).addcmul_(g, g, value=1 - b2)
            c1, c2 = 1 - b1 ** self.t[i], 1 - b2 ** self.t[i]
            denom = (self.v[i].sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(self.m[i], denom, value=-self.lr / c1)


class Step:
    """The reference's train step at ``precision`` (TF32 off): DispNet and
    PoseNet, seeded by ``weights.init_weights`` where ``seed`` is given,
    their leaves by name (``named``: ``disp.<param>``, ``pose.<param>``),
    Adam over them (``optimizer``) and one batch's loss (``loss``)."""

    def __init__(self, cfg: dict, device, precision: str, seed: int = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.disp = DispNet(cfg["resnet_layers"]).to(device)
        self.pose = PoseNet(cfg["pose_layers"]).to(device)
        set_precision((self.disp, self.pose), precision)
        if seed is not None:
            init_weights({"disp": self.disp, "pose": self.pose}, seed, device)
        self.named = [(f"disp.{n}", p) for n, p in self.disp.named_parameters()] + \
            [(f"pose.{n}", p) for n, p in self.pose.named_parameters()]
        self.optimizer = Adam([p for _, p in self.named], cfg["lr"],
                              (cfg["momentum"], cfg["beta"]), weight_decay=cfg["weight_decay"])

    def loss(self, batch, share=None) -> torch.Tensor:
        """The total loss of ``batch`` (tgt, refs, k; ``loss``'s shapes);
        ``share`` as ``loss``'s."""
        tgt, refs, k = batch
        return loss(self.disp, self.pose, tgt, refs, k, self.cfg, share)[0]
