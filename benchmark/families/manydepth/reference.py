"""The plain PyTorch reference of the ``manydepth`` family's training cells.

ManyDepth's train step (Watson et al., "The Temporal Opportunist", CVPR
2021; github.com/nianticlabs/manydepth, ``trainer.py``,
``networks/resnet_encoder.py``, ``layers.py`` with the defaults of
``options.py``) written out in plain ``torch`` ops, independent of the
port: the teacher (ResNet-18 encoder, Monodepth2's depth decoder with
sigmoid heads), the pose network (a two-image ResNet-18 and Monodepth2's
``PoseDecoder(1, 2)``, axis-angle poses), the matching encoder with its
cost volume built as the public code builds it (a loop over the samples,
each sample's lookup features repeated over the 96 bins and sampled by
``F.grid_sample``), the per-sample matching augmentation, the four-scale
minimum reprojection with auto-masking (``Backproject``/``Project3D``
through ``torch.matmul``, ``F.grid_sample`` with border padding), the
consistency loss, the smoothness, Adam, and the adaptive depth-bin
trackers. The equations were written from the paper and the public code
without a copy of it at hand.

The ResNet, the decoder blocks, the convolution at a precision, SSIM and
Adam are the ``sc_depth`` family's reference's (the same Monodepth2
building blocks); precisions as there: ``"fp32"`` (TF32 off), ``"bf16"``
convolutions (the configuration's), ``"fp8"`` the control.

The step's draws are redrawn from the seed and the step: the step's CPU
generator (``SeedSequence([seed, step])``, as ``follow.step_draws``) gives
the augmentation's draws, then one U[0, 1) per sample for the matching
augmentation and two integers below 2^24, the key of the tie-breaking
noise, which a counter-based hash turns into 1e-5 N(0, 1) per pixel
(``tie_noise``). The seed and the trackers are leaves of ``named``
(``draws.seed``, ``depth_bins.trackers``) without gradient, so a replay's
state carries them; the step is Adam's count. Imports neither JAX nor
anything of the port.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark import spec
from benchmark.weights import init_weights

sc = spec.family("sc_depth", "reference")

MEAN, STD = 0.45, 0.225
KEY_BITS = 24
_M32 = 0xFFFFFFFF


# ---- networks ----------------------------------------------------------------

class DepthDecoder(sc.DepthDecoder):
    """Monodepth2's decoder with its plain sigmoid heads, all four scales."""

    def forward(self, feats, scales: int = 4) -> List[torch.Tensor]:
        out, x = {}, feats[-1]
        for k, i in enumerate(range(4, -1, -1)):
            x = F.interpolate(self.decoder[2 * k](x), scale_factor=2, mode="nearest")
            if i > 0:
                x = torch.cat([x, feats[i - 1]], 1)
            x = self.decoder[2 * k + 1](x)
            if i < scales:
                out[i] = torch.sigmoid(self.decoder[10 + i](x).float())
        return [out[s] for s in range(scales)]


class DepthNet(nn.Module):
    def __init__(self, layers: int):
        super().__init__()
        self.encoder = sc.Encoder(layers, 1)
        self.decoder = DepthDecoder(sc.channels(layers))

    def forward(self, x):
        return self.decoder(self.encoder(x))


class PoseNet(nn.Module):
    """``ResnetEncoder(18, num_input_images=2)`` and ``PoseDecoder(num_ch_enc,
    num_input_features=1, num_frames_to_predict_for=2)``."""

    def __init__(self, layers: int = 18, frames: int = 2):
        super().__init__()
        self.frames = frames
        self.encoder = sc.Encoder(layers, 2)
        cin = sc.channels(layers)[-1]
        self.decoder = nn.Module()
        self.decoder.net = nn.ModuleList([sc.Conv2d(cin, 256, 1), sc.Conv2d(256, 256, 3, 1, 1),
                                          sc.Conv2d(256, 256, 3, 1, 1),
                                          sc.Conv2d(256, 6 * frames, 1)])

    def forward(self, x):
        net = self.decoder.net
        out = F.relu(net[0](self.encoder(x)[-1]))
        out = F.relu(net[1](out))
        out = F.relu(net[2](out))
        out = net[3](out).float().mean(3).mean(2)
        out = 0.01 * out.view(-1, self.frames, 1, 6)
        return out[..., :3], out[..., 3:]


class MatchingNet(nn.Module):
    """``ResnetEncoderMatching`` (its ``prematching_conv`` is never called
    in the public forward and is left out) and a depth decoder."""

    def __init__(self, layers: int, bins: int):
        super().__init__()
        self.encoder = sc.Encoder(layers, 1)
        c1 = sc.channels(layers)[1]
        self.reduce_conv = sc.Conv2d(c1 + bins, c1, 3, 1, 1)
        self.decoder = DepthDecoder(sc.channels(layers))

    def extract(self, x) -> List[torch.Tensor]:
        e = self.encoder.encoder
        f0 = F.relu(e.bn1(e.conv1(x)))
        return [f0, e.layer1(F.max_pool2d(f0, 3, 2, 1))]


# ---- geometry (Monodepth2's layers.py) ----------------------------------------

def disp_to_depth(disp, min_depth, max_depth):
    min_disp = 1 / max_depth
    max_disp = 1 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1 / scaled_disp


def rot_from_axisangle(vec):
    angle = torch.norm(vec, 2, 2, True)
    axis = vec / (angle + 1e-7)
    ca, sa = torch.cos(angle), torch.sin(angle)
    C = 1 - ca
    x, y, z = axis[..., 0].unsqueeze(1), axis[..., 1].unsqueeze(1), axis[..., 2].unsqueeze(1)
    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC
    rot = torch.zeros((vec.shape[0], 4, 4), device=vec.device)
    rot[:, 0, 0] = torch.squeeze(x * xC + ca)
    rot[:, 0, 1] = torch.squeeze(xyC - zs)
    rot[:, 0, 2] = torch.squeeze(zxC + ys)
    rot[:, 1, 0] = torch.squeeze(xyC + zs)
    rot[:, 1, 1] = torch.squeeze(y * yC + ca)
    rot[:, 1, 2] = torch.squeeze(yzC - xs)
    rot[:, 2, 0] = torch.squeeze(zxC - ys)
    rot[:, 2, 1] = torch.squeeze(yzC + xs)
    rot[:, 2, 2] = torch.squeeze(z * zC + ca)
    rot[:, 3, 3] = 1
    return rot


def get_translation_matrix(t):
    T = torch.zeros(t.shape[0], 4, 4, device=t.device)
    t = t.contiguous().view(-1, 3, 1)
    T[:, 0, 0] = 1
    T[:, 1, 1] = 1
    T[:, 2, 2] = 1
    T[:, 3, 3] = 1
    T[:, :3, 3, None] = t
    return T


def transformation_from_parameters(axisangle, translation, invert=False):
    R = rot_from_axisangle(axisangle)
    t = translation.clone()
    if invert:
        R = R.transpose(1, 2)
        t = t * -1
    T = get_translation_matrix(t)
    return torch.matmul(R, T) if invert else torch.matmul(T, R)


def backproject(depth, inv_k, h, w):
    b = depth.shape[0]
    ys, xs = np.meshgrid(range(h), range(w), indexing="ij")
    pix = torch.from_numpy(np.stack([xs.reshape(-1), ys.reshape(-1), np.ones(h * w)])
                           .astype(np.float32)).to(depth.device)
    cam = torch.matmul(inv_k[:, :3, :3], pix[None].expand(inv_k.shape[0], 3, h * w))
    cam = depth.view(b, 1, -1) * cam
    return torch.cat([cam, torch.ones(b, 1, h * w, device=depth.device)], 1)


def project(points, k, t, h, w, eps=1e-7):
    p = torch.matmul(k, t)[:, :3, :]
    cam = torch.matmul(p, points)
    pix = cam[:, :2, :] / (cam[:, 2, :].unsqueeze(1) + eps)
    pix = pix.view(points.shape[0], 2, h, w).permute(0, 2, 3, 1)
    pix = torch.stack([pix[..., 0] / (w - 1), pix[..., 1] / (h - 1)], -1)
    return (pix - 0.5) * 2


def k4(k3, scale: float):
    """The 4x4 intrinsics of ``k3`` ``[B, 3, 3]`` at ``1 / scale`` of the size."""
    k = torch.zeros(k3.shape[0], 4, 4, device=k3.device)
    k[:, :3, :3] = k3
    k[:, :2] = k[:, :2] * scale
    k[:, 3, 3] = 1
    return k


# ---- the cost volume (ResnetEncoderMatching.match_features) ------------------

def match_features(cur, lookup, poses, k, inv_k, bins):
    """One lookup frame a sample: (cost volume, missing mask)."""
    d = bins.shape[0]
    _, _, h, w = cur.shape
    warp_depths = bins.view(d, 1, 1, 1).expand(d, 1, h, w)
    volumes, masks = [], []
    for i in range(len(cur)):
        volume = torch.zeros((d, h, w), device=cur.device)
        counts = torch.zeros((d, h, w), device=cur.device)
        world = backproject(warp_depths, inv_k[i:i + 1].expand(d, 4, 4), h, w)
        lookup_pose = poses[i:i + 1]
        if lookup_pose.sum() != 0:  # a missing lookup frame is skipped
            feat = lookup[i:i + 1].repeat([d, 1, 1, 1])
            pix = project(world, k[i:i + 1].expand(d, 4, 4), lookup_pose.expand(d, 4, 4), h, w)
            warped = F.grid_sample(feat, pix, padding_mode="zeros", mode="bilinear",
                                   align_corners=True)
            xv = (pix[..., 0].detach() / 2 + 0.5) * (w - 1)
            yv = (pix[..., 1].detach() / 2 + 0.5) * (h - 1)
            edge = ((xv >= 2.0) * (xv <= w - 2) * (yv >= 2.0) * (yv <= h - 2)).float()
            current = torch.zeros_like(edge)
            current[:, 2:-2, 2:-2] = 1.0
            edge = edge * current
            diffs = torch.abs(warped - cur[i:i + 1]).mean(1) * edge
            volume = volume + diffs
            counts = counts + (diffs > 0).float()
        volume = volume / (counts + 1e-7)
        missing = (volume == 0).float()
        volume = volume * (1 - missing) + volume.max(0)[0].unsqueeze(0) * missing
        volumes.append(volume)
        masks.append(missing)
    return torch.stack(volumes), torch.stack(masks)


# ---- the tie-breaking noise ---------------------------------------------------

def _mix32(x):
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def tie_noise(key, shape, device):
    """1e-5 N(0, 1) per element from the key's two integers: element ``i``
    hashes ``2 i`` and ``2 i + 1`` after the key; Box-Muller."""
    base = _mix32(_mix32(torch.tensor(int(key[0]), device=device)) ^ int(key[1]))
    i = torch.arange(math.prod(shape), device=device, dtype=torch.int64) * 2
    a = _mix32((i + base) & _M32)
    b = _mix32((i + 1 + base) & _M32)
    u1 = ((a >> 8).float() + 0.5) * 2.0 ** -KEY_BITS
    u2 = (b >> 8).float() * 2.0 ** -KEY_BITS
    return (torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2) * 1e-5).view(shape)


def step_draws(seed: int, step: int, batch: int):
    """The matching augmentation's U[0, 1) per sample and the noise key,
    drawn after the device augmentation's flip, scales and offsets."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    g = torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))
    torch.rand(batch, generator=g), torch.rand(batch, 2, generator=g)
    torch.rand(batch, 2, generator=g)
    u = torch.rand(batch, generator=g)
    key = torch.randint(0, 2 ** KEY_BITS, (2,), generator=g)
    return u.tolist(), key.tolist()


# ---- the step ----------------------------------------------------------------

def ssim_loss(x, y):
    return sc.ssim(x, y)


def reprojection(pred, target):
    l1 = torch.abs(target - pred).mean(1, True)
    return 0.85 * ssim_loss(pred, target).mean(1, True) + 0.15 * l1


def smooth_loss(disp, img):
    gdx = torch.abs(disp[:, :, :, :-1] - disp[:, :, :, 1:])
    gdy = torch.abs(disp[:, :, :-1, :] - disp[:, :, 1:, :])
    gix = torch.mean(torch.abs(img[:, :, :, :-1] - img[:, :, :, 1:]), 1, keepdim=True)
    giy = torch.mean(torch.abs(img[:, :, :-1, :] - img[:, :, 1:, :]), 1, keepdim=True)
    return (gdx * torch.exp(-gix)).mean() + (gdy * torch.exp(-giy)).mean()


class Step:
    """The reference's train step at ``precision`` (TF32 off): the three
    networks (``mono``, ``multi``, ``pose``), seeded by
    ``weights.init_weights`` where ``seed`` is given, their leaves by name
    with ``draws.seed`` and ``depth_bins.trackers`` (``named``), Adam over
    them (``optimizer``) and one batch's loss (``loss``)."""

    def __init__(self, cfg: dict, device, precision: str, seed: int = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.device = cfg, device
        layers, bins = cfg["num_layers"], cfg["num_depth_bins"]
        self.nets = {"mono": DepthNet(layers).to(device),
                     "multi": MatchingNet(layers, bins).to(device),
                     "pose": PoseNet(18).to(device)}
        sc.set_precision(self.nets.values(), precision)
        if seed is not None:
            init_weights(self.nets, seed, device)
        self.seed = torch.tensor(float(seed or 0), dtype=torch.float64, device=device)
        self.trackers = torch.tensor(cfg["tracker_start"], dtype=torch.float32, device=device)
        self.named = [(f"{k}.{n}", p) for k, net in self.nets.items()
                      for n, p in net.named_parameters()]
        self.named += [("draws.seed", self.seed), ("depth_bins.trackers", self.trackers)]
        self.optimizer = sc.Adam([p for _, p in self.named], cfg["learning_rate"],
                                 (0.9, 0.999))

    def loss(self, batch, share=None) -> torch.Tensor:
        """The total loss of ``batch`` (tgt ``[B, 3, H, W]``, refs ``[B, 2, 3,
        H, W]`` = frames -1, +1, k ``[B, 3, 3]``: normalized frames at the
        prepared size), after which the trackers move."""
        if share is not None:
            raise ValueError("the manydepth family trains on one card")
        total, outputs = self.forward(batch)
        self.update_adaptive_depth_bins(outputs)
        return total

    def forward(self, batch):
        cfg, dev = self.cfg, self.device
        tgt, refs, k = batch
        b = tgt.shape[0]
        h, w = cfg["height"], cfg["width"]
        h0, w0 = tgt.shape[-2:]
        frames = torch.cat([tgt[:, None], refs], 1).flatten(0, 1)
        frames = F.interpolate(frames, size=(h, w), mode="bilinear", align_corners=False)
        frames = frames.view(b, 3, 3, h, w)
        k = k.clone()
        k[:, 0] = k[:, 0] * (w / w0)
        k[:, 1] = k[:, 1] * (h / h0)
        aug = {0: frames[:, 0], -1: frames[:, 1], 1: frames[:, 2]}  # normalized 'color_aug'
        color = {f: x * STD + MEAN for f, x in aug.items()}  # [0, 1] 'color'
        K = {s: k4(k, 1.0 / 2 ** s) for s in (0, 2)}
        inv_K = {s: torch.linalg.inv(K[s]) for s in (0, 2)}
        step = max(self.optimizer.t)
        u, key = step_draws(int(self.seed), step, b)
        nets = self.nets
        for net in nets.values():
            net.train()

        # predict_poses: the matching pose without gradients, then the loss poses
        with torch.no_grad():
            axisangle, translation = nets["pose"](torch.cat([aug[-1], aug[0]], 1))
            matching_pose = transformation_from_parameters(axisangle[:, 0], translation[:, 0],
                                                           invert=True)
        outputs = {}
        for f in (-1, 1):
            pair = [aug[f], aug[0]] if f < 0 else [aug[0], aug[f]]
            axisangle, translation = nets["pose"](torch.cat(pair, 1))
            outputs[("cam_T_cam", 0, f)] = transformation_from_parameters(
                axisangle[:, 0], translation[:, 0], invert=f < 0)

        relative_poses = matching_pose[:, None].clone()
        lookup_frames = aug[-1][:, None].clone()
        mono = {}
        mono_disps = nets["mono"](aug[0])
        for s in range(4):
            mono[("disp", s)] = mono_disps[s]
        self.generate_images_pred(color, mono, K[0], inv_K[0], h, w, multi=False,
                                  poses=outputs)
        augmentation_mask = torch.zeros([b, 1, 1, 1], device=dev)
        for i in range(b):
            if u[i] < 0.25:
                lookup_frames[i] = aug[0][i][None]
                augmentation_mask[i] += 1
            elif u[i] < 0.5:
                relative_poses[i] *= 0
                augmentation_mask[i] += 1
        mono_loss = self.compute_losses(color, mono, False, key)
        for s in range(4):
            outputs[("mono_depth", 0, s)] = mono[("depth", 0, s)]
            outputs[("automask", s)] = mono[("automask", s)]

        multi = nets["multi"]
        feats = multi.extract(aug[0])
        with torch.no_grad():
            t = self.trackers
            bins = torch.from_numpy(np.linspace(float(t[0]), float(t[1]),
                                                cfg["num_depth_bins"])).float().to(dev)
            lookup = multi.extract(lookup_frames[:, 0])[1]
            volume, missing = match_features(feats[1].float(), lookup.float(),
                                             relative_poses[:, 0], K[2], inv_K[2], bins)
            confidence = ((volume * (1 - missing) > 0).sum(1) == bins.shape[0]).float()
        viz = volume.clone().detach()
        viz[viz == 0] = 100
        lowest_cost = 1 / bins[torch.min(viz, 1)[1]]
        volume = volume * confidence.unsqueeze(1)
        x = F.relu(multi.reduce_conv(torch.cat([feats[1], volume], 1)))
        e = multi.encoder.encoder
        for layer in (e.layer2, e.layer3, e.layer4):
            x = layer(x)
            feats.append(x)
        for s, d in enumerate(multi.decoder(feats)):
            outputs[("disp", s)] = d
        lowest = F.interpolate(lowest_cost.unsqueeze(1), [h, w], mode="nearest")[:, 0]
        consistency = F.interpolate(confidence.unsqueeze(1), [h, w], mode="nearest")[:, 0]
        mono0 = outputs[("mono_depth", 0, 0)]
        matching_depth = 1 / lowest.unsqueeze(1)
        mask = ((matching_depth - mono0) / mono0) < 1.0
        mask = mask * (((mono0 - matching_depth) / matching_depth) < 1.0)
        outputs["consistency_mask"] = consistency * mask[:, 0]
        outputs["augmentation_mask"] = augmentation_mask
        self.generate_images_pred(color, outputs, K[0], inv_K[0], h, w, multi=True,
                                  poses=outputs)
        multi_loss = self.compute_losses(color, outputs, True, None)
        outputs.update(confidence=confidence, lowest_cost=lowest_cost, volume=volume,
                       consistency=outputs["consistency_mask"],
                       bins=bins, mono_loss=mono_loss, multi_loss=multi_loss)
        return multi_loss + mono_loss, outputs

    def generate_images_pred(self, color, outputs, K, inv_K, h, w, multi, poses):
        cfg = self.cfg
        for s in range(4):
            disp = F.interpolate(outputs[("disp", s)], [h, w], mode="bilinear",
                                 align_corners=False)
            _, depth = disp_to_depth(disp, cfg["min_depth"], cfg["max_depth"])
            outputs[("depth", 0, s)] = depth
            for f in (-1, 1):
                T = poses[("cam_T_cam", 0, f)]
                if multi:
                    T = T.detach()
                pix = project(backproject(depth, inv_K, h, w), K, T, h, w)
                outputs[("color", f, s)] = F.grid_sample(color[f], pix, padding_mode="border",
                                                         align_corners=True)

    def compute_losses(self, color, outputs, is_multi, key):
        cfg = self.cfg
        h, w = cfg["height"], cfg["width"]
        total = 0
        target = color[0]
        if key is not None:
            noise = tie_noise(key, (4, target.shape[0], 1, h, w), target.device)
        with torch.no_grad():
            identity = torch.min(torch.cat([reprojection(color[f], target) for f in (-1, 1)],
                                           1), dim=1, keepdim=True)[0]
        for s in range(4):
            disp = outputs[("disp", s)]
            img = target if s == 0 else F.avg_pool2d(target, 2 ** s)
            losses = torch.cat([reprojection(outputs[("color", f, s)], target)
                                for f in (-1, 1)], 1)
            reproj = torch.min(losses, dim=1, keepdim=True)[0]
            if is_multi:
                mask = torch.ones_like(reproj)
                mask = mask * outputs["consistency_mask"].unsqueeze(1)
                mask = mask * (1 - outputs["augmentation_mask"])
                consistency_mask = (1 - mask).float()
            else:
                ident = identity + noise[s]
                idxs = torch.argmin(torch.cat([reproj, ident], 1), dim=1, keepdim=True)
                mask = (idxs == 0).float()
                outputs[("automask", s)] = mask
            reproj = (reproj * mask).sum() / (mask.sum() + 1e-7)
            loss = reproj
            if is_multi:
                multi_depth = outputs[("depth", 0, s)]
                mono_depth = outputs[("mono_depth", 0, s)].detach()
                loss = loss + (torch.abs(multi_depth - mono_depth) * consistency_mask).mean()
            mean_disp = disp.mean(2, True).mean(3, True)
            norm_disp = disp / (mean_disp + 1e-7)
            loss = loss + cfg["disparity_smoothness"] * smooth_loss(norm_disp, img) / (2 ** s)
            total = total + loss
        return total / 4

    @torch.no_grad()
    def update_adaptive_depth_bins(self, outputs) -> None:
        depth = outputs[("mono_depth", 0, 0)].detach()
        lo = float(depth.min(-1)[0].min(-1)[0].mean())
        hi = float(depth.max(-1)[0].max(-1)[0].mean())
        lo = max(self.cfg["min_depth"], lo * 0.9)
        hi = hi * 1.1
        t = [float(v) for v in self.trackers]
        self.trackers.copy_(torch.tensor([t[0] * 0.99 + lo * 0.01, t[1] * 0.99 + hi * 0.01]))

