"""FLOPs of one ``manydepth`` optimizer step, counted on the reference's
networks.

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions on
``meta`` tensors, so any machine can count. Each distinct computation
counts once: forward and backward (x3) where gradients flow (the teacher
on frame 0, the multi-frame network's encoder and decoder on frame 0, the
pose network on its two pairs), forward alone for the lookup frame's
early features and for the cost volume's bilinear combines (8 FLOP per
channel per pixel and bin, as the warp's in ``sc_depth``), and the losses'
warps of 3 channels for 2 references, 2 paths and 4 scales at the full
size, forward and backward. BatchNorm, the losses' arithmetic, the
geometry and Adam are not counted.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import reference

BILINEAR_FLOPS_PER_CHANNEL = 8


def _count(fn) -> float:
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn()
    return float(counter.get_total_flops())


def forward_flops(cfg: dict):
    """(teacher, multi-frame network, lookup features, pose pair) of one
    sample's forward."""
    layers, bins, h, w = cfg["num_layers"], cfg["num_depth_bins"], cfg["height"], cfg["width"]
    mono = reference.DepthNet(layers).to("meta")
    multi = reference.MatchingNet(layers, bins).to("meta")
    pose = reference.PoseNet(18).to("meta")
    x = torch.empty((1, 3, h, w), device="meta")

    def multi_forward():
        feats = multi.extract(x)
        volume = torch.empty((1, bins) + feats[1].shape[2:], device="meta")
        y = multi.reduce_conv(torch.cat([feats[1], volume], 1))
        e = multi.encoder.encoder
        for layer in (e.layer2, e.layer3, e.layer4):
            y = layer(y)
            feats.append(y)
        multi.decoder(feats)

    return (_count(lambda: mono(x)), _count(multi_forward), _count(lambda: multi.extract(x)),
            _count(lambda: pose(torch.empty((1, 6, h, w), device="meta"))))


def flops_per_step(cfg: dict) -> float:
    b, h, w, bins = cfg["batch_size"], cfg["height"], cfg["width"], cfg["num_depth_bins"]
    mono, multi, lookup, pose = forward_flops(cfg)
    refs, scales, paths = cfg["sequence_length"] - 1, len(cfg["scales"]), 2
    trained = 3.0 * b * (mono + multi + refs * pose)
    volume = b * (h // 4) * (w // 4) * bins * cfg["matching_channels"] * \
        BILINEAR_FLOPS_PER_CHANNEL
    warps = 2.0 * paths * scales * refs * b * h * w * 3 * BILINEAR_FLOPS_PER_CHANNEL
    return trained + b * lookup + volume + warps
