"""FLOPs of one ``sc_depth`` optimizer step, counted on the reference's networks.

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions of one
DispNet frame (all four scales' heads, as the program computes them) and one
PoseNet pair on ``meta`` tensors, so any machine can count; a step is the
forward and the backward (x3) over the snippet's 1+N frames and 2N pairs,
plus 8 FLOP for each of the 5 channels the bilinear warp combines per
pixel of each pair. BatchNorm, the losses and Adam are not counted.
``benchmark/flops.py`` prints it for a configuration file.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import reference

WARP_FLOPS_PER_PX = 8 * 5


def forward_flops(layers: int, pose_layers: int, h: int, w: int):
    out = []
    for net, inputs in ((reference.DispNet(layers), 1), (reference.PoseNet(pose_layers), 2)):
        net = net.to("meta")
        x = torch.empty((1, 3 * inputs, h, w), device="meta")
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            net(x, 4) if inputs == 1 else net(x)
        out.append(float(counter.get_total_flops()))
    return out


def flops_per_step(cfg: dict) -> float:
    b, n, h, w = cfg["batch_size"], cfg["sequence_length"] - 1, cfg["height"], cfg["width"]
    disp, pose = forward_flops(cfg["resnet_layers"], cfg["pose_layers"], h, w)
    frames, pairs = (1 + n) * b, 2 * n * b
    return 3.0 * (disp * frames + pose * pairs) + 2.0 * pairs * h * w * WARP_FLOPS_PER_PX

