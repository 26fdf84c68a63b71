"""Seeded weights for both sides: the program's networks and the reference's.

Every convolution, in the order of its qualified name, takes its slice of
one normal draw made on the device by a ``torch.Generator`` seeded with the
run's seed: encoder convolutions at torchvision's ResNet scale
(``sqrt(2 / fan_out)``), the decoders' convolutions and biases at
``nn.Conv2d``'s default scale (``1 / sqrt(3 fan_in)``, the standard deviation
of its uniform draw). BatchNorm starts at weight 1, bias 0 and fresh running
statistics. Both sides name their modules alike (the reference's checkpoint
names), so the same seed gives both the same weights.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn


@torch.no_grad()
def init_weights(nets: Dict[str, nn.Module], seed: int, device) -> None:
    convs, norms = [], []
    for net_name, net in nets.items():
        for mod_name, m in net.named_modules():
            if isinstance(m, nn.Conv2d):
                convs.append((f"{net_name}.{mod_name}", m))
            elif isinstance(m, nn.BatchNorm2d):
                norms.append(m)
    convs.sort(key=lambda nm: nm[0])
    total = sum(m.weight.numel() + (m.bias.numel() if m.bias is not None else 0)
                for _, m in convs)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    offset = 0
    for name, m in convs:
        w = m.weight
        fan_in, fan_out = w[0].numel(), w.shape[0] * w[0, 0].numel()
        default = 1.0 / math.sqrt(3.0 * fan_in)
        std = math.sqrt(2.0 / fan_out) if ".encoder." in f".{name}." else default
        w.copy_(flat[offset:offset + w.numel()].view_as(w) * std)
        offset += w.numel()
        if m.bias is not None:
            m.bias.copy_(flat[offset:offset + m.bias.numel()] * default)
            offset += m.bias.numel()
    for m in norms:
        m.reset_parameters()
