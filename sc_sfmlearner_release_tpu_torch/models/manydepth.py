"""ManyDepth's networks (Watson et al., "The Temporal Opportunist", CVPR
2021): the single-frame teacher, the multi-frame depth network around the
plane-sweep cost volume, and the pose network.

* ``DepthNet`` (the teacher, ``mono``): a ResNet encoder and Monodepth2's
  decoder with plain ``sigmoid`` heads.
* ``MatchingDepthNet`` (``multi``): ManyDepth's ``ResnetEncoderMatching``
  and a decoder. The encoder's ``conv1``/``bn1`` and ``maxpool``/``layer1``
  run on the current frame (with gradients) and on the lookup frame
  (without, a BatchNorm batch of its own); the cost volume of their
  quarter-resolution features (``ops/cost_volume.py``) over the depth bins,
  masked by its confidence, joins the current features in ``reduce_conv``
  (3x3, 64 + D -> 64, ReLU), and ``layer2``..``layer4`` follow. The skips are
  the pre-matching ``conv1`` and ``layer1`` features, as in the public code.
* ``PoseNet(frames=2)``: Monodepth2's ``PoseDecoder(num_input_features=1,
  num_frames_to_predict_for=2)``, of whose 12 outputs the first 6 are read.

Everything is NCHW, on normalized frames (the public encoders normalize
their [0, 1] input by the same 0.45 / 0.225). Module names put every ResNet
under ``<net>.encoder.encoder`` and ``reduce_conv`` outside it, so the
benchmark's seeded init gives the ResNets torchvision's scale and
``reduce_conv`` the default one. ManyDepth's ``prematching_conv`` is built
by the public encoder but never called in its forward; it is left out.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cost_volume import cost_volume
from ..parallel import spatial
from .disp_net import DepthDecoder
from .pose_net import PoseNet
from .resnet import ResNetEncoder, default_generator, encoder_channels, torch_default_conv_init_


def _decoder(num_layers: int, g: torch.Generator) -> DepthDecoder:
    dec = DepthDecoder(encoder_channels(num_layers), head="sigmoid")
    for m in dec.modules():
        if isinstance(m, nn.Conv2d):
            torch_default_conv_init_(m, g)
    return dec


class DepthNet(nn.Module):
    """ManyDepth's teacher: ``[B, 3, H, W]`` -> 4 sigmoid disparities
    ``[B, 1, H / 2^s, W / 2^s]``, fine to coarse."""

    def __init__(self, num_layers: int = 18, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.encoder = ResNetEncoder(num_layers, 1, generator=g)
        self.decoder = _decoder(num_layers, g)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.decoder(self.encoder(x))


class MatchingDepthNet(nn.Module):
    """ManyDepth's multi-frame depth network over ``num_bins`` depth bins."""

    def __init__(self, num_layers: int = 18, num_bins: int = 96,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.encoder = ResNetEncoder(num_layers, 1, generator=g)
        c1 = encoder_channels(num_layers)[1]
        self.reduce_conv = nn.Conv2d(c1 + num_bins, c1, 3, 1, 1)
        torch_default_conv_init_(self.reduce_conv, g)
        self.decoder = _decoder(num_layers, g)

    def _early(self, x: torch.Tensor) -> List[torch.Tensor]:
        e = self.encoder.encoder
        f0 = F.relu(e.bn1(spatial.conv2d(x, e.conv1)))
        return [f0, e.layer1(spatial.max_pool2d(f0, e.maxpool))]

    def forward(self, current: torch.Tensor, lookup: torch.Tensor, proj: torch.Tensor,
                inv_k: torch.Tensor, bins: torch.Tensor
                ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
        """``current`` and ``lookup`` ``[B, 3, H, W]``; ``proj`` ``[B, 3, 4]``
        (K at quarter resolution times the pose current -> lookup), ``inv_k``
        ``[B, 3, 3]`` its inverse, ``bins`` ``[D]``. Returns (disparities,
        ``lowest_cost [B, H/4, W/4]``, ``confidence [B, H/4, W/4]``)."""
        feats = self._early(current)
        with torch.no_grad():
            lookup_feats = self._early(lookup)[1]
            volume, lowest, confidence = cost_volume(feats[1].float(), lookup_feats.float(),
                                                     proj, inv_k, bins)
        e = self.encoder.encoder
        x = F.relu(spatial.conv2d(torch.cat([feats[1], volume], 1), self.reduce_conv))
        for layer in (e.layer2, e.layer3, e.layer4):
            x = layer(x)
            feats.append(x)
        return self.decoder(feats), lowest, confidence


class ManyDepth(nn.Module):
    """The three trained networks of ManyDepth's KITTI training:
    ``mono`` (:class:`DepthNet`), ``multi`` (:class:`MatchingDepthNet`) and
    ``pose`` (``PoseNet(frames=2)``), one Adam over all of them."""

    def __init__(self, num_layers: int = 18, num_bins: int = 96,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.mono = DepthNet(num_layers, g)
        self.multi = MatchingDepthNet(num_layers, num_bins, g)
        self.pose = PoseNet(18, g, frames=2)
