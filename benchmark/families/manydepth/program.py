"""The ``manydepth`` family's system under test: ManyDepth's train step as
the port's train CLI composes it (``train.py --arch manydepth``): the three
networks seeded by ``weights.init_weights``, a capturable Adam over them,
the device augmentation with the resize and the step's matching draws, and
``make_manydepth_train_step(fused_steps=K)`` (on the card, K steps a
CUDA-graph replay).
"""

from __future__ import annotations

from typing import Dict

import torch


def build(cfg: dict, traffic: dict, seed: int, device) -> Dict:
    """``{"named": [(leaf, tensor)], "optimizer", "step"}``: the networks'
    leaves (``mono.<param>``, ``multi.<param>``, ``pose.<param>``, as the
    reference names them), then the state without gradient that a replay's
    reference needs: ``draws.seed`` (the seed the step's draws come from)
    and ``depth_bins.trackers`` (the program's own trackers)."""
    from sc_sfmlearner_release_tpu_torch.data.device_augment import (AugmentConfig,
                                                                     make_device_augment)
    from sc_sfmlearner_release_tpu_torch.models.manydepth import ManyDepth
    from sc_sfmlearner_release_tpu_torch.training.manydepth import (
        ManyDepthConfig, MatchingAugment, make_manydepth_optimizer, make_manydepth_train_step)

    from benchmark.weights import init_weights

    if not traffic["device_augment"]:
        raise ValueError("the manydepth family augments on the card (device_augment true)")
    k = cfg["fused_steps"]
    model = ManyDepth(cfg["num_layers"], cfg["num_depth_bins"]).to(device)
    nets = {"mono": model.mono, "multi": model.multi, "pose": model.pose}
    init_weights(nets, seed, device)
    optimizer = make_manydepth_optimizer(model, cfg["learning_rate"],
                                         capturable=k > 1 and device.type == "cuda")
    step_cfg = ManyDepthConfig(
        height=cfg["height"], width=cfg["width"], num_scales=len(cfg["scales"]),
        min_depth=cfg["min_depth"], max_depth=cfg["max_depth"],
        num_depth_bins=cfg["num_depth_bins"], disparity_smoothness=cfg["disparity_smoothness"],
        tracker_start=tuple(cfg["tracker_start"]))
    augment = MatchingAugment(make_device_augment(AugmentConfig()), cfg["height"], cfg["width"])
    step = make_manydepth_train_step(model, optimizer, step_cfg, device=device,
                                     precision=cfg["precision"], augment_fn=augment,
                                     aug_seed=seed, fused_steps=k)
    named = [(f"{name}.{n}", p) for name, net in nets.items() for n, p in net.named_parameters()]
    named += [("draws.seed", torch.tensor(float(seed), dtype=torch.float64, device=device)),
              ("depth_bins.trackers", step.trackers)]
    return {"named": named, "optimizer": optimizer, "step": step}
