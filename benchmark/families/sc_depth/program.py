"""The ``sc_depth`` family's system under test: SC-Depth's train step as the
port's train CLI composes it (``train.py``): DispNet and PoseNet seeded by
``weights.init_weights``, a capturable Adam, every rank started from rank
0's state, the device augmentation for raw uint8 frames, and
``make_train_step(fused_steps=K)`` (on the card, K steps a CUDA-graph
replay).
"""

from __future__ import annotations

from typing import Dict


def build(cfg: dict, traffic: dict, seed: int, device) -> Dict:
    """``{"named": [(leaf, parameter)], "optimizer", "step"}``: the leaves
    the check compares (``disp.<param>``, ``pose.<param>``, as the
    reference names them), the optimizer and the train step."""
    from sc_sfmlearner_release_tpu_torch.data.device_augment import (AugmentConfig,
                                                                     make_device_augment)
    from sc_sfmlearner_release_tpu_torch.models import DispNet, PoseNet
    from sc_sfmlearner_release_tpu_torch.parallel import distributed
    from sc_sfmlearner_release_tpu_torch.training import (LossConfig, make_optimizer,
                                                          make_train_step)

    from benchmark.weights import init_weights

    k = cfg["fused_steps"]
    disp = DispNet(cfg["resnet_layers"]).to(device)
    pose = PoseNet(cfg["pose_layers"]).to(device)
    init_weights({"disp": disp, "pose": pose}, seed, device)
    named = [(f"disp.{n}", p) for n, p in disp.named_parameters()] + \
        [(f"pose.{n}", p) for n, p in pose.named_parameters()]
    optimizer = make_optimizer(
        disp, pose, cfg["lr"], cfg["momentum"], cfg["beta"], cfg["weight_decay"],
        capturable=k > 1 and device.type == "cuda")
    # Every rank starts from rank 0's networks and optimizer state, as
    # the train CLI does (nothing without a process group).
    distributed.replicate(disp, pose, optimizer)
    loss_cfg = LossConfig(
        photo_weight=cfg["photo_loss_weight"], smooth_weight=cfg["smooth_loss_weight"],
        geometry_weight=cfg["geometry_consistency_weight"], num_scales=cfg["num_scales"],
        with_ssim=cfg["with_ssim"], with_mask=cfg["with_mask"],
        with_auto_mask=cfg["with_auto_mask"], padding_mode=cfg["padding_mode"])
    augment = make_device_augment(AugmentConfig()) if traffic["device_augment"] else None
    step = make_train_step(disp, pose, optimizer, loss_cfg, device=device,
                           precision=cfg["precision"], augment_fn=augment, aug_seed=seed,
                           fused_steps=k)
    return {"named": named, "optimizer": optimizer, "step": step}
