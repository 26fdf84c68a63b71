"""Train state: both networks, the optimizer, the step and a generator.

The counterpart of the JAX package's ``training/state.py``. The JAX state
is one pytree of parameters, BatchNorm statistics and optimizer state; here
the networks hold their parameters and running statistics as modules do,
and the optimizer holds its moments.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.nn as nn


def optimizer_step(optimizer: torch.optim.Optimizer) -> int:
    """Optimizer steps taken: Adam's own count (0 before the first)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                return int(state["step"])
    return 0


@dataclasses.dataclass
class TrainState:
    disp_net: nn.Module
    pose_net: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator

    @property
    def step(self) -> int:
        """Optimizer steps taken: Adam's own count (0 before the first)."""
        return optimizer_step(self.optimizer)

    def state_dict(self) -> dict:
        """Everything an exact resume needs: both networks (parameters and
        BatchNorm buffers), the optimizer, the generator and the step."""
        return {"disp": self.disp_net.state_dict(), "pose": self.pose_net.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state(), "step": self.step}

    def load_state_dict(self, blob: dict) -> None:
        """Inverse of :meth:`state_dict`, in place (tensors go to the
        devices of the networks they load into)."""
        self.disp_net.load_state_dict(blob["disp"])
        self.pose_net.load_state_dict(blob["pose"])
        self.optimizer.load_state_dict(blob["optimizer"])
        self.generator.set_state(blob["generator"])
        if self.step != blob["step"]:
            raise ValueError(f"restored optimizer is at step {self.step}, "
                             f"the checkpoint at {blob['step']}")


def make_optimizer(
    disp_net: nn.Module, pose_net: nn.Module, lr: float = 1e-4, beta1: float = 0.9,
    beta2: float = 0.999, weight_decay: float = 0.0,
) -> torch.optim.Adam:
    """One Adam over both networks' parameters with one learning rate.

    ``weight_decay`` is L2 added to the gradient before the Adam scaling
    (torch's coupled form), which is ``optax.add_decayed_weights`` before
    ``optax.adam`` in the JAX package; eps 1e-8 as optax's.
    """
    params = itertools.chain(disp_net.parameters(), pose_net.parameters())
    return torch.optim.Adam(params, lr=lr, betas=(beta1, beta2), eps=1e-8,
                            weight_decay=weight_decay)


def create_train_state(
    disp_net: nn.Module, pose_net: nn.Module, optimizer: torch.optim.Optimizer = None,
    seed: int = 0,
) -> TrainState:
    """Bundle both networks with ``optimizer`` (:func:`make_optimizer`'s
    defaults if ``None``) and a ``torch.Generator`` seeded with ``seed``."""
    if optimizer is None:
        optimizer = make_optimizer(disp_net, pose_net)
    return TrainState(disp_net, pose_net, optimizer, torch.Generator().manual_seed(seed))
