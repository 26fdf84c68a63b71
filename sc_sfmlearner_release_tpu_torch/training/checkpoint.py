"""Checkpoints: the reference's per-network files and the full train state.

The counterpart of the JAX package's ``training/checkpoint.py``. Each save
directory holds the reference's files (reference utils.py:57-66), each a
``{'epoch', 'state_dict'}`` dict in the reference's layout, since the
port's state dicts use the reference's parameter names:

  dispnet_checkpoint.pth.tar    DispNet weights and BatchNorm buffers
  exp_pose_checkpoint.pth.tar   PoseNet
  dispnet_model_best.pth.tar    copies, when ``is_best``
  exp_pose_model_best.pth.tar

With ``full_state`` also ``train_state.pth.tar`` (both networks, the Adam
state, the generator and the step: :meth:`TrainState.state_dict`), which
makes a resume exact; ``meta.json`` holds the step and the epoch. Every file
loads with ``torch.load(..., weights_only=True)``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

from .state import TrainState

DISP_PREFIX = "dispnet"
POSE_PREFIX = "exp_pose"
TRAIN_STATE = "train_state.pth.tar"


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def save_checkpoint(
    save_path: str,
    state: TrainState,
    is_best: bool,
    epoch: Optional[int] = None,
    full_state: bool = True,
) -> None:
    """Write both networks' ``.pth.tar`` files (and the best copies when
    ``is_best``); ``full_state`` also writes the train state for an exact
    resume, about 3x the bytes, so callers may thin it out."""
    os.makedirs(save_path, exist_ok=True)
    for prefix, net in ((DISP_PREFIX, state.disp_net), (POSE_PREFIX, state.pose_net)):
        path = os.path.join(save_path, f"{prefix}_checkpoint.pth.tar")
        torch.save({"epoch": epoch, "state_dict": _cpu(net.state_dict())}, path)
        if is_best:
            shutil.copyfile(path, os.path.join(save_path, f"{prefix}_model_best.pth.tar"))
    if full_state:
        torch.save(_cpu(state.state_dict()), os.path.join(save_path, TRAIN_STATE))
    with open(os.path.join(save_path, "meta.json"), "w") as f:
        json.dump({"step": state.step, "epoch": epoch}, f)


def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Load a full train state (``path``: a save directory or its
    ``train_state.pth.tar``) into ``state``, in place, and return it."""
    if os.path.isdir(path):
        path = os.path.join(path, TRAIN_STATE)
    state.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return state
