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

The JAX package's files are read and written too, through the port's own
msgpack codec (no flax, no ``msgpack`` package): :func:`save_jax_checkpoint`
writes ``dispnet_checkpoint.msgpack``, ``exp_pose_checkpoint.msgpack``
(flax ``{params, batch_stats}`` trees), their ``*_model_best`` copies and
``train_state.msgpack`` (JAX's ``TrainState``), and
:func:`restore_train_state` resumes from such a directory as from its own.

:class:`CheckpointManager` keeps versioned step directories of those files
with a retention limit: the counterpart of the JAX package's
``OrbaxCheckpointManager``, in the port's own format (no Orbax).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from ..parallel import distributed
from ..models.convert import (
    disp_from_jax, disp_to_jax, encoder_layers, pose_from_jax, pose_to_jax,
    read_jax_variables, write_jax_variables,
)
from .state import TrainState

DISP_PREFIX = "dispnet"
POSE_PREFIX = "exp_pose"
TRAIN_STATE = "train_state.pth.tar"
JAX_TRAIN_STATE = "train_state.msgpack"
ADAM_KEYS = ("count", "mu", "nu")


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
    _write_meta(save_path, state.step, epoch)


def _write_meta(save_path: str, step: int, epoch: Optional[int]) -> None:
    with open(os.path.join(save_path, "meta.json"), "w") as f:
        json.dump({"step": step, "epoch": epoch}, f)


def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Load a full train state into ``state``, in place, and return it.
    ``path`` is a save directory (its ``train_state.pth.tar``, else the JAX
    package's ``train_state.msgpack``) or either file."""
    if os.path.isdir(path):
        own = os.path.join(path, TRAIN_STATE)
        path = own if os.path.exists(own) else os.path.join(path, JAX_TRAIN_STATE)
    if path.endswith(".msgpack"):
        load_jax_train_state(read_jax_variables(path), state)
    else:
        state.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return state


def _adam_node(opt_state: dict, weight_decay: float) -> dict:
    """optax's Adam state in ``opt_state``: ``{"0": {count, mu, nu}, "1": {}}``
    for ``optax.adam``, or behind ``add_decayed_weights`` (``{"0": {}, "1":
    ...}``) when the JAX trainer had ``--weight-decay``; the chain must
    agree with the optimizer's ``weight_decay``."""
    chained = opt_state.get("0") == {} and isinstance(opt_state.get("1"), dict)
    node = (opt_state["1"] if chained else opt_state).get("0")
    if not isinstance(node, dict) or set(node) != set(ADAM_KEYS):
        raise ValueError(f"opt_state holds no optax Adam state: keys {sorted(opt_state)}")
    if chained != bool(weight_decay):
        raise ValueError(
            f"the JAX optimizer {'has' if chained else 'has no'} add_decayed_weights, but the "
            f"port's Adam has weight_decay {weight_decay}: give the same --weight-decay")
    return node


def load_jax_train_state(tree: dict, state: TrainState) -> None:
    """A JAX ``TrainState`` tree (``train_state.msgpack``: step, params,
    batch_stats, opt_state, rng) into ``state``, in place: the parameters
    and BatchNorm statistics into both networks, Adam's ``mu``/``nu`` into
    torch Adam's ``exp_avg``/``exp_avg_sq`` (the optimizer's parameters are
    DispNet's, then PoseNet's, as ``make_optimizer`` chains them), and
    ``count`` into every parameter's ``step`` (on the card when the
    optimizer is ``capturable``). BatchNorm's ``num_batches_tracked``,
    which flax does not keep, is set to 0.

    JAX's ``rng`` is not carried: the port draws its augmentation from
    (seed, step), not from a key in the state. The restored optimizer
    must be at the file's ``step``, as :meth:`TrainState.load_state_dict`
    requires of the port's own files."""
    nets = (("disp", state.disp_net, disp_from_jax), ("pose", state.pose_net, pose_from_jax))
    for key, net, from_jax in nets:
        variables = {"params": tree["params"][key], "batch_stats": tree["batch_stats"][key]}
        net.load_state_dict(from_jax(variables, encoder_layers(net)))
    groups = state.optimizer.param_groups
    adam = _adam_node(tree["opt_state"], groups[0]["weight_decay"])
    count = int(np.asarray(adam["count"]))
    moments = {}
    for key, net, from_jax in nets:
        mu = from_jax({"params": adam["mu"][key]}, encoder_layers(net))
        nu = from_jax({"params": adam["nu"][key]}, encoder_layers(net))
        for name, p in net.named_parameters():
            moments[id(p)] = (mu[name], nu[name])
    own = state.optimizer.state_dict()
    index = {id(p): i for i, p in enumerate(p for g in groups for p in g["params"])}
    if set(index) != set(moments):
        raise ValueError("the optimizer's parameters are not DispNet's and PoseNet's")
    saved = {index[k]: {"step": torch.tensor(float(count)), "exp_avg": m, "exp_avg_sq": v}
             for k, (m, v) in moments.items()} if count else {}
    state.optimizer.load_state_dict({"state": saved, "param_groups": own["param_groups"]})
    step = int(np.asarray(tree["step"]))
    if state.step != step:
        raise ValueError(f"restored optimizer is at step {state.step}, the checkpoint at {step}")


def jax_train_state(state: TrainState) -> Dict:
    """``state`` as the JAX package's ``TrainState`` tree, the one its
    ``save_checkpoint`` writes: ``step`` (int32), ``params`` and
    ``batch_stats`` of both networks, ``opt_state`` (optax's Adam state,
    behind ``add_decayed_weights`` when the optimizer has a weight decay;
    zeros before the first step) and ``rng``: ``jax.random.PRNGKey`` of the
    state generator's seed, which no JAX draw continues from."""
    step = state.step
    params, stats, mu, nu = {}, {}, {}, {}
    exp = state.optimizer.state
    for key, net, to_jax in (("disp", state.disp_net, disp_to_jax),
                             ("pose", state.pose_net, pose_to_jax)):
        variables = to_jax(net.state_dict(), encoder_layers(net))
        params[key], stats[key] = variables["params"], variables["batch_stats"]
        named = list(net.named_parameters())
        for out, moment in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            sd = {n: exp[p][moment] if p in exp else torch.zeros_like(p) for n, p in named}
            out[key] = to_jax(sd, encoder_layers(net))["params"]
    adam = {"count": np.asarray(step, np.int32), "mu": mu, "nu": nu}
    opt_state = {"0": adam, "1": {}}
    if state.optimizer.param_groups[0]["weight_decay"]:
        opt_state = {"0": {}, "1": opt_state}
    seed = state.generator.initial_seed() & 0xFFFFFFFF
    return {"step": np.asarray(step, np.int32), "params": params, "batch_stats": stats,
            "opt_state": opt_state, "rng": np.asarray([0, seed], np.uint32)}


def save_jax_checkpoint(
    save_path: str,
    state: TrainState,
    is_best: bool,
    epoch: Optional[int] = None,
    full_state: bool = True,
) -> None:
    """The JAX package's ``save_checkpoint``: both networks'
    ``{params, batch_stats}`` ``.msgpack`` files (and the best copies when
    ``is_best``); ``full_state`` also writes ``train_state.msgpack``
    (:func:`jax_train_state`); ``meta.json`` holds the step and the epoch.
    The JAX package's ``restore_train_state`` and ``load_model_variables``
    read them."""
    os.makedirs(save_path, exist_ok=True)
    for prefix, net, to_jax in ((DISP_PREFIX, state.disp_net, disp_to_jax),
                                (POSE_PREFIX, state.pose_net, pose_to_jax)):
        path = os.path.join(save_path, f"{prefix}_checkpoint.msgpack")
        write_jax_variables(path, to_jax(net.state_dict(), encoder_layers(net)))
        if is_best:
            shutil.copyfile(path, os.path.join(save_path, f"{prefix}_model_best.msgpack"))
    if full_state:
        write_jax_variables(os.path.join(save_path, JAX_TRAIN_STATE), jax_train_state(state))
    _write_meta(save_path, state.step, epoch)


class CheckpointManager:
    """Versioned checkpoints: ``<directory>/<step>/`` holds
    :func:`save_checkpoint`'s files with the full train state, and only the
    newest ``max_to_keep`` steps stay (``None`` keeps all). The counterpart
    of the JAX package's ``OrbaxCheckpointManager``; the format is the
    port's own ``.pth.tar`` files, not Orbax's.

    Under a process group only process 0 writes; :meth:`save` returns on
    every process once the step is on disk, so any process may then
    :meth:`restore` it. A step is written into a scratch directory and
    renamed into place, so a save cut short leaves no step behind.

    Usage::

        mgr = CheckpointManager(directory, max_to_keep=5)
        mgr.save(state.step, state)
        mgr.restore(state)           # the latest step, into state
        mgr.restore(state, step=3)
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 5):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1 or None, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if distributed.process_index() == 0:
            os.makedirs(self.directory, exist_ok=True)
        distributed.barrier()

    def all_steps(self) -> List[int]:
        """The saved steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, epoch: Optional[int] = None) -> None:
        """Write ``state`` as step ``step`` (replacing an earlier save of
        that step) and drop the oldest steps past ``max_to_keep``."""
        if distributed.process_index() == 0:
            final = os.path.join(self.directory, str(step))
            scratch = final + ".tmp"
            shutil.rmtree(scratch, ignore_errors=True)
            save_checkpoint(scratch, state, is_best=False, epoch=epoch, full_state=True)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(scratch, final)
            if self.max_to_keep is not None:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)))
        distributed.barrier()

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load step ``step`` (the latest if ``None``) into ``state``, in
        place (:func:`restore_train_state`), and return it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = os.path.join(self.directory, str(step))
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint of step {step} under {self.directory}")
        return restore_train_state(path, state)
