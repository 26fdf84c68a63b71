"""Weights across the two packages: flax variable trees <-> the port's state dicts.

The port's models use the reference checkpoints' parameter names, so a
flax tree (``{"params": ..., "batch_stats": ...}`` of numpy arrays, as the
JAX package's ``DispNet``/``PoseNet`` hold them) maps onto a state dict
mechanically:

  * conv kernels ``[kh, kw, I, O]`` <-> ``[O, I, kh, kw]``;
  * BatchNorm ``scale/bias`` (params) and ``mean/var`` (batch_stats)
    <-> ``weight/bias/running_mean/running_var``.

This is the port's own copy of the mapping in the JAX package's
``models/convert.py``; it imports nothing from that package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .resnet import BOTTLENECK, STAGE_BLOCKS

Tree = Dict[str, Any]
StateDict = Dict[str, torch.Tensor]

# The reference DepthDecoder's ModuleList order.
DISP_DECODER_ORDER = [
    f"upconv_{i}_{j}" for i in range(4, -1, -1) for j in (0, 1)
] + [f"dispconv_{s}" for s in range(4)]
POSE_DECODER_ORDER = ["squeeze", "pose_0", "pose_1", "pose_2"]
ENCODER_PREFIX = "encoder.encoder."


def _to_torch_kernel(k) -> np.ndarray:
    """flax ``[kh, kw, I, O]`` -> torch ``[O, I, kh, kw]``."""
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _to_flax_kernel(w) -> np.ndarray:
    """torch ``[O, I, kh, kw]`` -> flax ``[kh, kw, I, O]``."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def _encoder_blocks(num_layers: int):
    """(torch key prefix, flax block name) of every residual block."""
    for stage, n_blocks in enumerate(STAGE_BLOCKS[num_layers], start=1):
        for i in range(n_blocks):
            yield f"{ENCODER_PREFIX}layer{stage}.{i}", f"layer{stage}_{i}"


def _bn_from_flax(params: Mapping, stats: Mapping, tkey: str, out: Dict[str, np.ndarray]):
    out[f"{tkey}.weight"] = np.asarray(params["bn"]["scale"])
    out[f"{tkey}.bias"] = np.asarray(params["bn"]["bias"])
    out[f"{tkey}.running_mean"] = np.asarray(stats["bn"]["mean"])
    out[f"{tkey}.running_var"] = np.asarray(stats["bn"]["var"])
    out[f"{tkey}.num_batches_tracked"] = np.asarray(0, np.int64)


def _encoder_from_flax(params: Mapping, stats: Mapping, num_layers: int) -> Dict[str, np.ndarray]:
    p = ENCODER_PREFIX
    out: Dict[str, np.ndarray] = {f"{p}conv1.weight": _to_torch_kernel(params["conv1"]["kernel"])}
    _bn_from_flax(params["bn1"], stats["bn1"], f"{p}bn1", out)
    n_convs = 3 if BOTTLENECK[num_layers] else 2
    for tb, fb in _encoder_blocks(num_layers):
        for j in range(1, n_convs + 1):
            out[f"{tb}.conv{j}.weight"] = _to_torch_kernel(params[fb][f"conv{j}"]["kernel"])
            _bn_from_flax(params[fb][f"bn{j}"], stats[fb][f"bn{j}"], f"{tb}.bn{j}", out)
        if "downsample_conv" in params[fb]:
            out[f"{tb}.downsample.0.weight"] = _to_torch_kernel(
                params[fb]["downsample_conv"]["kernel"])
            _bn_from_flax(params[fb]["downsample_bn"], stats[fb]["downsample_bn"],
                          f"{tb}.downsample.1", out)
    return out


def _tensors(sd: Mapping[str, np.ndarray]) -> StateDict:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def disp_from_jax(variables: Mapping, num_layers: int) -> StateDict:
    """JAX ``DispNet`` variables -> the port's ``DispNet`` state dict."""
    out = _encoder_from_flax(variables["params"]["encoder"],
                             variables["batch_stats"]["encoder"], num_layers)
    dec = variables["params"]["decoder"]
    for idx, name in enumerate(DISP_DECODER_ORDER):
        t = f"decoder.decoder.{idx}.conv.conv" if name.startswith("upconv") \
            else f"decoder.decoder.{idx}.conv"
        out[f"{t}.weight"] = _to_torch_kernel(dec[name]["conv"]["kernel"])
        out[f"{t}.bias"] = np.asarray(dec[name]["conv"]["bias"])
    return _tensors(out)


def pose_from_jax(variables: Mapping, num_layers: int = 18) -> StateDict:
    """JAX ``PoseNet`` variables -> the port's ``PoseNet`` state dict."""
    out = _encoder_from_flax(variables["params"]["encoder"],
                             variables["batch_stats"]["encoder"], num_layers)
    dec = variables["params"]["decoder"]
    for idx, name in enumerate(POSE_DECODER_ORDER):
        out[f"decoder.net.{idx}.weight"] = _to_torch_kernel(dec[name]["kernel"])
        out[f"decoder.net.{idx}.bias"] = np.asarray(dec[name]["bias"])
    return _tensors(out)


def from_jax_variables(
    disp_vars: Mapping, pose_vars: Mapping, num_layers: int
) -> Tuple[StateDict, StateDict]:
    """Flax variable trees of the JAX ``DispNet`` (``num_layers``) and
    ``PoseNet`` (ResNet-18, as the JAX trainer builds it) -> the port's
    ``(disp_state_dict, pose_state_dict)``."""
    return disp_from_jax(disp_vars, num_layers), pose_from_jax(pose_vars, 18)


def _set(tree: Tree, path: Tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value)


def _numpy(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in sd.items()}


def _bn_to_flax(sd, tkey: str, params: Tree, stats: Tree, fpath: Tuple[str, ...]) -> None:
    _set(params, fpath + ("bn", "scale"), sd[f"{tkey}.weight"])
    _set(params, fpath + ("bn", "bias"), sd[f"{tkey}.bias"])
    _set(stats, fpath + ("bn", "mean"), sd[f"{tkey}.running_mean"])
    _set(stats, fpath + ("bn", "var"), sd[f"{tkey}.running_var"])


def _encoder_to_flax(sd, num_layers: int) -> Tuple[Tree, Tree]:
    p = ENCODER_PREFIX
    params: Tree = {}
    stats: Tree = {}
    _set(params, ("conv1", "kernel"), _to_flax_kernel(sd[f"{p}conv1.weight"]))
    _bn_to_flax(sd, f"{p}bn1", params, stats, ("bn1",))
    n_convs = 3 if BOTTLENECK[num_layers] else 2
    for tb, fb in _encoder_blocks(num_layers):
        for j in range(1, n_convs + 1):
            _set(params, (fb, f"conv{j}", "kernel"), _to_flax_kernel(sd[f"{tb}.conv{j}.weight"]))
            _bn_to_flax(sd, f"{tb}.bn{j}", params, stats, (fb, f"bn{j}"))
        if f"{tb}.downsample.0.weight" in sd:
            _set(params, (fb, "downsample_conv", "kernel"),
                 _to_flax_kernel(sd[f"{tb}.downsample.0.weight"]))
            _bn_to_flax(sd, f"{tb}.downsample.1", params, stats, (fb, "downsample_bn"))
    return params, stats


def disp_to_jax(state_dict: Mapping, num_layers: int) -> Tree:
    """The port's ``DispNet`` state dict -> JAX ``DispNet`` variables."""
    sd = _numpy(state_dict)
    enc_params, enc_stats = _encoder_to_flax(sd, num_layers)
    dec: Tree = {}
    for idx, name in enumerate(DISP_DECODER_ORDER):
        t = f"decoder.decoder.{idx}.conv.conv" if name.startswith("upconv") \
            else f"decoder.decoder.{idx}.conv"
        _set(dec, (name, "conv", "kernel"), _to_flax_kernel(sd[f"{t}.weight"]))
        _set(dec, (name, "conv", "bias"), sd[f"{t}.bias"])
    return {"params": {"encoder": enc_params, "decoder": dec},
            "batch_stats": {"encoder": enc_stats}}


def pose_to_jax(state_dict: Mapping, num_layers: int = 18) -> Tree:
    """The port's ``PoseNet`` state dict -> JAX ``PoseNet`` variables."""
    sd = _numpy(state_dict)
    enc_params, enc_stats = _encoder_to_flax(sd, num_layers)
    dec: Tree = {}
    for idx, name in enumerate(POSE_DECODER_ORDER):
        _set(dec, (name, "kernel"), _to_flax_kernel(sd[f"decoder.net.{idx}.weight"]))
        _set(dec, (name, "bias"), sd[f"decoder.net.{idx}.bias"])
    return {"params": {"encoder": enc_params, "decoder": dec},
            "batch_stats": {"encoder": enc_stats}}


def to_jax_variables(
    disp_state_dict: Mapping, pose_state_dict: Mapping, num_layers: int
) -> Tuple[Tree, Tree]:
    """Inverse of :func:`from_jax_variables`: ``(disp_vars, pose_vars)``."""
    return disp_to_jax(disp_state_dict, num_layers), pose_to_jax(pose_state_dict, 18)
