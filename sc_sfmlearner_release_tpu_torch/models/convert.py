"""Weights across the two packages: flax variable trees <-> the port's state dicts.

The port's models use the reference checkpoints' parameter names, so a
flax tree (``{"params": ..., "batch_stats": ...}`` of numpy arrays, as the
JAX package's ``DispNet``/``PoseNet`` hold them) maps onto a state dict
mechanically:

  * conv kernels ``[kh, kw, I, O]`` <-> ``[O, I, kh, kw]``;
  * BatchNorm ``scale/bias`` (params) and ``mean/var`` (batch_stats)
    <-> ``weight/bias/running_mean/running_var``.

A tree without ``batch_stats`` (Adam's ``mu``/``nu`` have the params'
structure) maps to and from a state dict of the parameters alone.
:func:`read_jax_variables`/:func:`write_jax_variables` read and write the
JAX package's ``.msgpack`` files through the port's own codec
(``utils/msgpack.py``).

This is the port's own copy of the mapping in the JAX package's
``models/convert.py``; it imports nothing from that package. Reference
checkpoints (``{'epoch', 'state_dict'}`` ``.pth.tar``) load straight into
the port's networks (:func:`load_torch_state_dict`), and torchvision's
ImageNet ResNets into their encoders (:func:`graft_imagenet_encoder`).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..utils import msgpack
from .resnet import BOTTLENECK, STAGE_BLOCKS

Tree = Dict[str, Any]
StateDict = Dict[str, torch.Tensor]

# The reference DepthDecoder's ModuleList order.
DISP_DECODER_ORDER = [
    f"upconv_{i}_{j}" for i in range(4, -1, -1) for j in (0, 1)
] + [f"dispconv_{s}" for s in range(4)]
POSE_DECODER_ORDER = ["squeeze", "pose_0", "pose_1", "pose_2"]
ENCODER_PREFIX = "encoder.encoder."


def _permuted(a, dims) -> torch.Tensor:
    """``a`` transposed to ``dims``, a new contiguous tensor: torch's copy,
    several times numpy's for these 4-D transposes."""
    a = np.asarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).permute(*dims).contiguous()


def _to_torch_kernel(k) -> torch.Tensor:
    """flax ``[kh, kw, I, O]`` -> torch ``[O, I, kh, kw]``."""
    return _permuted(k, (3, 2, 0, 1))


def _to_flax_kernel(w) -> np.ndarray:
    """torch ``[O, I, kh, kw]`` -> flax ``[kh, kw, I, O]``."""
    return _permuted(w, (2, 3, 1, 0)).numpy()


def _encoder_blocks(num_layers: int):
    """(torch key prefix, flax block name) of every residual block."""
    for stage, n_blocks in enumerate(STAGE_BLOCKS[num_layers], start=1):
        for i in range(n_blocks):
            yield f"{ENCODER_PREFIX}layer{stage}.{i}", f"layer{stage}_{i}"


def _bn_from_flax(params: Mapping, stats: Optional[Mapping], tkey: str,
                  out: Dict[str, np.ndarray]):
    out[f"{tkey}.weight"] = np.asarray(params["bn"]["scale"])
    out[f"{tkey}.bias"] = np.asarray(params["bn"]["bias"])
    if stats is None:
        return
    out[f"{tkey}.running_mean"] = np.asarray(stats["bn"]["mean"])
    out[f"{tkey}.running_var"] = np.asarray(stats["bn"]["var"])
    out[f"{tkey}.num_batches_tracked"] = np.asarray(0, np.int64)


def _encoder_from_flax(params: Mapping, stats: Optional[Mapping],
                       num_layers: int) -> Dict[str, Any]:
    p = ENCODER_PREFIX

    def sub(*path):  # the statistics' node, None without statistics
        node = stats
        for k in path:
            node = None if node is None else node[k]
        return node

    out: Dict[str, Any] = {f"{p}conv1.weight": _to_torch_kernel(params["conv1"]["kernel"])}
    _bn_from_flax(params["bn1"], sub("bn1"), f"{p}bn1", out)
    n_convs = 3 if BOTTLENECK[num_layers] else 2
    for tb, fb in _encoder_blocks(num_layers):
        for j in range(1, n_convs + 1):
            out[f"{tb}.conv{j}.weight"] = _to_torch_kernel(params[fb][f"conv{j}"]["kernel"])
            _bn_from_flax(params[fb][f"bn{j}"], sub(fb, f"bn{j}"), f"{tb}.bn{j}", out)
        if "downsample_conv" in params[fb]:
            out[f"{tb}.downsample.0.weight"] = _to_torch_kernel(
                params[fb]["downsample_conv"]["kernel"])
            _bn_from_flax(params[fb]["downsample_bn"], sub(fb, "downsample_bn"),
                          f"{tb}.downsample.1", out)
    return out


def _tensors(sd: Mapping[str, Any]) -> StateDict:
    """Tensors of their own: the transposed kernels are new tensors
    already; arrays (views into a file's buffer, say) are copied."""
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
            for k, v in sd.items()}


def _stats(variables: Mapping) -> Optional[Mapping]:
    return variables["batch_stats"]["encoder"] if "batch_stats" in variables else None


def disp_from_jax(variables: Mapping, num_layers: int) -> StateDict:
    """JAX ``DispNet`` variables -> the port's ``DispNet`` state dict (its
    parameters alone when ``variables`` has no ``batch_stats``)."""
    out = _encoder_from_flax(variables["params"]["encoder"], _stats(variables), num_layers)
    dec = variables["params"]["decoder"]
    for idx, name in enumerate(DISP_DECODER_ORDER):
        t = f"decoder.decoder.{idx}.conv.conv" if name.startswith("upconv") \
            else f"decoder.decoder.{idx}.conv"
        out[f"{t}.weight"] = _to_torch_kernel(dec[name]["conv"]["kernel"])
        out[f"{t}.bias"] = np.asarray(dec[name]["conv"]["bias"])
    return _tensors(out)


def pose_from_jax(variables: Mapping, num_layers: int = 18) -> StateDict:
    """JAX ``PoseNet`` variables -> the port's ``PoseNet`` state dict (its
    parameters alone when ``variables`` has no ``batch_stats``)."""
    out = _encoder_from_flax(variables["params"]["encoder"], _stats(variables), num_layers)
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
    if f"{tkey}.running_mean" not in sd:  # parameters alone
        return
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
    """The port's ``DispNet`` state dict -> JAX ``DispNet`` variables
    (``params`` alone when the state dict holds no running statistics)."""
    sd = _numpy(state_dict)
    enc_params, enc_stats = _encoder_to_flax(sd, num_layers)
    dec: Tree = {}
    for idx, name in enumerate(DISP_DECODER_ORDER):
        t = f"decoder.decoder.{idx}.conv.conv" if name.startswith("upconv") \
            else f"decoder.decoder.{idx}.conv"
        _set(dec, (name, "conv", "kernel"), _to_flax_kernel(sd[f"{t}.weight"]))
        _set(dec, (name, "conv", "bias"), sd[f"{t}.bias"])
    return _variables(enc_params, enc_stats, dec)


def _variables(enc_params: Tree, enc_stats: Tree, dec: Tree) -> Tree:
    out = {"params": {"encoder": enc_params, "decoder": dec}}
    if enc_stats:
        out["batch_stats"] = {"encoder": enc_stats}
    return out


def pose_to_jax(state_dict: Mapping, num_layers: int = 18) -> Tree:
    """The port's ``PoseNet`` state dict -> JAX ``PoseNet`` variables
    (``params`` alone when the state dict holds no running statistics)."""
    sd = _numpy(state_dict)
    enc_params, enc_stats = _encoder_to_flax(sd, num_layers)
    dec: Tree = {}
    for idx, name in enumerate(POSE_DECODER_ORDER):
        _set(dec, (name, "kernel"), _to_flax_kernel(sd[f"decoder.net.{idx}.weight"]))
        _set(dec, (name, "bias"), sd[f"decoder.net.{idx}.bias"])
    return _variables(enc_params, enc_stats, dec)


def to_jax_variables(
    disp_state_dict: Mapping, pose_state_dict: Mapping, num_layers: int
) -> Tuple[Tree, Tree]:
    """Inverse of :func:`from_jax_variables`: ``(disp_vars, pose_vars)``."""
    return disp_to_jax(disp_state_dict, num_layers), pose_to_jax(pose_state_dict, 18)


def gradient_state_dict(module: torch.nn.Module) -> StateDict:
    """``module``'s state dict with every parameter replaced by its gradient
    (zeros where it has none), so that :func:`to_jax_variables` maps the
    gradients onto the flax ``params`` tree as it maps the weights."""
    sd = dict(module.state_dict())
    for name, p in module.named_parameters():
        sd[name] = p.grad if p.grad is not None else torch.zeros_like(p)
    return sd


def encoder_layers(net: torch.nn.Module) -> int:
    """The ResNet depth (18, 34 or 50) of a ``DispNet``'s or ``PoseNet``'s
    encoder, from its blocks."""
    enc = net.encoder.encoder
    layout = (tuple(len(getattr(enc, f"layer{i}")) for i in range(1, 5)),
              hasattr(enc.layer1[0], "conv3"))
    for n in STAGE_BLOCKS:
        if (STAGE_BLOCKS[n], BOTTLENECK[n]) == layout:
            return n
    raise ValueError(f"no ResNet has blocks and bottleneck {layout}")


def _sorted_tree(tree):
    """``tree`` with every dict's keys sorted, as a JAX ``tree_map`` leaves
    them (the JAX package's checkpoints are written after one)."""
    if isinstance(tree, Mapping):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def read_jax_variables(path: str) -> Tree:
    """A flax ``.msgpack`` file's tree (``flax.serialization.msgpack_restore``),
    its arrays numpy views into one buffer read from the file."""
    buf = np.empty(os.path.getsize(path), np.uint8)  # writable, not zero-filled
    with open(path, "rb") as f:
        if f.readinto(memoryview(buf)) != buf.size:
            raise OSError(f"{path}: short read")
    return msgpack.unpackb(buf)


def write_jax_variables(path: str, variables: Mapping) -> None:
    """Write ``variables`` (a tree of dicts and numpy arrays) as the
    JAX package's ``save_checkpoint`` writes its trees: the top level in
    the order given (a ``TrainState``'s fields, or ``params`` then
    ``batch_stats``), every dict below it sorted as a JAX ``tree_map``
    leaves it, through ``flax.serialization.to_bytes``'s encoding. JAX's
    ``from_bytes`` and ``msgpack_restore`` read it."""
    with open(path, "wb") as f:
        f.writelines(msgpack.pack_parts({k: _sorted_tree(v) for k, v in variables.items()}))


def load_torch_state_dict(path: str) -> StateDict:
    """A ``.pth``/``.pth.tar`` file's state dict on the CPU: the reference's
    ``{'epoch', 'state_dict'}`` wrapper or a bare state dict (torchvision's).
    Loads with ``weights_only=True``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def save_torch_checkpoint(state_dict: Mapping[str, Any], path: str, epoch: int = 0) -> None:
    """Write a reference-format ``{'epoch', 'state_dict'}`` ``.pth.tar``."""
    tensors = {k: (v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(v))
               for k, v in state_dict.items()}
    torch.save({"epoch": epoch, "state_dict": tensors}, path)


def graft_imagenet_encoder(
    net: torch.nn.Module, sd: Mapping[str, torch.Tensor], num_layers: int,
    num_input_images: int = 1,
) -> torch.nn.Module:
    """Load a torchvision ImageNet ResNet state dict (``conv1.weight``,
    ``layer1.0.bn1.running_mean``, ...; its ``fc`` is dropped) into the
    encoder of ``net`` (a ``DispNet`` or ``PoseNet`` of ``num_layers``), in
    place; the decoder keeps its initialisation. For ``num_input_images`` >
    1 the 3-channel ``conv1`` is tiled over the images and divided by their
    number, as the reference's multi-image encoder does (reference
    resnet_encoder.py:54-58)."""
    encoder = net.encoder.encoder
    layout = (tuple(len(getattr(encoder, f"layer{i}")) for i in range(1, 5)),
              hasattr(encoder.layer1[0], "conv3"), encoder.conv1.in_channels)
    if layout != (STAGE_BLOCKS[num_layers], BOTTLENECK[num_layers], 3 * num_input_images):
        raise ValueError(f"net's encoder (blocks, bottleneck, input channels) {layout} is "
                         f"not a ResNet-{num_layers} of {num_input_images} image(s)")
    # torchvision's published ImageNet files predate BatchNorm's
    # ``num_batches_tracked``, so only parameters and running statistics are
    # read; the counters keep their initialisation.
    own = [k for k in encoder.state_dict() if not k.endswith("num_batches_tracked")]
    weights = {k: torch.as_tensor(sd[k]) for k in own}
    if num_input_images > 1:
        weights["conv1.weight"] = (torch.cat([weights["conv1.weight"]] * num_input_images, 1)
                                   / num_input_images)
    missing, unexpected = encoder.load_state_dict(weights, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return net
