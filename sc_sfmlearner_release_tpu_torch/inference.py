"""Shared inference utilities for the port's evaluation and inference CLIs.

The counterpart of the JAX package's ``inference.py``. Image loading
matches the reference CLIs' preprocessing (the reference's
test_disp.py:26-33): resize to the network resolution, normalize
``((x/255) - 0.45) / 0.225``. PNGs are decoded by ``data/image_io.py``
(numpy and ``zlib``, no ``imageio``); the resize is OpenCV's (``INTER_AREA``
to shrink, ``INTER_LINEAR`` to grow) in torch, on the device the frames go
to. Frames are batched into fixed shapes, the last batch padded by
repeating its last frame.

Checkpoints are the reference's ``.pth``/``.pth.tar``/``.pt`` files or the
JAX package's flax ``.msgpack`` files, read by the port's own msgpack codec
and mapped onto the port's parameter names (``models/convert.py``).
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from . import disable_tf32, resolve_device
from .data.image_io import read_png, resize_like_cv2, write_png
from .models.convert import (
    disp_from_jax, load_torch_state_dict, pose_from_jax, read_jax_variables,
)
from .ops.geometry import pose_vec2mat
from .training.step import conv_autocast


def _imageio(path: str):
    try:
        import imageio.v2 as imageio
    except ImportError as exc:
        raise ImportError(f"{path}: only PNG files are read and written without imageio, "
                          "which is not installed") from exc
    return imageio


def read_image(path: str) -> np.ndarray:
    """uint8 RGB ``[H, W, 3]``: grey becomes 3 channels, alpha is dropped.
    PNGs through ``read_png``; other formats need ``imageio``."""
    if path.lower().endswith(".png"):
        return read_png(path)
    img = np.asarray(_imageio(path).imread(path))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return np.ascontiguousarray(img[..., :3]).astype(np.uint8)


def write_image(path: str, img_u8: np.ndarray) -> None:
    """Write uint8 RGB: PNG through ``write_png``; other formats need
    ``imageio``."""
    if path.lower().endswith(".png"):
        write_png(path, img_u8)
    else:
        _imageio(path).imwrite(path, img_u8)


def load_image(path: str, height: Optional[int] = None, width: Optional[int] = None,
               device="cpu") -> torch.Tensor:
    """An RGB image as float32 ``[H, W, 3]`` in [0, 255] on ``device``,
    resized there when ``height`` is given."""
    img = torch.from_numpy(read_image(path)).to(device).float()
    if height is not None:
        img = resize_like_cv2(img, height, width)
    return img


def normalize(img):
    """[0,255] -> standardized (reference: test_disp.py:32)."""
    return (img / 255.0 - 0.45) / 0.225


def load_normalized(path: str, height: Optional[int], width: Optional[int],
                    device="cpu") -> torch.Tensor:
    return normalize(load_image(path, height, width, device))


def batched(paths: Sequence[str], batch_size: int, height: int, width: int,
            device="cpu") -> Iterator[Tuple[torch.Tensor, int]]:
    """Yield (padded batch ``[B, H, W, 3]`` on ``device``, n_valid) over
    image paths. The last batch is padded by repeating its last image, so
    every call has the same shape."""
    for start in range(0, len(paths), batch_size):
        chunk = list(paths[start:start + batch_size])
        n_valid = len(chunk)
        chunk += [chunk[-1]] * (batch_size - n_valid)
        yield torch.stack([load_normalized(p, height, width, device) for p in chunk]), n_valid


TORCH_SUFFIXES = (".pth", ".pth.tar", ".pt")


def _read_state(path: str, from_jax, num_layers: int, net: str) -> Dict[str, torch.Tensor]:
    if path.endswith(TORCH_SUFFIXES):
        return load_torch_state_dict(path)
    variables = read_jax_variables(path)
    try:
        return from_jax(variables, num_layers)
    except (KeyError, TypeError) as exc:
        raise ValueError(f"{path}: not the flax variables of a ResNet-{num_layers} {net} "
                         f"(no {exc})") from None


def restore_disp_state(path: str, num_layers: int = 18) -> Dict[str, torch.Tensor]:
    """A DispNet state dict from a reference-layout ``.pth``/``.pth.tar``/
    ``.pt`` checkpoint or a JAX ``.msgpack`` of a ResNet-``num_layers``
    DispNet's ``{params, batch_stats}``."""
    return _read_state(path, disp_from_jax, num_layers, "DispNet")


def restore_pose_state(path: str, num_layers: int = 18) -> Dict[str, torch.Tensor]:
    """A PoseNet state dict (ResNet-18 as both trainers build it, unless
    ``num_layers`` says otherwise) from a reference-layout checkpoint or a
    JAX ``.msgpack``."""
    return _read_state(path, pose_from_jax, num_layers, "PoseNet")


def make_pose_inference_fn(
    pose_net, device=None, precision: str = "bf16", rotation_mode: str = "euler",
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Pairwise pose inference: ``infer_pairs(img1, img2)`` (both ``[B, H,
    W, 3]``) returns the ``[B, 3, 4]`` transforms of PoseNet's 6-DoF output
    in eval mode, converted by ``pose_vec2mat`` in fp32 on ``device``."""
    device = resolve_device(device)
    disable_tf32()
    pose_net.to(device)

    def infer_pairs(img1, img2) -> torch.Tensor:
        pose_net.eval()
        with torch.no_grad():
            with conv_autocast(device, precision):
                pose = pose_net(img1.to(device).float(), img2.to(device).float())
            return pose_vec2mat(pose.float(), rotation_mode)

    return infer_pairs


def add_device_flags(parser: argparse.ArgumentParser) -> None:
    """``--device`` and ``--precision`` of the network CLIs."""
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="run the network on the CUDA card (raises without one) or on "
                        "the CPU")
    parser.add_argument("--precision", choices=["bf16", "fp32"], default="bf16",
                        help="convolution precision (heads and geometry always fp32)")
