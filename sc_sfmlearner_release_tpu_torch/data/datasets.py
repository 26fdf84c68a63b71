"""Dataset crawlers for the reference's on-disk formats.

Formats (produced by data/prepare_train_data.py, consumed identically to the
reference so datasets interoperate):

  SequenceSet (reference: datasets/sequence_folders.py)
      root/train.txt, root/val.txt    one scene dir name per line
      root/scene/0000000.jpg ...      sorted frames
      root/scene/cam.txt              3x3 intrinsics

  PairSet (reference: datasets/pair_folders.py, NYUv2 style)
      root/scene/{even,odd}.jpg pairs + one intrinsics .txt per pair

  ValidationSet (reference: datasets/validation_folders.py)
      root/scene/NNN.jpg + NNN.npy (kitti) or depth/NNN.png /5000 (nyu)

Crawlers return plain sample descriptors; decoding happens in ``load`` so a
prefetching loader can parallelize it. The port's own copy of the JAX
package's ``data/datasets.py``.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from ..utils import profiling
from .image_io import decode_png


def _imread_f32(path: str) -> np.ndarray:
    from .native_io import imread_f32

    with profiling.span("data.decode"):
        return imread_f32(path)


def _read_scene_list(root: str, name: str) -> List[str]:
    path = os.path.join(root, name)
    with open(path) as f:
        return [os.path.join(root, line.strip()) for line in f if line.strip()]


class SequenceSet:
    """(tgt, refs at ±k·skip) snippets from scene folders."""

    def __init__(
        self,
        root: str,
        train: bool = True,
        sequence_length: int = 3,
        skip_frames: int = 1,
        transform=None,
        dataset: str = "kitti",
    ):
        self.root = root
        self.transform = transform
        self.dataset = dataset
        scene_list = "train.txt" if train else "val.txt"
        self.scenes = _read_scene_list(root, scene_list)

        demi = (sequence_length - 1) // 2
        k = skip_frames
        shifts = [j for j in range(-demi * k, demi * k + 1, k) if j != 0]

        self.samples: List[Dict] = []
        for scene in self.scenes:
            cam = os.path.join(scene, "cam.txt")
            if not os.path.exists(cam):
                continue
            intrinsics = np.genfromtxt(cam).astype(np.float32).reshape(3, 3)
            imgs = sorted(glob.glob(os.path.join(scene, "*.jpg")))
            if len(imgs) < sequence_length:
                continue
            for i in range(demi * k, len(imgs) - demi * k):
                self.samples.append(
                    {
                        "intrinsics": intrinsics,
                        "tgt": imgs[i],
                        "refs": [imgs[i + j] for j in shifts],
                    }
                )

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, index: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        s = self.samples[index]
        images = [_imread_f32(s["tgt"])] + [_imread_f32(p) for p in s["refs"]]
        intrinsics = s["intrinsics"].copy()
        if self.transform is not None:
            images, intrinsics = self.transform(images, intrinsics, rng)
        return {
            "tgt": images[0],
            "refs": np.stack(images[1:]),
            "intrinsics": intrinsics,
        }


class PairSet:
    """Consecutive image pairs with per-pair intrinsics (NYUv2)."""

    def __init__(self, root: str, train: bool = True, transform=None):
        self.root = root
        self.transform = transform
        scene_list = "train.txt" if train else "val.txt"
        self.scenes = _read_scene_list(root, scene_list)

        self.samples: List[Dict] = []
        for scene in self.scenes:
            imgs = sorted(glob.glob(os.path.join(scene, "*.jpg")))
            cams = sorted(glob.glob(os.path.join(scene, "*.txt")))
            for i in range(0, len(imgs) - 1, 2):
                intr = np.genfromtxt(cams[i // 2]).astype(np.float32).reshape(3, 3)
                self.samples.append(
                    {"intrinsics": intr, "tgt": imgs[i], "refs": [imgs[i + 1]]}
                )

    def __len__(self) -> int:
        return len(self.samples)

    load = SequenceSet.load


class ValidationSet:
    """(image, GT depth) pairs for with-GT validation."""

    def __init__(self, root: str, transform=None, dataset: str = "kitti"):
        self.root = root
        self.transform = transform
        self.dataset = dataset
        self.scenes = _read_scene_list(root, "val.txt")

        self.imgs: List[str] = []
        self.depths: List[str] = []
        for scene in self.scenes:
            imgs = sorted(glob.glob(os.path.join(scene, "*.jpg")))
            if dataset == "nyu":
                depths = sorted(glob.glob(os.path.join(scene, "depth", "*.png")))
            else:
                depths = sorted(glob.glob(os.path.join(scene, "*.npy")))
            self.imgs.extend(imgs)
            self.depths.extend(depths)

    def __len__(self) -> int:
        return len(self.imgs)

    def load(self, index: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        img = _imread_f32(self.imgs[index])
        if self.dataset == "nyu":
            # single-channel 16-bit depth png / 5000 (reference:
            # datasets/validation_folders.py:56) — NOT the RGB image
            # reader, whose grayscale->3-channel stacking would hand the
            # eval step a [H, W, 3] depth map. The first channel also
            # reads RGB-encoded depth dumps.
            with open(self.depths[index], "rb") as f:
                depth = decode_png(f.read())[..., 0].astype(np.float32)
            depth = depth / 5000.0
        else:
            depth = np.load(self.depths[index]).astype(np.float32)
        if self.transform is not None:
            imgs, _ = self.transform([img], None, rng)
            img = imgs[0]
        return {"img": img, "depth": depth}
