"""Intrinsics-aware, snippet-coherent augmentations (host-side NumPy).

The port's own copy of the JAX package's ``data/transforms.py`` (numpy
only; PIL is imported inside ``RandomScaleCrop`` and ``Resize``).

Behavioral parity target: the reference's custom_transforms.py — every
transform applies one random draw coherently to ALL frames of a snippet and
updates the pinhole intrinsics to match (flip moves cx; scale-crop scales
fx, fy and shifts cx, cy).

Randomness is explicit: each transform takes a ``numpy.random.Generator`` at
call time, so worker threads are deterministic given (seed, sample index) —
no global-seed mutation like the reference (custom_transforms.py:51,70).

Images are float32 HWC in [0, 255] on entry (as decoded); ``ToFloat``
rescales to [0, 1] and ``Normalize`` standardizes — matching the reference's
ArrayToTensor + Normalize(mean=0.45, std=0.225) pipeline (train.py:92-100),
but keeping NHWC.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

Images = List[np.ndarray]
Intrinsics = Optional[np.ndarray]

IMAGENET_MEAN = (0.45, 0.45, 0.45)
IMAGENET_STD = (0.225, 0.225, 0.225)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(
        self, images: Images, intrinsics: Intrinsics, rng: np.random.Generator
    ) -> Tuple[Images, Intrinsics]:
        for t in self.transforms:
            images, intrinsics = t(images, intrinsics, rng)
        return images, intrinsics


class ToFloat:
    """uint8/float [0,255] HWC -> float32 [0,1]."""

    def __call__(self, images, intrinsics, rng):
        return [np.asarray(im, np.float32) / 255.0 for im in images], intrinsics


class Normalize:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, images, intrinsics, rng):
        return [(im - self.mean) / self.std for im in images], intrinsics


class RandomHorizontalFlip:
    """Flip all frames with p=0.5 and mirror cx (reference:
    custom_transforms.py:46-59)."""

    def __call__(self, images, intrinsics, rng):
        if rng.random() < 0.5:
            images = [np.ascontiguousarray(im[:, ::-1]) for im in images]
            if intrinsics is not None:
                intrinsics = intrinsics.copy()
                intrinsics[0, 2] = images[0].shape[1] - intrinsics[0, 2]
        return images, intrinsics


class RandomScaleCrop:
    """Zoom up to ``max_scale`` then crop back to the input size, adjusting
    fx, fy, cx, cy (reference: custom_transforms.py:62-84)."""

    def __init__(self, max_scale: float = 1.15):
        self.max_scale = max_scale

    def __call__(self, images, intrinsics, rng):
        from PIL import Image

        in_h, in_w = images[0].shape[:2]
        x_scaling, y_scaling = rng.uniform(1.0, self.max_scale, 2)
        scaled_h, scaled_w = int(in_h * y_scaling), int(in_w * x_scaling)

        if intrinsics is not None:
            intrinsics = intrinsics.copy()
            intrinsics[0] *= x_scaling
            intrinsics[1] *= y_scaling

        scaled = [
            np.asarray(
                Image.fromarray(im.astype(np.uint8)).resize((scaled_w, scaled_h))
            ).astype(np.float32)
            for im in images
        ]

        offset_y = int(rng.integers(scaled_h - in_h + 1))
        offset_x = int(rng.integers(scaled_w - in_w + 1))
        cropped = [
            im[offset_y : offset_y + in_h, offset_x : offset_x + in_w]
            for im in scaled
        ]
        if intrinsics is not None:
            intrinsics[0, 2] -= offset_x
            intrinsics[1, 2] -= offset_y
        return cropped, intrinsics


class Resize:
    """Deterministic resize to (h, w); rescales intrinsics accordingly."""

    def __init__(self, h: int, w: int):
        self.h, self.w = h, w

    def __call__(self, images, intrinsics, rng):
        from PIL import Image

        in_h, in_w = images[0].shape[:2]
        if (in_h, in_w) == (self.h, self.w):
            return images, intrinsics
        if intrinsics is not None:
            intrinsics = intrinsics.copy()
            intrinsics[0] *= self.w / in_w
            intrinsics[1] *= self.h / in_h
        out = [
            np.asarray(
                Image.fromarray(im.astype(np.uint8)).resize((self.w, self.h))
            ).astype(np.float32)
            for im in images
        ]
        return out, intrinsics


def train_transform(max_scale: float = 1.15) -> Compose:
    """The reference's canonical training augmentation (train.py:95-100)."""
    return Compose(
        [RandomHorizontalFlip(), RandomScaleCrop(max_scale), ToFloat(), Normalize()]
    )


def valid_transform() -> Compose:
    return Compose([ToFloat(), Normalize()])


def raw_train_transform() -> Compose:
    """Decode-only path for --device-augment: the host emits raw [0,1]
    frames; flip/scale-crop/normalize run on the device inside the train
    step (data/device_augment.py)."""
    return Compose([ToFloat()])
