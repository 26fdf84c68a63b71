"""The traffic's dataset: a KITTI-layout scene tree built from the pool.

A scene is a drive through the pool's frames (``benchmark/pool/*.jpg``,
rendered by ``make_pool.py``): from a start drawn from the seed it walks
forward and, at the pool's end, back again, so neighbouring frames of a
scene are neighbouring frames of the drive. Every scene has its own pinhole
intrinsics near KITTI's at 832x256, drawn from the seed. The tree is what
``prepare_train_data.py`` writes (``<scene>/0000000.jpg ...``, ``cam.txt``,
``train.txt``, an empty ``val.txt``); its frames are hard links to the pool's
files where the file system allows, else copies.

Every seed gets the same number of scenes, frames and snippets; only the
drives' starts and the intrinsics change. ``samples`` lists the snippets
in the order the port's ``SequenceSet`` and ``PackedSequenceSet`` number
them, which is what the reference follows.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import shutil
from typing import List, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# KITTI raw's camera 2 scaled to 832x256 (fx 721.5 at 1242 columns).
BASE_INTRINSICS = (483.3, 492.6, 416.0, 128.0)


@dataclasses.dataclass(frozen=True)
class Scene:
    name: str
    frames: Tuple[int, ...]      # pool indices, in frame order
    intrinsics: Tuple[float, ...]  # fx, fy, cx, cy

    def matrix(self) -> np.ndarray:
        fx, fy, cx, cy = self.intrinsics
        return np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


def pool_files(traffic: dict) -> List[str]:
    """The pool's JPEGs, sorted: ``traffic["pool"]``, relative to the
    checkout's root (or absolute)."""
    pool_dir = os.path.join(ROOT, traffic["pool"])
    files = sorted(glob.glob(os.path.join(pool_dir, "*.jpg")))
    if len(files) < 2:
        raise FileNotFoundError(f"no pool of frames in {pool_dir}")
    return files


def layout(seed: int, scenes: int, frames_per_scene: int, pool_size: int) -> List[Scene]:
    """The scenes of ``seed``: drives of ``frames_per_scene`` pool frames."""
    rng = np.random.default_rng([seed, 0x5CE7E])
    period = 2 * (pool_size - 1)
    out = []
    for s in range(scenes):
        start = int(rng.integers(period))
        steps = (start + np.arange(frames_per_scene)) % period
        frames = tuple(int(q) if q < pool_size else int(period - q) for q in steps)
        jitter = rng.uniform(-0.05, 0.05, 4) * np.array([1.0, 1.0, 0.02, 0.05])
        intr = tuple(round(v * (1.0 + j), 3) for v, j in zip(BASE_INTRINSICS, jitter))
        out.append(Scene(f"drive_{s:02d}", frames, intr))
    return out


def samples(scenes: List[Scene], sequence_length: int = 3):
    """``(tgt, refs, intrinsics)`` of every snippet, pool indices and a
    float32 matrix, in the dataset's order (scene by scene, ``±k`` refs)."""
    demi = (sequence_length - 1) // 2
    shifts = [j for j in range(-demi, demi + 1) if j != 0]
    out = []
    for scene in scenes:
        k = scene.matrix().astype(np.float32)
        for i in range(demi, len(scene.frames) - demi):
            out.append((scene.frames[i], [scene.frames[i + j] for j in shifts], k))
    return out


def write_tree(root: str, scenes: List[Scene], files: List[str]) -> str:
    """The JPEG tree of ``scenes`` under ``root``; returns ``root``."""
    os.makedirs(root, exist_ok=True)
    for scene in scenes:
        d = os.path.join(root, scene.name)
        os.makedirs(d, exist_ok=True)
        np.savetxt(os.path.join(d, "cam.txt"), scene.matrix())
        for i, p in enumerate(scene.frames):
            dst = os.path.join(d, f"{i:07d}.jpg")
            try:
                os.link(files[p], dst)
            except OSError:
                shutil.copyfile(files[p], dst)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("".join(f"{s.name}\n" for s in scenes))
    open(os.path.join(root, "val.txt"), "w").close()
    return root
