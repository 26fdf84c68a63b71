"""Packed raw-frame dataset: the accelerator-rate input format.

The port's own copy of the JAX package's ``data/packed.py``; the files it
writes and reads are the same. The reference feeds training from per-frame
JPEGs decoded in DataLoader workers (the reference's train.py:142-147).
Here every frame is decoded ONCE at pack time into a contiguous uint8
memmap, so the per-step host work is a memcpy slice and the host-to-device
copy carries uint8 (4x fewer bytes than f32). It is also the input path
that needs no JPEG decoder at training time.

Run as ``python -m sc_sfmlearner_release_tpu_torch.data.packed DIR``.

On-disk layout (under ``<root>/packed/``):

    frames.u8     [n_frames, H, W, 3] uint8, C-order, one big memmap
    index.json    {"height", "width", "scenes": {name: {"start", "count",
                   "intrinsics" (3x3 nested list)}}, "train": [...names],
                   "val": [...names]}

``PackedSequenceSet`` mirrors ``SequenceSet``'s constructor and ``load``
protocol (data/datasets.py) so it drops into ``BatchLoader`` unchanged.
With ``transform=None`` (the fast path for ``--device-augment``) it returns
uint8 frames; flip/scale-crop/normalize then run on the device inside the
train step (data/device_augment.py accepts uint8 and converts there).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

import numpy as np

INDEX_NAME = "index.json"
FRAMES_NAME = "frames.u8"


def pack_dataset(root: str, out_dir: Optional[str] = None) -> str:
    """Decode every scene frame of a prepared dataset tree once into a
    packed memmap. ``root`` must hold ``train.txt``/``val.txt`` + scene dirs
    of sorted ``*.jpg`` and a ``cam.txt`` each (the prepare_train_data
    output format). All frames must share one resolution (the ETL resizes
    to a fixed ``--width x --height``). Returns the packed directory.
    """
    from .native_io import imread_u8

    out_dir = out_dir or os.path.join(root, "packed")
    os.makedirs(out_dir, exist_ok=True)

    splits: Dict[str, List[str]] = {}
    for split in ("train", "val"):
        path = os.path.join(root, f"{split}.txt")
        if os.path.exists(path):
            with open(path) as f:
                splits[split] = [ln.strip() for ln in f if ln.strip()]
        else:
            splits[split] = []

    scene_names = [s for split in splits.values() for s in split]
    scenes: Dict[str, Dict] = {}
    files: List[str] = []
    for name in scene_names:
        scene_dir = os.path.join(root, name)
        cam = os.path.join(scene_dir, "cam.txt")
        imgs = sorted(glob.glob(os.path.join(scene_dir, "*.jpg")))
        if not os.path.exists(cam) or not imgs:
            continue
        intrinsics = np.genfromtxt(cam).astype(np.float32).reshape(3, 3)
        scenes[name] = {
            "start": len(files),
            "count": len(imgs),
            "intrinsics": intrinsics.tolist(),
        }
        files.extend(imgs)

    if not files:
        raise ValueError(f"no scene frames found under {root}")

    first = imread_u8(files[0])
    h, w = first.shape[:2]
    frames = np.memmap(
        os.path.join(out_dir, FRAMES_NAME),
        dtype=np.uint8,
        mode="w+",
        shape=(len(files), h, w, 3),
    )
    for i, path in enumerate(files):
        img = first if i == 0 else imread_u8(path)
        if img.shape[:2] != (h, w):
            raise ValueError(
                f"frame size mismatch: {path} is {img.shape[:2]}, "
                f"expected {(h, w)} — pack requires one resolution"
            )
        frames[i] = img
    frames.flush()

    index = {
        "height": h,
        "width": w,
        "n_frames": len(files),
        "scenes": scenes,
        "train": [s for s in splits["train"] if s in scenes],
        "val": [s for s in splits["val"] if s in scenes],
    }
    with open(os.path.join(out_dir, INDEX_NAME), "w") as f:
        json.dump(index, f)
    return out_dir


class PackedSequenceSet:
    """``SequenceSet``-protocol view over a packed directory.

    ``load`` returns uint8 frames when ``transform is None`` (the
    device-augment fast path: host work = memmap slice + stack); with a
    transform, frames are lifted to float32 [0,255] first so the standard
    host transforms (data/transforms.py) apply unchanged.
    """

    def __init__(
        self,
        packed_dir: str,
        train: bool = True,
        sequence_length: int = 3,
        skip_frames: int = 1,
        transform=None,
    ):
        self.packed_dir = packed_dir
        self.transform = transform
        with open(os.path.join(packed_dir, INDEX_NAME)) as f:
            self.index = json.load(f)
        h, w = self.index["height"], self.index["width"]
        self.frames = np.memmap(
            os.path.join(packed_dir, FRAMES_NAME),
            dtype=np.uint8,
            mode="r",
            shape=(self.index["n_frames"], h, w, 3),
        )

        demi = (sequence_length - 1) // 2
        k = skip_frames
        shifts = [j for j in range(-demi * k, demi * k + 1, k) if j != 0]

        split = "train" if train else "val"
        self.scenes = list(self.index[split])
        self.samples: List[Dict] = []
        for name in self.scenes:
            meta = self.index["scenes"][name]
            start, count = meta["start"], meta["count"]
            if count < sequence_length:
                continue
            intrinsics = np.asarray(meta["intrinsics"], np.float32)
            for i in range(demi * k, count - demi * k):
                self.samples.append(
                    {
                        "intrinsics": intrinsics,
                        "tgt": start + i,
                        "refs": [start + i + j for j in shifts],
                    }
                )

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, index: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        s = self.samples[index]
        tgt = np.asarray(self.frames[s["tgt"]])
        refs = [np.asarray(self.frames[i]) for i in s["refs"]]
        intrinsics = s["intrinsics"].copy()
        if self.transform is not None:
            images = [tgt.astype(np.float32)] + [r.astype(np.float32) for r in refs]
            images, intrinsics = self.transform(images, intrinsics, rng)
            return {
                "tgt": images[0],
                "refs": np.stack(images[1:]),
                "intrinsics": intrinsics,
            }
        return {"tgt": tgt, "refs": np.stack(refs), "intrinsics": intrinsics}


def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        description="Pack a prepared scene tree into the raw uint8 memmap "
        "format (decode once; train with --packed)."
    )
    p.add_argument("root", help="prepared dataset root (train.txt + scenes)")
    p.add_argument("--out", default=None, help="output dir (default <root>/packed)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    out = pack_dataset(args.root, args.out)
    with open(os.path.join(out, INDEX_NAME)) as f:
        idx = json.load(f)
    print(
        f"packed {idx['n_frames']} frames "
        f"({idx['height']}x{idx['width']}) from "
        f"{len(idx['scenes'])} scenes -> {out}"
    )


if __name__ == "__main__":
    main()
