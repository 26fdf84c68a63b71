"""Synthesize a miniature NYUv2-shaped tree for the NYU parity runbook's
smoke mode (scripts/nyu_parity_runbook.sh SMOKE=1).

The port's own copy of the root ``tools/make_smoke_nyu.py``: the same files
from the same seeds, written by ``write_png`` (16-bit grey for the depth),
the port's JPEG codec and ``np.save``. Run as
``python -m sc_sfmlearner_release_tpu_torch.tools.make_smoke_nyu OUT``.

Builds, under OUT:
  rectified/   pair-folder training tree (the reference's rectified-NYU
               layout consumed with --folder-type pair: per scene, jpgs in
               consecutive pairs + one intrinsics txt per pair —
               the reference's datasets/pair_folders.py:22-33), plus a
               val scene with depth/*.png GT (uint16, mm-like /5000
               convention) for --with-gt validation.
  test/        NYU test set for test_disp + eval_depth --dataset nyu:
               color/*.png images + one stacked depth.npy
               (the reference's scripts/test_nyu.sh).

Random-noise imagery: the smoke chain validates PLUMBING (CLIs run
end-to-end, artifacts are well-formed), not metric quality.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import jpeg_io
from ..data.image_io import write_png


def make_training(root: str, h: int, w: int, scenes: int, pairs: int) -> None:
    rng = np.random.RandomState(0)
    k = np.array(
        [[0.58 * w, 0, w / 2], [0, 0.58 * h, h / 2], [0, 0, 1]], np.float32
    )
    names = []
    for s in range(scenes):
        name = f"scene_{s}"
        names.append(name)
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        for p in range(pairs):
            for j in (0, 1):
                jpeg_io.encode(
                    os.path.join(d, f"{2 * p + j:06d}.jpg"),
                    (rng.rand(h, w, 3) * 255).astype(np.uint8),
                )
            np.savetxt(os.path.join(d, f"{p:06d}.txt"), k)
    # val scene: images + depth/*.png (ValidationSet nyu: png / 5000)
    vname = "scene_val"
    vd = os.path.join(root, vname)
    os.makedirs(os.path.join(vd, "depth"), exist_ok=True)
    for i in range(max(3, pairs)):
        jpeg_io.encode(
            os.path.join(vd, f"{i:06d}.jpg"),
            (rng.rand(h, w, 3) * 255).astype(np.uint8),
        )
        depth_png = (rng.rand(h, w) * 4.0 + 1.0) * 5000.0
        write_png(
            os.path.join(vd, "depth", f"{i:06d}.png"),
            depth_png.astype(np.uint16),
        )
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write(vname + "\n")


def make_test(root: str, h: int, w: int, n: int) -> None:
    rng = np.random.RandomState(1)
    os.makedirs(os.path.join(root, "color"), exist_ok=True)
    depths = []
    for i in range(n):
        write_png(
            os.path.join(root, "color", f"{i:04d}.png"),
            (rng.rand(h, w, 3) * 255).astype(np.uint8),
        )
        depths.append((rng.rand(h, w) * 4.0 + 1.0).astype(np.float32))
    np.save(os.path.join(root, "depth.npy"), np.stack(depths))


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("out")
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--pairs", type=int, default=6)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    make_training(os.path.join(args.out, "rectified"), args.height,
                  args.width, args.scenes, args.pairs)
    make_test(os.path.join(args.out, "test"), args.height, args.width, 4)
    print(f"smoke NYU tree ready under {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
