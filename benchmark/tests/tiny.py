"""A cell cut to a size the CPU runs in seconds, for the tests: 64x128
frames re-encoded from the pool, B2, two steps a dispatch, two scenes of
eight frames. The cut is the tests' alone; the benchmark runs the files."""

from __future__ import annotations

import os

import numpy as np

from benchmark import dataset, spec

H, W = 64, 128


def tiny_pool(directory: str, frames: int = 6) -> str:
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    for i, f in enumerate(dataset.pool_files({"pool": "benchmark/pool"})[:frames]):
        with Image.open(f) as im:
            im.convert("RGB").resize((W, H)).save(os.path.join(directory, f"f{i:03d}.jpg"),
                                                   quality=75)
    return directory


def tiny_cell(workload: str, pool: str, precision: str = "fp32",
              root: str = spec.ROOT) -> spec.Cell:
    cell = spec.resolve(spec.load_benchmark(root), workload, root)
    cell.config.update(height=H, width=W, batch_size=2, fused_steps=2, resnet_layers=18,
                       precision=precision)
    cell.traffic.update(pool=pool, scenes=2 * cell.traffic["world_size"], frames_per_scene=8,
                        workers=2)
    cell.limits["reference"] = precision  # the reference at the program's precision
    return cell


def frames(pool: str) -> np.ndarray:
    from PIL import Image

    files = dataset.pool_files({"pool": pool})
    return np.stack([np.asarray(Image.open(f).convert("RGB")) for f in files])
