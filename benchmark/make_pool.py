"""Render the benchmark's pool of frames and write them as JPEGs.

A frozen copy of the port's ``tools/synthetic_scene.py`` renderer (numpy:
a ground plane, scattered boxes and a back wall under a procedural 3D
texture, ray-cast from a camera driving forward), writing each frame at
KITTI's training size (832x256) as a baseline JPEG at quality 75 through
PIL, as ``prepare_train_data.py`` writes them. The pool is committed under
``benchmark/pool/``; the benchmark builds its datasets from those files and
never runs this script. Rerun it only to make a new pool:

    python3 benchmark/make_pool.py [--frames 48] [--seed 0]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

H, W = 256, 832
FX, FY = 350.0, 350.0
CX, CY = W / 2.0, H / 2.0
QUALITY = 75
SEED = 1  # the first seed whose drive enters no box
POOL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pool")


def _texture(points: np.ndarray) -> np.ndarray:
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = 0.5 + 0.25 * np.sin(1.7 * x) * np.cos(0.9 * z) + 0.15 * np.sin(5.1 * y + 2.0 * z)
    g = 0.5 + 0.25 * np.sin(1.1 * z + 0.5) * np.cos(2.3 * x) + 0.15 * np.cos(4.3 * y)
    b = 0.5 + 0.25 * np.cos(0.7 * x + 1.3 * z) + 0.15 * np.sin(3.7 * (x + y))
    detail = 0.12 * np.sin(13.0 * x) * np.sin(11.0 * z)
    rgb = np.stack([r + detail, g + detail, b - detail], axis=1)
    return np.clip(rgb, 0.02, 0.98)


def _boxes(rng: np.random.RandomState, n: int = 14):
    out = []
    for _ in range(n):
        cx, cz = rng.uniform(-14, 14), rng.uniform(8, 70)
        w, h, d = rng.uniform(1.5, 5.0), rng.uniform(2.0, 6.0), rng.uniform(1.5, 5.0)
        out.append((np.array([cx - w / 2, 1.5 - h, cz - d / 2]),
                    np.array([cx + w / 2, 1.5, cz + d / 2])))
    return out


def _ray_box(origins, dirs, lo, hi):
    inv = 1.0 / np.where(np.abs(dirs) < 1e-9, 1e-9, dirs)
    t0, t1 = (lo[None] - origins) * inv, (hi[None] - origins) * inv
    tmin, tmax = np.minimum(t0, t1).max(axis=1), np.maximum(t0, t1).min(axis=1)
    hit = tmax >= np.maximum(tmin, 1e-3)
    return np.where(hit, np.maximum(tmin, 1e-3), np.inf)


def render(pose_c2w: np.ndarray, boxes) -> np.ndarray:
    """One frame, uint8 ``[H, W, 3]``."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([(xs - CX) / FX, (ys - CY) / FY, np.ones_like(xs)], -1).reshape(-1, 3)
    dirs = rays @ pose_c2w[:3, :3].T
    origins = np.broadcast_to(pose_c2w[:3, 3], dirs.shape)
    best = np.full(dirs.shape[0], np.inf)
    for axis, level in ((1, 1.5), (2, 90.0)):  # the ground plane, the back wall
        denom = dirs[:, axis]
        with np.errstate(divide="ignore"):
            t = np.where(np.abs(denom) > 1e-9, (level - origins[:, axis]) / denom, np.inf)
        best = np.minimum(best, np.where(t > 1e-3, t, np.inf))
    for lo, hi in boxes:
        best = np.minimum(best, _ray_box(origins, dirs, lo, hi))
    best = np.where(np.isfinite(best), best, 200.0)
    return (_texture(origins + dirs * best[:, None]) * 255).astype(np.uint8).reshape(H, W, 3)


def trajectory(n: int, rng: np.random.RandomState) -> np.ndarray:
    poses, pos, yaw = [], np.zeros(3), 0.0
    for i in range(n):
        yaw += 0.004 * np.sin(i / 9.0) + rng.normal(0, 0.0015)
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pos = pos + rot @ np.array([0, 0, 0.8])
        p = np.eye(4)
        p[:3, :3], p[:3, 3] = rot, pos
        poses.append(p)
    return np.stack(poses)


def inside(pos: np.ndarray, boxes, margin: float = 0.5) -> bool:
    """Whether the camera at ``pos`` is in a box (or within ``margin`` of
    one): such a frame sees the box's inside, one flat colour."""
    return any(np.all(pos > lo - margin) and np.all(pos < hi + margin) for lo, hi in boxes)


def main(argv=None) -> int:
    from PIL import Image

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=48)
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--out", default=POOL_DIR)
    a = p.parse_args(argv)
    rng = np.random.RandomState(a.seed)
    boxes = _boxes(rng)
    poses = trajectory(a.frames, rng)
    blocked = [i for i in range(a.frames) if inside(poses[i][:3, 3], boxes)]
    if blocked:
        raise SystemExit(f"--seed {a.seed}: the camera is inside a box at frames {blocked}")
    os.makedirs(a.out, exist_ok=True)
    for i in range(a.frames):
        Image.fromarray(render(poses[i], boxes)).save(
            os.path.join(a.out, f"f{i:03d}.jpg"), quality=QUALITY)
    print(f"{a.frames} frames written to {a.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
