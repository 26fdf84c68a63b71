"""Procedural multi-view-consistent synthetic driving scenes.

The port's own copy of the repository's ``tools/synthetic_scene.py`` (numpy
only), the same files from the same seeds; the JPEGs are written by the
port's codec (``data/jpeg_io.py``) at quality 96, as ``imageio`` writes
them there. It ray-casts a static 3D world (ground plane, scattered boxes,
back wall) with a procedural 3D texture from a forward-moving camera:

  root/scene_K/NNNNNNN.jpg      rendered frames (multi-view consistent)
  root/scene_K/NNNNNNN.npy      ground-truth depth per frame
  root/scene_K/cam.txt          pinhole intrinsics
  root/scene_K/poses_gt.txt     KITTI-format camera-to-world poses
  root/train.txt, root/val.txt

Because appearance comes from a world-space texture, photometric
reconstruction across frames is consistent with the ground-truth depth and
poses: the self-supervised objective has a true optimum, and a short
training run can be evaluated against the ground truth with the eval CLIs
(the train CLI's ``--with-gt`` reads the ``.npy`` depths).

    python -m sc_sfmlearner_release_tpu_torch.tools.synthetic_scene --root DIR --frames 96
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..data import jpeg_io

H, W = 256, 832
FX, FY = 350.0, 350.0
CX, CY = W / 2.0, H / 2.0
JPEG_QUALITY = 96
RENDER_THREADS = 8


def _texture(points: np.ndarray) -> np.ndarray:
    """Procedural RGB texture of world points [N, 3] -> [N, 3] in [0, 1]."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = 0.5 + 0.25 * np.sin(1.7 * x) * np.cos(0.9 * z) + 0.15 * np.sin(5.1 * y + 2.0 * z)
    g = 0.5 + 0.25 * np.sin(1.1 * z + 0.5) * np.cos(2.3 * x) + 0.15 * np.cos(4.3 * y)
    b = 0.5 + 0.25 * np.cos(0.7 * x + 1.3 * z) + 0.15 * np.sin(3.7 * (x + y))
    # high-frequency detail so photometric gradients are informative
    detail = 0.12 * np.sin(13.0 * x) * np.sin(11.0 * z)
    rgb = np.stack([r + detail, g + detail, b - detail], axis=1)
    return np.clip(rgb, 0.02, 0.98)


def _make_boxes(rng: np.random.RandomState, n: int = 14):
    """Axis-aligned boxes resting on the ground plane (y = +1.5, y down)."""
    boxes = []
    for _ in range(n):
        cx = rng.uniform(-14, 14)
        cz = rng.uniform(8, 70)
        w = rng.uniform(1.5, 5.0)
        h = rng.uniform(2.0, 6.0)
        d = rng.uniform(1.5, 5.0)
        lo = np.array([cx - w / 2, 1.5 - h, cz - d / 2])
        hi = np.array([cx + w / 2, 1.5, cz + d / 2])
        boxes.append((lo, hi))
    return boxes


def _ray_box(origins, dirs, lo, hi):
    """Slab-method ray/AABB intersection -> hit distance (inf if miss)."""
    inv = 1.0 / np.where(np.abs(dirs) < 1e-9, 1e-9, dirs)
    t0 = (lo[None] - origins) * inv
    t1 = (hi[None] - origins) * inv
    tmin = np.minimum(t0, t1).max(axis=1)
    tmax = np.maximum(t0, t1).min(axis=1)
    hit = tmax >= np.maximum(tmin, 1e-3)
    return np.where(hit, np.maximum(tmin, 1e-3), np.inf)


def render(pose_c2w: np.ndarray, boxes) -> tuple:
    """Render one frame: (rgb [H, W, 3] uint8, depth [H, W] f32)."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    rays_cam = np.stack([(xs - CX) / FX, (ys - CY) / FY, np.ones_like(xs)],
                        axis=-1).reshape(-1, 3)
    r = pose_c2w[:3, :3]
    t = pose_c2w[:3, 3]
    dirs = rays_cam @ r.T
    origins = np.broadcast_to(t, dirs.shape)

    best_t = np.full(dirs.shape[0], np.inf)

    # ground plane y = 1.5 (y points down)
    denom = dirs[:, 1]
    t_plane = np.where(np.abs(denom) > 1e-9, (1.5 - origins[:, 1]) / denom, np.inf)
    t_plane = np.where(t_plane > 1e-3, t_plane, np.inf)
    best_t = np.minimum(best_t, t_plane)

    # back wall z = 90
    denom = dirs[:, 2]
    t_wall = np.where(np.abs(denom) > 1e-9, (90.0 - origins[:, 2]) / denom, np.inf)
    t_wall = np.where(t_wall > 1e-3, t_wall, np.inf)
    best_t = np.minimum(best_t, t_wall)

    for lo, hi in boxes:
        best_t = np.minimum(best_t, _ray_box(origins, dirs, lo, hi))

    best_t = np.where(np.isfinite(best_t), best_t, 200.0)
    points = origins + dirs * best_t[:, None]
    rgb = (_texture(points) * 255).astype(np.uint8).reshape(H, W, 3)
    # depth = z in the camera frame (rays_cam z == 1 -> depth = hit param)
    depth = (best_t * 1.0).astype(np.float32).reshape(H, W)
    return rgb, depth


def camera_trajectory(n: int, rng: np.random.RandomState) -> np.ndarray:
    """Forward motion with gentle steering: [n, 4, 4] camera-to-world."""
    poses = []
    pos = np.zeros(3)
    yaw = 0.0
    for i in range(n):
        yaw += 0.004 * np.sin(i / 9.0) + rng.normal(0, 0.0015)
        c, s = np.cos(yaw), np.sin(yaw)
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        fwd = r @ np.array([0, 0, 1.0])
        pos = pos + fwd * 0.8
        p = np.eye(4)
        p[:3, :3] = r
        p[:3, 3] = pos
        poses.append(p)
    return np.stack(poses)


def make_dataset(root: str, frames: int = 96, seed: int = 0, val_frames: int = 24) -> None:
    """Write a train scene of ``frames`` and a val scene of ``val_frames``."""
    os.makedirs(root, exist_ok=True)
    k = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]])

    for scene_idx, (name, n) in enumerate([("scene_0", frames), ("scene_1", val_frames)]):
        rng = np.random.RandomState(seed + scene_idx)
        boxes = _make_boxes(rng)
        poses = camera_trajectory(n, rng)
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        np.savetxt(os.path.join(d, "cam.txt"), k)

        def write(i):
            rgb, depth = render(poses[i], boxes)
            jpeg_io.encode(os.path.join(d, f"{i:07d}.jpg"), rgb, quality=JPEG_QUALITY)
            np.save(os.path.join(d, f"{i:07d}.npy"), depth)
            if i % 16 == 0:
                print(f"{name}: frame {i}/{n}", flush=True)

        # Frames render independently (numpy and the codec release the GIL).
        with ThreadPoolExecutor(RENDER_THREADS) as pool:
            list(pool.map(write, range(n)))
        rows = [poses[i][:3].reshape(-1) for i in range(n)]
        np.savetxt(os.path.join(d, "poses_gt.txt"), np.stack(rows), fmt="%1.8e")

    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("scene_0\n")
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("scene_1\n")
    print(f"dataset written to {root}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True)
    p.add_argument("--frames", type=int, default=96)
    p.add_argument("--val-frames", type=int, default=24)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    make_dataset(a.root, a.frames, a.seed, a.val_frames)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
