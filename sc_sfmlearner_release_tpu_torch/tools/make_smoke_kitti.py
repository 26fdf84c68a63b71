"""Synthesize miniature KITTI-shaped inputs for the parity runbook's smoke
mode (scripts/kitti_parity_runbook.sh SMOKE=1).

The port's own copy of the root ``tools/make_smoke_kitti.py``: the same
files from the same seeds, written by ``write_png``. Run as
``python -m sc_sfmlearner_release_tpu_torch.tools.make_smoke_kitti OUT``.

Builds, under OUT:
  raw/        KITTI-raw-style tree (one date, one drive, cams 02+03, OXTS,
              velodyne, calib) — the input of prepare_train_data
              (same layout the ETL e2e test uses, tests/test_etl.py).
  depth_test/ Eigen-style eval set: color/*.png + depth/*.npy GT.
  odom/       odometry-style: <seq>/image_2/*.png for test_vo.py, plus a
              straight-line gt poses file gt/<seq>.txt for eval_odom.

``make_kitti_raw`` writes a raw tree at KITTI's sizes and with its
calibration values (two drives, 120,000-point scans), for ``chip_smoke.py``.

Everything is random-noise imagery — the smoke run validates the PLUMBING
(every CLI runs end-to-end and emits well-formed artifacts), not metric
quality; real KITTI through the same runbook is the Abs Rel parity gate.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from ..data.image_io import write_png


def make_raw(root: str, h: int, w: int, n_frames: int) -> None:
    rng = np.random.RandomState(0)
    date = "2011_09_26"
    drive = f"{date}_drive_0001_sync"
    ddir = os.path.join(root, date, drive)

    for cid in ("02", "03"):
        img_dir = os.path.join(ddir, f"image_{cid}", "data")
        os.makedirs(img_dir, exist_ok=True)
        for i in range(n_frames):
            write_png(
                os.path.join(img_dir, f"{i:010d}.png"),
                (rng.rand(h, w, 3) * 255).astype(np.uint8),
            )

    oxts_dir = os.path.join(ddir, "oxts", "data")
    os.makedirs(oxts_dir, exist_ok=True)
    for i in range(n_frames):
        meta = np.zeros(30)
        meta[0] = 49.0 + i * 1e-6
        meta[1] = 8.43 + i * 1e-5
        meta[2] = 112.0
        meta[8:11] = [5.0, 0.0, 0.0]  # speed above the static filter
        np.savetxt(os.path.join(oxts_dir, f"{i:010d}.txt"), meta[None])

    velo_dir = os.path.join(ddir, "velodyne_points", "data")
    os.makedirs(velo_dir, exist_ok=True)
    for i in range(n_frames):
        pts = rng.rand(500, 4).astype(np.float32)
        pts[:, 0] = pts[:, 0] * 20 + 2
        pts[:, 1] = (pts[:, 1] - 0.5) * 10
        pts[:, 2] = (pts[:, 2] - 0.5) * 2
        pts.tofile(os.path.join(velo_dir, f"{i:010d}.bin"))

    k = [200.0, 0.0, w / 2, 0.0, 0.0, 200.0, h / 2, 0.0, 0.0, 0.0, 1.0, 0.0]
    with open(os.path.join(root, date, "calib_cam_to_cam.txt"), "w") as f:
        f.write("R_rect_00: 1 0 0 0 1 0 0 0 1\n")
        f.write("P_rect_02: " + " ".join(str(v) for v in k) + "\n")
        f.write("P_rect_03: " + " ".join(str(v) for v in k) + "\n")
    with open(os.path.join(root, date, "calib_velo_to_cam.txt"), "w") as f:
        f.write("R: 0 -1 0 0 0 -1 1 0 0\nT: 0 0 0\n")
    with open(os.path.join(root, date, "calib_imu_to_velo.txt"), "w") as f:
        f.write("R: 1 0 0 0 1 0 0 0 1\nT: 0 0 0\n")


# KITTI's calibration of 2011_09_26 (calib_cam_to_cam.txt, calib_velo_to_cam.txt,
# calib_imu_to_velo.txt), the keys the ETL reads.
KITTI_CALIB = {
    "calib_cam_to_cam.txt": {
        "R_rect_00": "9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 9.999421e-01 "
                     "-4.278459e-03 7.402527e-03 4.351614e-03 9.999631e-01",
        "P_rect_02": "7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 0.000000e+00 "
                     "7.215377e+02 1.728540e+02 2.163791e-01 0.000000e+00 0.000000e+00 "
                     "1.000000e+00 2.745884e-03",
        "P_rect_03": "7.215377e+02 0.000000e+00 6.095593e+02 -3.395242e+02 0.000000e+00 "
                     "7.215377e+02 1.728540e+02 2.199936e+00 0.000000e+00 0.000000e+00 "
                     "1.000000e+00 2.729905e-03",
    },
    "calib_velo_to_cam.txt": {
        "R": "7.533745e-03 -9.999714e-01 -6.166020e-04 1.480249e-02 7.280733e-04 "
             "-9.998902e-01 9.998621e-01 7.523790e-03 1.480755e-02",
        "T": "-4.069766e-03 -7.631618e-02 -2.717806e-01",
    },
    "calib_imu_to_velo.txt": {
        "R": "9.999976e-01 7.553071e-04 -2.035826e-03 -7.854027e-04 9.998898e-01 "
             "-1.482298e-02 2.024406e-03 1.482454e-02 9.998881e-01",
        "T": "-8.086759e-01 3.195559e-01 -7.997231e-01",
    },
}
# Drives of 2011_09_26: 0022 has frames 0-4 in data/static_frames.txt; 0002
# is an Eigen test scene (data/test_scenes.txt).
KITTI_DRIVES = ("2011_09_26_drive_0001_sync", "2011_09_26_drive_0022_sync")
KITTI_TEST_DRIVE = "2011_09_26_drive_0002_sync"
STILL_FRAMES = {"2011_09_26_drive_0022_sync": range(5)}


def _panning_frames(rng: np.random.RandomState, h: int, w: int, n: int):
    """n uint8 [h, w, 3] frames of a camera panning 2 pixels per frame over a
    texture: colours drawn every 16 pixels, interpolated bilinearly, with
    noise of +-4 levels on them."""
    wide = w + 2 * n
    coarse = torch.from_numpy(rng.uniform(32, 224, (1, 3, h // 16 + 2, wide // 16 + 2)))
    texture = F.interpolate(coarse, size=(h, wide), mode="bilinear", align_corners=False)
    texture = texture[0].permute(1, 2, 0).numpy() + rng.randint(-4, 5, (h, wide, 3))
    texture = np.clip(np.round(texture), 0, 255).astype(np.uint8)
    return [texture[:, 2 * i:2 * i + w] for i in range(n)]


def make_kitti_raw(root: str, h: int = 375, w: int = 1242, n_frames: int = 24,
                   points: int = 120_000, seed: int = 0) -> None:
    """A raw tree with KITTI's shapes and values: one date, the drives of
    KITTI_DRIVES (cams 02 and 03, ``n_frames`` each, PNG rows in all five
    filters in turn) and a few frames of the test drive; KITTI's
    calibration; OXTS at 5 m/s except the drives' STILL_FRAMES; velodyne
    scans of ``points`` points over 360 degrees, 2-80 m, as KITTI's HDL-64
    (about 1.9 MB each at 120,000 points)."""
    rng = np.random.RandomState(seed)
    date = "2011_09_26"
    pngs = []
    for name, body in KITTI_CALIB.items():
        os.makedirs(os.path.join(root, date), exist_ok=True)
        with open(os.path.join(root, date, name), "w") as f:
            f.write("".join(f"{k}: {v}\n" for k, v in body.items()))
    for drive in KITTI_DRIVES + (KITTI_TEST_DRIVE,):
        ddir = os.path.join(root, date, drive)
        n = n_frames if drive != KITTI_TEST_DRIVE else 3
        for cid in ("02", "03"):
            img_dir = os.path.join(ddir, f"image_{cid}", "data")
            os.makedirs(img_dir, exist_ok=True)
            for i, frame in enumerate(_panning_frames(rng, h, w, n)):
                pngs.append((os.path.join(img_dir, f"{i:010d}.png"), frame, i % 5))
        oxts_dir = os.path.join(ddir, "oxts", "data")
        velo_dir = os.path.join(ddir, "velodyne_points", "data")
        os.makedirs(oxts_dir, exist_ok=True)
        os.makedirs(velo_dir, exist_ok=True)
        still = STILL_FRAMES.get(drive, ())
        moved = 0
        for i in range(n):
            moved += i not in still
            meta = np.zeros(30)
            meta[0] = 49.0 + moved * 3e-5   # lat, about 3.3 m a frame
            meta[1] = 8.43 + moved * 1e-6
            meta[2] = 112.0
            meta[5] = 0.01 * moved          # yaw
            meta[8:11] = [0.0, 0.0, 0.0] if i in still else [5.0, 0.0, 0.0]
            np.savetxt(os.path.join(oxts_dir, f"{i:010d}.txt"), meta[None])
            az = rng.uniform(-np.pi, np.pi, points)
            el = np.deg2rad(rng.uniform(-24.9, 2.0, points))
            rng_m = rng.uniform(2.0, 80.0, points)
            pts = np.stack([rng_m * np.cos(el) * np.cos(az), rng_m * np.cos(el) * np.sin(az),
                            rng_m * np.sin(el), rng.rand(points)], 1).astype(np.float32)
            pts.tofile(os.path.join(velo_dir, f"{i:010d}.bin"))
    with ThreadPoolExecutor(8) as pool:  # zlib releases the GIL
        list(pool.map(lambda job: write_png(*job), pngs))


def make_depth_test(root: str, h: int, w: int, n: int) -> None:
    rng = np.random.RandomState(1)
    os.makedirs(os.path.join(root, "color"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    for i in range(n):
        write_png(
            os.path.join(root, "color", f"{i:04d}.png"),
            (rng.rand(h, w, 3) * 255).astype(np.uint8),
        )
        depth = (rng.rand(h, w) * 60 + 2).astype(np.float32)
        np.save(os.path.join(root, "depth", f"{i:04d}.npy"), depth)


def make_odom(root: str, h: int, w: int, n: int, seq: str) -> None:
    rng = np.random.RandomState(2)
    img_dir = os.path.join(root, seq, "image_2")
    os.makedirs(img_dir, exist_ok=True)
    for i in range(n):
        write_png(
            os.path.join(img_dir, f"{i:06d}.png"),
            (rng.rand(h, w, 3) * 255).astype(np.uint8),
        )
    gt_dir = os.path.join(root, "gt")
    os.makedirs(gt_dir, exist_ok=True)
    poses = []
    for i in range(n):
        m = np.eye(4)
        m[2, 3] = 0.8 * i  # straight line, ~KITTI speeds at 10 Hz
        poses.append(m[:3].reshape(-1))
    np.savetxt(os.path.join(gt_dir, f"{seq}.txt"), np.asarray(poses))


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("out")
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--seq", default="09")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    make_raw(os.path.join(args.out, "raw"), args.height, args.width, args.frames)
    make_depth_test(os.path.join(args.out, "depth_test"), args.height,
                    args.width, max(4, args.frames // 3))
    make_odom(os.path.join(args.out, "odom"), args.height, args.width,
              args.frames, args.seq)
    print(f"smoke KITTI tree ready under {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
