"""Full-sequence visual odometry of the port: PoseNet frame to frame over a
KITTI odometry sequence, chained into a global trajectory, written as
KITTI-format ``<seq>.txt`` for ``eval_odom``.

    python -m sc_sfmlearner_release_tpu_torch.test_vo --pretrained-posenet \\
        exp_pose_model_best.pth.tar --dataset-dir KITTI_ODOM/sequences \\
        --output-dir OUT --sequence 09 [--device cuda|cpu] [--precision bf16|fp32]

The counterpart of the repository's ``test_vo.py``, with the same flags
plus ``--device`` and ``--precision``: consecutive pairs run in fixed-size
batches (the final batch padded) through PoseNet and ``pose_vec2mat`` on
the device, each frame decoded once; the float64 chain stays on the host.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch

from . import cli_device
from .inference import (
    add_device_flags, load_normalized, make_pose_inference_fn, restore_pose_state,
)
from .models import PoseNet
from .test_pose import chain


def build_parser():
    p = argparse.ArgumentParser(
        description="Script for visualizing depth map and masks",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--pretrained-posenet", required=True, type=str,
                   help="pretrained PoseNet path (.msgpack or torch .pth.tar)")
    p.add_argument("--img-height", default=256, type=int)
    p.add_argument("--img-width", default=832, type=int)
    p.add_argument("--no-resize", action="store_true")
    p.add_argument("--dataset-dir", type=str)
    p.add_argument("--output-dir", type=str)
    p.add_argument("--img-exts", default=["png", "jpg", "bmp"], nargs="*")
    p.add_argument("--rotation-mode", default="euler", choices=["euler", "quat"])
    p.add_argument("--sequence", default="09", type=str)
    p.add_argument("--batch-size", default=16, type=int)
    add_device_flags(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = cli_device(args.device)

    pose_net = PoseNet(18)
    pose_net.load_state_dict(restore_pose_state(args.pretrained_posenet))
    infer_pairs = make_pose_inference_fn(pose_net, device, args.precision, args.rotation_mode)

    image_dir = os.path.join(args.dataset_dir, args.sequence, "image_2")
    test_files = sorted(
        sum((glob.glob(os.path.join(image_dir, f"*.{ext}")) for ext in args.img_exts), [])
    )
    print(f"{len(test_files)} files to test")
    os.makedirs(args.output_dir, exist_ok=True)

    h, w = (None, None) if args.no_resize else (args.img_height, args.img_width)
    n, bs = len(test_files), args.batch_size
    mats = []
    prev = load_normalized(test_files[0], h, w, device)
    for start in range(0, n - 1, bs):
        frames = [prev] + [load_normalized(test_files[i + 1], h, w, device)
                           for i in range(start, min(start + bs, n - 1))]
        prev = frames[-1]
        n_valid = len(frames) - 1
        stack = torch.stack(frames)
        # Pairs i -> i+1; a final short batch is padded with its last pair.
        idx = torch.arange(bs).clamp(max=n_valid - 1)
        mats.append(infer_pairs(stack[idx], stack[idx + 1])[:n_valid].cpu().numpy())

    poses = chain(np.concatenate(mats, axis=0)).reshape(-1, 12)
    filename = os.path.join(args.output_dir, f"{args.sequence}.txt")
    np.savetxt(filename, poses, delimiter=" ", fmt="%1.8e")
    print(f"=> wrote {filename}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
