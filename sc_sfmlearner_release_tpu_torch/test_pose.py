"""PoseNet 5-frame snippet evaluation on KITTI odometry, in the port.

    python -m sc_sfmlearner_release_tpu_torch.test_pose exp_pose_model_best.pth.tar \\
        --dataset-dir KITTI_ODOM --sequences 09 [--output-dir OUT] [--device cuda|cpu]

The counterpart of the repository's ``test_pose.py``, with the same flags
plus ``--device`` and ``--precision``: for each snippet the L-1 consecutive
pairwise poses run as one batched PoseNet call (ResNet-18, eval mode) and
``pose_vec2mat`` on the device; the float64 chain into a trajectory and
its comparison with the first-frame-compensated ground truth
(least-squares-scaled ATE, mean residual angle RE) run on the host.
Snippets overlap, so each frame is decoded once and kept while a snippet
still holds it.
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


def build_parser():
    p = argparse.ArgumentParser(
        description="Script for PoseNet testing with corresponding groundTruth "
        "from KITTI Odometry",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("pretrained_posenet", type=str,
                   help="pretrained PoseNet path (.msgpack or torch .pth.tar)")
    p.add_argument("--img-height", default=256, type=int)
    p.add_argument("--img-width", default=832, type=int)
    p.add_argument("--no-resize", action="store_true")
    # accepted for reference-CLI compatibility; the reference declares them
    # without reading them
    p.add_argument("--min-depth", default=1e-3, type=float)
    p.add_argument("--max-depth", default=80, type=float)
    p.add_argument("--dataset-dir", type=str)
    p.add_argument("--sequence-length", type=int, default=5)
    p.add_argument("--sequences", default=["09"], type=str, nargs="*")
    p.add_argument("--output-dir", default=None, type=str)
    p.add_argument("--img-exts", default=["png", "jpg", "bmp"], nargs="*")
    p.add_argument("--rotation-mode", default="euler", choices=["euler", "quat"])
    add_device_flags(p)
    return p


def read_scene_data(data_root, sequence_set, seq_length=3, step=1):
    """Snippet index windows + GT poses per sequence (reference:
    kitti_eval/pose_evaluation_utils.py:36-59)."""
    im_sequences, poses_sequences, indices_sequences = [], [], []
    demi = (seq_length - 1) // 2
    shift_range = np.arange(-demi, demi + 1).reshape(1, -1) * step

    seq_dirs = []
    for seq in sequence_set:
        seq_dirs += sorted(glob.glob(os.path.join(data_root, "sequences", seq)))
    print(f"getting test metadata for these sequences : {seq_dirs}")
    for seq_dir in seq_dirs:
        name = os.path.basename(seq_dir.rstrip("/"))
        poses = (
            np.genfromtxt(os.path.join(data_root, "poses", f"{name}.txt"))
            .astype(np.float64).reshape(-1, 3, 4)
        )
        imgs = sorted(glob.glob(os.path.join(seq_dir, "image_2", "*.png")))
        tgt_indices = np.arange(demi, len(imgs) - demi).reshape(-1, 1)
        im_sequences.append(imgs)
        poses_sequences.append(poses)
        indices_sequences.append(shift_range + tgt_indices)
    return im_sequences, poses_sequences, indices_sequences


def snippets(data_root, sequences, seq_length):
    """Yield {'imgs': paths, 'poses': first-frame-compensated GT [L,3,4]}."""
    img_seqs, pose_seqs, index_seqs = read_scene_data(data_root, sequences, seq_length)
    for imgs, poses, indices in zip(img_seqs, pose_seqs, index_seqs):
        for snippet in indices:
            pose_snip = np.stack([poses[i] for i in snippet])
            first = pose_snip[0]
            pose_snip[:, :, -1] -= first[:, -1]
            compensated = np.linalg.inv(first[:, :3]) @ pose_snip
            yield {"imgs": [imgs[i] for i in snippet], "poses": compensated}


def compute_pose_error(gt, pred):
    """5-point ATE with LSE scale + mean residual rotation angle
    (reference: test_pose.py:98-113)."""
    snippet_length = gt.shape[0]
    scale = np.sum(gt[:, :, -1] * pred[:, :, -1]) / np.sum(pred[:, :, -1] ** 2)
    ate = np.linalg.norm((gt[:, :, -1] - scale * pred[:, :, -1]).reshape(-1))
    re = 0.0
    for gt_pose, pred_pose in zip(gt, pred):
        r = gt_pose[:, :3] @ np.linalg.inv(pred_pose[:, :3])
        s = np.linalg.norm([r[0, 1] - r[1, 0], r[1, 2] - r[2, 1], r[0, 2] - r[2, 0]])
        c = np.trace(r) - 1
        re += np.arctan2(s, c)
    return ate / snippet_length, re / snippet_length


def chain(mats: np.ndarray) -> np.ndarray:
    """``[P, 3, 4]`` pairwise transforms -> ``[P+1, 3, 4]`` global poses,
    float64, starting at the identity (reference: test_vo.py:85-90)."""
    global_pose = np.eye(4)
    poses = [global_pose[0:3, :].copy()]
    for m in mats:
        global_pose = global_pose @ np.linalg.inv(np.vstack([m, [0, 0, 0, 1]]))
        poses.append(global_pose[0:3, :].copy())
    return np.stack(poses)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = cli_device(args.device)

    pose_net = PoseNet(18)
    pose_net.load_state_dict(restore_pose_state(args.pretrained_posenet))
    infer_pairs = make_pose_inference_fn(pose_net, device, args.precision, args.rotation_mode)

    seq_length = args.sequence_length
    all_snips = list(snippets(args.dataset_dir, args.sequences, seq_length))
    print(f"{len(all_snips)} snippets to test")
    errors = np.zeros((len(all_snips), 2), np.float32)
    predictions_array = (
        np.zeros((len(all_snips), seq_length, 3, 4)) if args.output_dir else None
    )

    h, w = (None, None) if args.no_resize else (args.img_height, args.img_width)
    frames = {}
    for j, sample in enumerate(all_snips):
        frames = {p: frames[p] if p in frames else load_normalized(p, h, w, device)
                  for p in sample["imgs"]}
        stack = torch.stack([frames[p] for p in sample["imgs"]])
        # ONE batched call for the snippet's L-1 consecutive pairs.
        final_poses = chain(infer_pairs(stack[:-1], stack[1:]).cpu().numpy())
        if predictions_array is not None:
            predictions_array[j] = final_poses
        errors[j] = compute_pose_error(sample["poses"], final_poses)

    mean_errors = errors.mean(0)
    std_errors = errors.std(0)
    print("")
    print("Results")
    print("\t {:>10}, {:>10}".format("ATE", "RE"))
    print("mean \t {:10.4f}, {:10.4f}".format(*mean_errors))
    print("std \t {:10.4f}, {:10.4f}".format(*std_errors))

    if args.output_dir is not None:
        os.makedirs(args.output_dir, exist_ok=True)
        np.save(os.path.join(args.output_dir, "predictions.npy"), predictions_array)
    return 0


if __name__ == "__main__":
    sys.exit(main())
