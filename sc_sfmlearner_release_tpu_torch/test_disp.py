"""Depth inference CLI of the port: run DispNet over a test list, save
``predictions.npy`` of depths = 1/disp.

    python -m sc_sfmlearner_release_tpu_torch.test_disp \\
        --pretrained-dispnet dispnet_model_best.pth.tar --resnet-layers 18 \\
        --dataset-dir DIR --output-dir OUT [--device cuda|cpu] [--precision bf16|fp32]

The counterpart of the repository's ``test_disp.py``: the same flags, plus
``--device`` (default ``cuda``; it exits with an error without a card) and
``--precision`` (default ``bf16`` convolutions). Frames are stacked into
fixed-shape batches (the last one padded); inference goes through
``training.make_inference_fn``. Each batch after the first is timed around
the call and the copy of its result to the host, and the average per frame
is printed as ``Avg Time`` and ``Avg Speed``.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np

from . import cli_device
from .inference import add_device_flags, batched, restore_disp_state
from .models import DispNet
from .training import make_inference_fn


def build_parser():
    p = argparse.ArgumentParser(
        description="Script for DispNet testing with corresponding groundTruth",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--pretrained-dispnet", required=True, type=str,
                   help="pretrained DispNet path (.msgpack or torch .pth.tar)")
    p.add_argument("--img-height", default=256, type=int)
    p.add_argument("--img-width", default=832, type=int)
    p.add_argument("--min-depth", default=1e-3, type=float)
    p.add_argument("--max-depth", default=80, type=float)
    p.add_argument("--dataset-dir", default=".", type=str)
    p.add_argument("--dataset-list", default=None, type=str)
    p.add_argument("--output-dir", required=True, type=str)
    p.add_argument("--resnet-layers", required=True, type=int, choices=[18, 50])
    p.add_argument("--batch-size", default=8, type=int)
    add_device_flags(p)
    return p


def list_files(dataset_dir: str, dataset_list) -> list:
    """The test files: the list's lines (relative ones under ``dataset_dir``
    unless they exist as given), else every ``*.png`` of ``dataset_dir``."""
    if dataset_list is None:
        return sorted(glob.glob(os.path.join(dataset_dir, "*.png")))
    with open(dataset_list) as f:
        return [line if os.path.isabs(line) or os.path.exists(line)
                else os.path.join(dataset_dir, line)
                for line in f.read().splitlines() if line]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = cli_device(args.device)

    disp_net = DispNet(args.resnet_layers)
    disp_net.load_state_dict(restore_disp_state(args.pretrained_dispnet, args.resnet_layers))
    infer = make_inference_fn(disp_net, device, args.precision)

    test_files = list_files(args.dataset_dir, args.dataset_list)
    print(f"{len(test_files)} files to test")
    os.makedirs(args.output_dir, exist_ok=True)

    predictions = np.zeros((len(test_files), args.img_height, args.img_width), np.float32)
    total_time, timed_frames, j = 0.0, 0, 0
    for batch, n_valid in batched(test_files, args.batch_size, args.img_height,
                                  args.img_width, device):
        t0 = time.perf_counter()
        _, depth = infer(batch)
        depth = depth[:n_valid, ..., 0].cpu().numpy()
        elapsed = time.perf_counter() - t0
        if j > 0:  # the first batch warms up (cuDNN's algorithm search)
            total_time += elapsed
            timed_frames += n_valid
        predictions[j:j + n_valid] = depth
        j += n_valid

    np.save(os.path.join(args.output_dir, "predictions.npy"), predictions)
    if timed_frames:
        avg = total_time / timed_frames
        print("Avg Time: ", avg, " seconds.")
        print("Avg Speed: ", 1.0 / avg, " fps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
