"""Batch disparity/depth visualization dump of the port.

    python -m sc_sfmlearner_release_tpu_torch.run_inference --pretrained \\
        dispnet_model_best.pth.tar --resnet-layers 18 --dataset-dir DIR \\
        --output-dir OUT --output-disp --output-depth [--device cuda|cpu]

The counterpart of the repository's ``run_inference.py``: colormapped
disparity (``bone``) and/or depth (``rainbow``, max 10) images for every
input file, named ``<relpath-with-dashes>_disp.<ext>`` / ``_depth.<ext>``,
with the same flags plus ``--device`` and ``--precision``. PNGs are written
by ``data/image_io.py::write_png``; other extensions need ``imageio``.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from . import cli_device
from .inference import add_device_flags, batched, restore_disp_state, write_image
from .models import DispNet
from .training import make_inference_fn
from .utils import tensor2array


def build_parser():
    p = argparse.ArgumentParser(
        description="Inference script for DispNet learned with Structure "
        "from Motion Learner inference on KITTI Dataset",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--output-disp", action="store_true", help="save disparity img")
    p.add_argument("--output-depth", action="store_true", help="save depth img")
    p.add_argument("--pretrained", required=True, type=str,
                   help="pretrained DispNet path (.msgpack or torch .pth.tar)")
    p.add_argument("--img-height", default=256, type=int)
    p.add_argument("--img-width", default=832, type=int)
    p.add_argument("--no-resize", action="store_true")
    p.add_argument("--dataset-list", default=None, type=str)
    p.add_argument("--dataset-dir", default=".", type=str)
    p.add_argument("--output-dir", default="output", type=str)
    p.add_argument("--img-exts", default=["png", "jpg", "bmp"], nargs="*")
    p.add_argument("--resnet-layers", required=True, type=int, choices=[18, 50])
    p.add_argument("--batch-size", default=8, type=int)
    add_device_flags(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (args.output_disp or args.output_depth):
        print("You must at least output one value !")
        return 1
    device = cli_device(args.device)

    disp_net = DispNet(args.resnet_layers)
    disp_net.load_state_dict(restore_disp_state(args.pretrained, args.resnet_layers))
    infer = make_inference_fn(disp_net, device, args.precision)

    if args.dataset_list is not None:
        with open(args.dataset_list) as f:
            test_files = [
                os.path.join(args.dataset_dir, line)
                for line in f.read().splitlines() if line
            ]
    else:
        test_files = sorted(
            sum((glob.glob(os.path.join(args.dataset_dir, f"*.{ext}"))
                 for ext in args.img_exts), [])
        )
    print(f"{len(test_files)} files to test")
    os.makedirs(args.output_dir, exist_ok=True)

    j = 0
    for batch, n_valid in batched(test_files, args.batch_size, args.img_height,
                                  args.img_width, device):
        disps = infer(batch)[0][:n_valid, ..., 0].cpu().numpy()
        for disp in disps:
            rel = os.path.relpath(test_files[j], args.dataset_dir)
            stem, ext = os.path.splitext(rel)
            name = "-".join(stem.split(os.sep))
            if args.output_disp:
                vis = 255 * tensor2array(disp, max_value=None, colormap="bone")
                write_image(os.path.join(args.output_dir, f"{name}_disp{ext}"),
                            vis.astype(np.uint8))
            if args.output_depth:
                vis = 255 * tensor2array(1.0 / disp, max_value=10, colormap="rainbow")
                write_image(os.path.join(args.output_dir, f"{name}_depth{ext}"),
                            vis.astype(np.uint8))
            j += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
