"""KITTI odometry evaluation CLI of the port (host only, numpy).

    python -m sc_sfmlearner_release_tpu_torch.eval_odom --result OUT \\
        --align 7dof [--seqs 9] [--gt_dir DIR] [--no-confirm] [--no-plot]

The counterpart of the repository's ``kitti_eval/eval_odom.py``, with the
same flags: evaluates the KITTI-format trajectory files in ``--result``
against the ground truth in ``--gt_dir`` with the devkit's protocol
(per-length t/r errors, ATE, RPE), writing ``result.txt``, ``errors/`` and
(unless ``--no-plot``; needs matplotlib) PDF plots under the result
directory. ``--gt_dir`` defaults to the repository's ``kitti_eval/gt_poses``
(sequences 00-10), found beside the package.
"""

from __future__ import annotations

import argparse
import os
import sys

from .evaluation import KittiOdomEvaluator

GT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "kitti_eval", "gt_poses")


def build_parser():
    p = argparse.ArgumentParser(description="KITTI evaluation")
    p.add_argument("--result", type=str, required=True,
                   help="Result directory containing NN.txt trajectories")
    p.add_argument("--gt_dir", type=str, default=GT_DIR,
                   help="Directory of ground-truth poses NN.txt "
                        "(default: the repository's kitti_eval/gt_poses)")
    p.add_argument("--align", type=str, default=None,
                   choices=["scale", "scale_7dof", "7dof", "6dof"],
                   help="alignment type")
    p.add_argument("--seqs", nargs="+", type=int, default=None,
                   help="sequences to be evaluated (all found if unset)")
    p.add_argument("--no-confirm", action="store_true",
                   help="skip the interactive confirmation")
    p.add_argument("--no-plot", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.no_confirm:
        continue_flag = input(f"Evaluate result in {args.result}? [y/n]")
        if continue_flag.strip().lower() != "y":
            print("Double check the path!")
            return 1

    KittiOdomEvaluator().eval(
        args.gt_dir, args.result, alignment=args.align, seqs=args.seqs,
        plot=not args.no_plot,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
