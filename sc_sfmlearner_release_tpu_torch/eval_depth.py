"""Offline depth evaluation CLI of the port (host only, numpy and torch on
the CPU).

    python -m sc_sfmlearner_release_tpu_torch.eval_depth --dataset kitti \\
        --pred_depth OUT/predictions.npy --gt_depth GT_DIR [--vis_dir V --img_dir I]

The counterpart of the repository's ``eval_depth.py``, with the same flags
and the same printed table: loads ``predictions.npy`` and the ground truth,
resizes each prediction to the ground truth's size in the inverse-depth
domain (``resize_linear``, OpenCV's ``INTER_LINEAR``), applies the depth
range mask (and the Garg crop for KITTI), per-image median scaling and the
clamps, and prints the KITTI (7) or NYU (6) metrics and the scaling-ratio
statistics. ``--vis_dir`` writes side-by-side PNGs (``magma``).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch

from .data.image_io import read_png, resize_linear, write_png
from .utils import depth_visualizer


def build_parser():
    p = argparse.ArgumentParser(description="Depth evaluation options")
    p.add_argument("--dataset", required=True, choices=["nyu", "kitti"])
    p.add_argument("--pred_depth", required=True, help="depth predictions npy")
    p.add_argument("--gt_depth", required=True,
                   help="gt depth npy (nyu) or folder of per-image .npy (kitti)")
    p.add_argument("--vis_dir", help="directory for saving visualizations")
    p.add_argument("--img_dir", help="image directory for visualization")
    p.add_argument("--ratio_name", help="file to save median-scaling ratios")
    return p


def _resize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` of an ``[H, W]`` or ``[H, W,
    C]`` float array, on the CPU."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    out = resize_linear(x.reshape(x.shape[:2] + (-1,)), height, width)
    return out.reshape((height, width) + img.shape[2:]).numpy()


def compute_depth_errors(gt: np.ndarray, pred: np.ndarray, dataset: str):
    """Flat-array metrics (reference: eval_depth.py:32-56)."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25**2).mean()
    a3 = (thresh < 1.25**3).mean()

    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    log10 = np.mean(np.abs(np.log10(gt) - np.log10(pred)))
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean((gt - pred) ** 2 / gt)

    if dataset == "nyu":
        return abs_rel, log10, rmse, a1, a2, a3
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def evaluate_depth(gt_depths, pred_depths, dataset: str, eval_mono: bool = True,
                   ratio_name=None):
    """Full eval flow (reference: eval_depth.py:159-227). Returns
    (mean_errors, resized_pred_depths)."""
    min_depth = 1e-3
    max_depth = 10.0 if dataset == "nyu" else 80.0

    errors, ratios, resized = [], [], []
    for i in range(len(pred_depths)):
        if pred_depths[i].mean() == -1:
            continue
        gt = np.asarray(gt_depths[i], np.float32)
        gh, gw = gt.shape[:2]

        inv = 1.0 / (pred_depths[i] + 1e-6)
        inv = _resize(inv, gh, gw)
        pred = 1.0 / (inv + 1e-6)

        mask = np.logical_and(gt > min_depth, gt < max_depth)
        if dataset == "kitti":
            crop = np.array(
                [0.40810811 * gh, 0.99189189 * gh, 0.03594771 * gw, 0.96405229 * gw]
            ).astype(np.int32)
            crop_mask = np.zeros_like(mask)
            crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = 1
            mask = np.logical_and(mask, crop_mask)

        val_pred = pred[mask]
        val_gt = gt[mask]

        ratio = 1.0
        if eval_mono:
            ratio = np.median(val_gt) / np.median(val_pred)
            ratios.append(ratio)
            val_pred = val_pred * ratio
        resized.append(pred * ratio)

        val_pred = np.clip(val_pred, min_depth, max_depth)
        errors.append(compute_depth_errors(val_gt, val_pred, dataset))

    if eval_mono and ratios:
        r = np.asarray(ratios)
        med = np.median(r)
        print(f" Scaling ratios | med: {med:0.3f} | std: {np.std(r / med):0.3f}")
        print(f" Scaling ratios | mean: {r.mean():0.3f} +- std: {r.std():0.3f}")
        if ratio_name:
            np.savetxt(ratio_name, r, fmt="%.4f")

    mean_errors = np.asarray(errors).mean(0)
    if dataset == "nyu":
        names = ["abs_rel", "log10", "rmse", "a1", "a2", "a3"]
    else:
        names = ["abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3"]
    print("\n  " + ("{:>8} | " * len(names)).format(*names))
    print(("&{: 8.3f}  " * len(names)).format(*mean_errors.tolist()) + "\\\\")
    return mean_errors, resized


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    pred_depths = np.load(args.pred_depth)
    if args.dataset == "nyu":
        gt_depths = np.load(args.gt_depth)
    else:
        gt_depths = [
            np.load(f) for f in sorted(glob.glob(os.path.join(args.gt_depth, "*.npy")))
        ]

    _, resized = evaluate_depth(
        gt_depths, pred_depths, args.dataset, eval_mono=True,
        ratio_name=args.ratio_name,
    )

    if args.vis_dir:
        _save_visualizations(args, resized, gt_depths)
    return 0


def _save_visualizations(args, pred_depths, gt_depths):
    save_folder = os.path.join(args.vis_dir, "vis_depth")
    os.makedirs(save_folder, exist_ok=True)
    image_paths = sorted(glob.glob(os.path.join(args.img_dir, "*.png")))

    for i in range(len(pred_depths)):
        img = read_png(image_paths[i])
        h, w = img.shape[:2]
        if args.dataset == "nyu":
            cat = np.zeros((h, 3 * w, 3), np.uint8)
            cat[:, :w] = img
            cat[:, w:2 * w] = depth_visualizer(pred_depths[i], "magma")
            cat[:, 2 * w:] = depth_visualizer(np.asarray(gt_depths[i]), "magma")
        else:
            cat = np.zeros((2 * h, w, 3), np.uint8)
            cat[:h] = img
            vis = depth_visualizer(pred_depths[i], "magma")
            cat[h:] = np.clip(np.rint(_resize(vis, h, w)), 0, 255)
        write_png(os.path.join(save_folder, f"{i:04}.png"), cat)


if __name__ == "__main__":
    sys.exit(main())
