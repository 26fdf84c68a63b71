"""Depth evaluation metrics (KITTI Eigen / NYUv2).

The counterpart of the JAX package's ``ops/metrics.py``: per-image valid
masking (depth range and the dataset's crop), per-image median scaling, then
batch means of the error statistics. Static shapes as there: masked
reductions and a masked lower median (``torch.median``'s lower middle
element on even counts) instead of boolean indexing.

Under a process group (``parallel.distributed``) the batch means are the
global batch's: each process holds its rows of it, and the sums and the
count of valid images are summed over processes in one collective. Under
width sharding the shards of a data group hold the same whole rows (the
eval step gathers the prediction to full width): each adds them to the
sums and to the count alike, which leaves the means as they are.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..parallel import distributed

CROPS = {
    # Garg ECCV16 crop fractions (y1, y2, x1, x2) and the depth cap.
    "kitti": (0.40810811, 0.99189189, 0.03594771, 0.96405229, 80.0),
    # NYU crop.
    "nyu": (0.09375, 0.98125, 0.0640625, 0.9390625, 10.0),
}
METRIC_NAMES = ("abs_diff", "abs_rel", "sq_rel", "rmse", "rmse_log", "log10", "a1", "a2", "a3")


def crop_mask(h: int, w: int, dataset: str, device=None) -> torch.Tensor:
    y1f, y2f, x1f, x2f, _ = CROPS[dataset]
    mask = torch.zeros((h, w), dtype=torch.bool, device=device)
    mask[int(y1f * h):int(y2f * h), int(x1f * w):int(x2f * w)] = True
    return mask


def masked_median_lower(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-row lower median of ``x`` ``[B, P]`` over ``mask``: invalid
    entries sort to the end, and the element at ``(n_valid - 1) // 2`` is
    taken."""
    s, _ = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))), dim=1)
    idx = torch.clamp(mask.sum(dim=1) - 1, min=0) // 2
    return s.gather(1, idx[:, None])[:, 0]


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-row masked mean of ``[B, P]``."""
    m = mask.to(x.dtype)
    return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


def compute_depth_errors(
    gt: torch.Tensor, pred: torch.Tensor, dataset: str = "kitti",
    n_valid: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Batch depth metrics with per-image median scaling.

    ``gt`` ``[B, H, W]`` ground-truth depth (0 = missing), ``pred``
    ``[B, H, W]``. Only the first ``n_valid`` images of the global batch,
    if given, enter the batch means (the loader pads the trailing batch by
    repeating its last sample). Returns 0-d tensors named as
    :data:`METRIC_NAMES`.
    """
    if dataset not in CROPS:
        raise ValueError(f"unknown dataset: {dataset}")
    b, h, w = gt.shape
    max_depth = CROPS[dataset][4]
    crop = crop_mask(h, w, dataset, gt.device)
    valid = ((gt > 0.1) & (gt < max_depth) & crop).reshape(b, -1)
    gt_f = gt.reshape(b, -1)
    pred_f = torch.clamp(pred.reshape(b, -1), 1e-3, max_depth)

    med_gt = masked_median_lower(gt_f, valid)
    med_pred = masked_median_lower(pred_f, valid)
    scaled = pred_f * med_gt[:, None] / med_pred[:, None]

    # Invalid lanes are masked out of every mean; keep them finite.
    one = torch.ones((), dtype=gt.dtype, device=gt.device)
    safe_gt = torch.where(valid, gt_f, one)
    safe_pred = torch.where(valid, scaled, one)
    thresh = torch.maximum(safe_gt / safe_pred, safe_pred / safe_gt)
    diff = (safe_gt - safe_pred).abs()

    per_image = {
        "abs_diff": _masked_mean(diff, valid),
        "abs_rel": _masked_mean(diff / safe_gt, valid),
        "sq_rel": _masked_mean(diff * diff / safe_gt, valid),
        "rmse": torch.sqrt(_masked_mean(diff * diff, valid)),
        "rmse_log": torch.sqrt(_masked_mean((torch.log(safe_gt) - torch.log(safe_pred)) ** 2,
                                            valid)),
        "log10": _masked_mean((torch.log10(safe_gt) - torch.log10(safe_pred)).abs(), valid),
        "a1": _masked_mean((thresh < 1.25).to(gt.dtype), valid),
        "a2": _masked_mean((thresh < 1.25**2).to(gt.dtype), valid),
        "a3": _masked_mean((thresh < 1.25**3).to(gt.dtype), valid),
    }
    if n_valid is None and not distributed.is_distributed():
        return {k: v.mean() for k, v in per_image.items()}
    # The sums over the valid rows of the global batch, and their count.
    valid_rows = b * distributed.data_count() if n_valid is None else int(n_valid)
    w_s = (distributed.global_rows(b, gt.device) < valid_rows).to(gt.dtype)
    sums = distributed.global_sum(
        torch.stack([(v * w_s).sum() for v in per_image.values()] + [w_s.sum()]))
    return dict(zip(per_image, (sums[:-1] / torch.clamp(sums[-1], min=1.0)).unbind()))
