"""SC-Depth losses over a snippet, with all 2N directed pairs in one batch.

The counterpart of the JAX package's ``ops/losses.py``:

  * photometric: 0.15 * L1 + 0.85 * SSIM of the warped source against the
    target, masked by warp validity (and optionally the auto-mask),
    weighted by the self-discovered mask ``1 - diff_depth``;
  * geometry consistency: normalized disagreement between the transformed
    target depth and the sampled source depth;
  * smoothness: edge-aware first-order smoothness of mean-normalized depth.

Pairs fold into the batch in JAX's group order: group g < N is
(target = tgt, source = ref_g), group g >= N the reverse. Each scale costs
one ``inverse_warp2`` (one warp-kernel launch) and one SSIM-kernel launch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .geometry import inverse_warp2
from .ssim import ssim_nchw

# The reference trusts a masked mean only when the valid region holds more
# than 10000 elements (after the channel broadcast).
MIN_MASK_SUM = 10000.0


def mean_on_mask(diff: torch.Tensor, valid_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean of ``diff`` ``[..., C]`` under ``valid_mask`` ``[..., 1]``;
    0 when the mask covers no more than 10000 elements."""
    mask = valid_mask.expand_as(diff)
    mask_sum = mask.sum()
    mean = (diff * mask).sum() / torch.clamp(mask_sum, min=1.0)
    return torch.where(mask_sum > MIN_MASK_SUM, mean, torch.zeros_like(mean))


def _grouped_mean_on_mask(diff: torch.Tensor, valid_mask: torch.Tensor) -> torch.Tensor:
    """Per-group masked mean: ``diff`` ``[G, B, ...]`` -> ``[G]``."""
    mask = valid_mask.expand_as(diff)
    g = diff.shape[0]
    d2 = diff.reshape(g, -1)
    m2 = mask.reshape(g, -1)
    mask_sum = m2.sum(dim=1)
    mean = (d2 * m2).sum(dim=1) / torch.clamp(mask_sum, min=1.0)
    return torch.where(mask_sum > MIN_MASK_SUM, mean, torch.zeros_like(mean))


def _upsample_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest resize of ``[B, h0, w0, C]`` to ``[B, h, w, C]`` with
    ``jax.image.resize``'s source index ``floor((i + 0.5) * in / out)``."""
    h0, w0 = x.shape[1], x.shape[2]
    if (h0, w0) == (h, w):
        return x

    def index(n_in: int, n_out: int) -> torch.Tensor:
        i = torch.arange(n_out, dtype=torch.float32, device=x.device)
        return torch.floor((i + 0.5) * n_in / n_out).to(torch.int64)

    return x[:, index(h0, h)][:, :, index(w0, w)]


def photo_and_geometry_loss(
    tgt_img: torch.Tensor,
    ref_imgs: torch.Tensor,
    intrinsics: torch.Tensor,
    tgt_depth: Sequence[torch.Tensor],
    ref_depths: Sequence[torch.Tensor],
    poses: torch.Tensor,
    poses_inv: torch.Tensor,
    num_scales: int = 1,
    with_ssim: bool = True,
    with_mask: bool = True,
    with_auto_mask: bool = False,
    padding_mode: str = "zeros",
    sample_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional photometric and geometry-consistency loss of a snippet.

    Args:
      tgt_img: ``[B, H, W, 3]`` target frame.
      ref_imgs: ``[B, N, H, W, 3]`` reference frames.
      intrinsics: ``[B, 3, 3]``.
      tgt_depth: per-scale ``[B, h_s, w_s, 1]`` target depths.
      ref_depths: per-scale ``[B, N, h_s, w_s, 1]`` reference depths.
      poses: ``[B, N, 6]`` target -> ref; ``poses_inv``: ref -> target.
      sample_mask: optional ``[B]`` 0/1 weights; a sample of weight 0 leaves
        every masked mean as if the batch had been smaller.

    Returns (photo_loss, geometry_loss), summed over pairs and scales.
    """
    b, n = ref_imgs.shape[0], ref_imgs.shape[1]
    h, w = tgt_img.shape[1], tgt_img.shape[2]
    scales = min(len(tgt_depth), num_scales)

    def flatten_pairs(tgt_x, ref_x):
        """The ``[2N*B, ...]`` directed-pair batch (target side, source side)."""
        tgt_rep = tgt_x[:, None].expand((b, n) + tgt_x.shape[1:])
        tgt_side = torch.cat([tgt_rep, ref_x], dim=1)  # [B, 2N, ...]
        src_side = torch.cat([ref_x, tgt_rep], dim=1)
        flat = lambda a: a.transpose(0, 1).reshape((2 * n * b,) + a.shape[2:])
        return flat(tgt_side), flat(src_side)

    tgt_imgs_f, src_imgs_f = flatten_pairs(tgt_img, ref_imgs)
    poses_all = torch.cat([poses, poses_inv], dim=1)  # [B, 2N, 6]
    poses_f = poses_all.transpose(0, 1).reshape(2 * n * b, 6)
    intr_f = intrinsics[None].expand((2 * n,) + intrinsics.shape).reshape(2 * n * b, 3, 3)

    # The post-warp chain runs in NCHW, as in the JAX package.
    nchw = lambda a: a.permute(0, 3, 1, 2).contiguous()
    tgt_c = nchw(tgt_imgs_f)
    src_c = nchw(src_imgs_f) if with_auto_mask else None
    group = lambda a: a.reshape((2 * n, b) + a.shape[1:])

    photo_total = torch.zeros((), dtype=tgt_img.dtype, device=tgt_img.device)
    geom_total = torch.zeros((), dtype=tgt_img.dtype, device=tgt_img.device)
    for s in range(scales):
        tgt_d = _upsample_nearest(tgt_depth[s], h, w)
        ref_d = ref_depths[s]
        ref_d = ref_d.reshape((b * n,) + ref_d.shape[2:])
        ref_d = _upsample_nearest(ref_d, h, w).reshape(b, n, h, w, 1)
        tgt_d_f, src_d_f = flatten_pairs(tgt_d, ref_d)

        warped, valid, projected_depth, computed_depth = inverse_warp2(
            src_imgs_f, tgt_d_f, src_d_f, poses_f, intr_f, padding_mode
        )
        warped_c = nchw(warped)
        valid_c = valid.permute(0, 3, 1, 2)  # [F, 1, H, W]
        if sample_mask is not None:
            # Pair f = g*B + i holds sample i.
            valid_c = valid_c * sample_mask.to(valid_c.dtype).repeat(2 * n)[:, None, None, None]

        diff_img = torch.clamp((tgt_c - warped_c).abs(), 0.0, 1.0)
        diff_depth = torch.clamp(
            (computed_depth - projected_depth).abs() / (computed_depth + projected_depth),
            0.0, 1.0,
        )[..., 0][:, None]  # [F, 1, H, W]

        if with_auto_mask:
            warped_err = diff_img.mean(dim=1, keepdim=True)
            static_err = (tgt_c - src_c).abs().mean(dim=1, keepdim=True)
            valid_c = (warped_err < static_err).to(valid_c.dtype) * valid_c

        if with_ssim:
            diff_img = 0.15 * diff_img + 0.85 * ssim_nchw(tgt_c, warped_c)

        if with_mask:
            diff_img = diff_img * (1.0 - diff_depth)

        photo_total = photo_total + _grouped_mean_on_mask(group(diff_img), group(valid_c)).sum()
        geom_total = geom_total + _grouped_mean_on_mask(group(diff_depth), group(valid_c)).sum()

    return photo_total, geom_total


def _sample_mean(x: torch.Tensor, sample_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over ``[B, ...]`` restricted to samples of weight 1."""
    if sample_mask is None:
        return x.mean()
    wgt = sample_mask.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
    per_sample = x.numel() // x.shape[0]
    return (x * wgt).sum() / (torch.clamp(wgt.sum(), min=1.0) * per_sample)


def _smooth_one(
    depth: torch.Tensor, img: torch.Tensor, sample_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Edge-aware smoothness of one frame group ``[B, H, W, 1]`` -> scalar."""
    mean_d = depth.mean(dim=(1, 2), keepdim=True)
    norm_d = depth / (mean_d + 1e-7)
    grad_dx = (norm_d[:, :, :-1] - norm_d[:, :, 1:]).abs()
    grad_dy = (norm_d[:, :-1] - norm_d[:, 1:]).abs()
    grad_ix = (img[:, :, :-1] - img[:, :, 1:]).abs().mean(dim=-1, keepdim=True)
    grad_iy = (img[:, :-1] - img[:, 1:]).abs().mean(dim=-1, keepdim=True)
    return _sample_mean(grad_dx * torch.exp(-grad_ix), sample_mask) + _sample_mean(
        grad_dy * torch.exp(-grad_iy), sample_mask
    )


def smooth_loss(
    tgt_depth: Sequence[torch.Tensor],
    tgt_img: torch.Tensor,
    ref_depths: Sequence[torch.Tensor],
    ref_imgs: torch.Tensor,
    sample_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scale-0 edge-aware smoothness summed over all snippet frames
    (``ref_depths[0]`` ``[B, N, H, W, 1]``, ``ref_imgs`` ``[B, N, H, W, 3]``)."""
    loss = _smooth_one(tgt_depth[0], tgt_img, sample_mask)
    ref_d = ref_depths[0]
    for i in range(ref_d.shape[1]):
        loss = loss + _smooth_one(ref_d[:, i], ref_imgs[:, i], sample_mask)
    return loss
