"""Port losses against the JAX package (CPU): the bidirectional photometric
and geometry loss over a B=4, N=2 snippet at 64x96 (where the masked means
clear the reference's 10000-element guard), with JAX's torch-exact
``gather`` sampler, and the edge-aware smoothness. Tolerance rel 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu.ops import losses as jl
from sc_sfmlearner_release_tpu_torch.ops import losses as tl
from sc_sfmlearner_release_tpu_torch.ops.ssim import ssim_nchw
from sc_sfmlearner_release_tpu_torch.ops.warp import warp_sample

B, N, H, W = 4, 2, 64, 96
RTOL = 1e-5


def _snippet(seed, num_scales=1):
    rng = np.random.RandomState(seed)
    tgt = rng.rand(B, H, W, 3).astype(np.float32)
    refs = rng.rand(B, N, H, W, 3).astype(np.float32)
    k = np.array([[50.0, 0, W / 2], [0, 55.0, H / 2], [0, 0, 1]], np.float32)
    intr = np.broadcast_to(k, (B, 3, 3)).copy()
    tgt_depth = [rng.uniform(1.0, 10.0, (B, H >> s, W >> s, 1)).astype(np.float32)
                 for s in range(num_scales)]
    ref_depths = [rng.uniform(1.0, 10.0, (B, N, H >> s, W >> s, 1)).astype(np.float32)
                  for s in range(num_scales)]
    scale = np.array([0.1, 0.1, 0.1, 0.02, 0.02, 0.02], np.float32)
    poses = (rng.randn(B, N, 6) * scale).astype(np.float32)
    poses_inv = (rng.randn(B, N, 6) * scale).astype(np.float32)
    return tgt, refs, intr, tgt_depth, ref_depths, poses, poses_inv


def _both(args, **kw):
    tgt, refs, intr, tgt_depth, ref_depths, poses, poses_inv = args
    j = lambda a: jnp.asarray(a)
    t = lambda a: torch.from_numpy(a)
    sm = kw.pop("sample_mask", None)
    ref = jl.photo_and_geometry_loss(
        j(tgt), j(refs), j(intr), [j(d) for d in tgt_depth], [j(d) for d in ref_depths],
        j(poses), j(poses_inv), sampler="gather",
        sample_mask=None if sm is None else j(sm), **kw)
    got = tl.photo_and_geometry_loss(
        t(tgt), t(refs), t(intr), [t(d) for d in tgt_depth], [t(d) for d in ref_depths],
        t(poses), t(poses_inv), sample_mask=None if sm is None else t(sm), **kw)
    return [float(a) for a in got], [float(a) for a in ref]


@pytest.mark.parametrize(
    "with_ssim,with_mask,with_auto_mask,padding_mode",
    [
        (True, True, False, "zeros"),
        (True, True, True, "zeros"),
        (False, False, True, "border"),
        (True, False, False, "border"),
        (False, True, False, "zeros"),
    ],
)
def test_photo_and_geometry_loss_matches_jax(with_ssim, with_mask, with_auto_mask, padding_mode):
    launches = (warp_sample.launches, ssim_nchw.launches)
    got, ref = _both(_snippet(0), with_ssim=with_ssim, with_mask=with_mask,
                     with_auto_mask=with_auto_mask, padding_mode=padding_mode)
    assert (warp_sample.launches, ssim_nchw.launches) == launches
    assert ref[0] > 0.0 and ref[1] > 0.0
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_multiscale_loss_matches_jax():
    got, ref = _both(_snippet(1, num_scales=3), num_scales=3)
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_sample_mask_matches_jax():
    got, ref = _both(_snippet(2), sample_mask=np.array([1, 1, 1, 0], np.float32))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


@pytest.mark.parametrize("sample_mask", [None, np.array([1, 0, 1, 1], np.float32)])
def test_smooth_loss_matches_jax(sample_mask):
    tgt, refs, _, tgt_depth, ref_depths, _, _ = _snippet(3)
    ref = jl.smooth_loss([jnp.asarray(tgt_depth[0])], jnp.asarray(tgt),
                         [jnp.asarray(ref_depths[0])], jnp.asarray(refs),
                         None if sample_mask is None else jnp.asarray(sample_mask))
    got = tl.smooth_loss([torch.from_numpy(tgt_depth[0])], torch.from_numpy(tgt),
                         [torch.from_numpy(ref_depths[0])], torch.from_numpy(refs),
                         None if sample_mask is None else torch.from_numpy(sample_mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


@pytest.mark.parametrize("valid_px", [100, 5000])
def test_mean_on_mask_guard_matches_jax(valid_px):
    rng = np.random.RandomState(4)
    diff = rng.rand(2, 60, 60, 3).astype(np.float32)
    mask = np.zeros((2, 60, 60, 1), np.float32)
    mask.reshape(-1)[:valid_px] = 1.0  # 3 * valid_px elements after broadcast
    ref = float(jl.mean_on_mask(jnp.asarray(diff), jnp.asarray(mask)))
    got = float(tl.mean_on_mask(torch.from_numpy(diff), torch.from_numpy(mask)))
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    assert (ref == 0.0) == (3 * valid_px <= 10000)


@pytest.mark.parametrize("size", [(16, 24), (21, 35)])
def test_upsample_nearest_matches_jax(size):
    x = np.random.RandomState(5).rand(2, 8, 12, 1).astype(np.float32)
    ref = jl._upsample_nearest(jnp.asarray(x), *size)
    got = tl._upsample_nearest(torch.from_numpy(x), *size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
