"""Port SSIM against the JAX package (CPU): the XLA ``ssim_nchw`` and
``ssim``, and the Pallas kernel run in interpret mode as the JAX package's
own tests run it. Tolerance rtol 1e-5, atol 1e-6 (fp32, the 3x3 sums in
another order) on independent images.

On nearly identical images the map is ill-conditioned: the variances are
differences of nearly equal means of squares, so one rounding of a 3x3 mean
moves the map by up to a few 1e-5. There the JAX package's own Pallas
kernel lies up to 2.5e-5 from its XLA version, and the port is held to lie
no farther from the XLA version than the Pallas kernel does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu.ops.pallas_ssim import _forward as pallas_ssim_forward
from sc_sfmlearner_release_tpu.ops.ssim import ssim as jssim
from sc_sfmlearner_release_tpu.ops.ssim import ssim_nchw as jssim_nchw
from sc_sfmlearner_release_tpu_torch.ops.ssim import ssim, ssim_nchw, ssim_nchw_plain

RTOL, ATOL = 1e-5, 1e-6


def _pair(shape, seed, correlated):
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    if correlated:
        y = np.clip(x + rng.randn(*shape).astype(np.float32) * 0.05, 0, 1)
    else:
        y = rng.rand(*shape).astype(np.float32)
    return x, y.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("shape", [(4, 3, 16, 24), (2, 1, 7, 5),
                                   (1, 3, 37, 53), (2, 1, 2, 2), (1, 3, 70, 131)])
def test_ssim_nchw_matches_jax(shape, seed):
    x, y = _pair(shape, seed, correlated=False)
    ref = np.asarray(jssim_nchw(jnp.asarray(x), jnp.asarray(y)))
    before = ssim_nchw.launches
    got = ssim_nchw(torch.from_numpy(x), torch.from_numpy(y))
    assert ssim_nchw.launches == before
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ssim_nchw_plain(torch.from_numpy(x), torch.from_numpy(y)).numpy(), ref,
        rtol=RTOL, atol=ATOL,
    )


def _nhwc_three_ways(seed, correlated):
    x, y = _pair((2, 16, 24, 3), seed, correlated)
    got = ssim(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    ref = np.asarray(jssim(jnp.asarray(x), jnp.asarray(y)))
    pallas = np.asarray(pallas_ssim_forward(jnp.asarray(x), jnp.asarray(y), interpret=True))
    return got, ref, pallas


def test_ssim_nhwc_matches_jax_and_pallas_interpret():
    got, ref, pallas = _nhwc_three_ways(1, correlated=False)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [1, 4, 8])
def test_ssim_near_identical_images_within_jax_spread(seed):
    got, ref, pallas = _nhwc_three_ways(seed, correlated=True)
    assert np.abs(got - ref).max() <= np.abs(pallas - ref).max() + ATOL


def test_ssim_identical_images_is_zero():
    x, _ = _pair((1, 3, 8, 8), 2, False)
    t = torch.from_numpy(x)
    assert float(ssim_nchw(t, t).abs().max()) < 1e-6
