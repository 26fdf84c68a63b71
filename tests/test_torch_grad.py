"""Gradients of the kernels' plain versions against ``jax.grad`` (CPU).

On the card the warp and SSIM wrappers differentiate through hand-written
backward kernels, which ``chip_smoke.py`` holds against PyTorch's autograd
through these plain versions. Here that autograd is held against JAX's:

  * ``warp_sample_plain`` against the JAX package's gather ``grid_sample``:
    d(coords) and d(source depth), with the RGB channels behind the depth
    sampled without gradient, as ``inverse_warp2`` samples them;
  * ``ssim_nchw_plain`` against JAX ``ssim_nchw``, d/dx and d/dy, on ragged
    shapes whose every row and column is within reach of a reflect edge.

Tolerance: max|err| <= 1e-5 * max|ref| per gradient. Both sides compute
the same fp32 derivative, summed in different orders (and the port scales
the 3x3 sums by 1/9 where JAX divides by 9); 1e-5 is ~100 fp32 roundings of
the largest entry. SSIM of nearly identical images (``correlated``) is
held to 2e-4: there sigma = E[x^2] - mu^2 cancels, and each fp32 side alone
lies up to 9.6e-5 * max|ref| from the float64 gradient (measured on these
inputs; JAX's side the farther at [1,3,2,2]). No input lies on a clip's bound,
where ``torch.clamp`` passes the whole gradient and ``jnp.clip`` half of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from sc_sfmlearner_release_tpu.ops.ssim import ssim_nchw as jax_ssim_nchw
from sc_sfmlearner_release_tpu_torch.ops.ssim import ssim_nchw_plain
from sc_sfmlearner_release_tpu_torch.ops.warp import warp_sample_plain

TOL = 1e-5
SSIM_TOL = {"independent": 1e-5, "correlated": 2e-4}


def _close(got: torch.Tensor, ref, name: str, tol: float = TOL) -> None:
    ref = np.asarray(ref)
    err = np.abs(got.detach().numpy() - ref).max()
    scale = np.abs(ref).max()
    assert scale > 0, name
    assert err <= tol * scale, f"{name}: max|err| {err:.3e} > {tol} * {scale:.3e}"


def _warp_inputs(kind: str, seed: int = 0):
    """Source [F, H, W, 4] (depth, RGB), coords [F, Ho, Wo, 2] and dout."""
    rng = np.random.RandomState(seed)
    f, h, w, ho, wo = 3, 9, 13, 7, 11
    depth = rng.uniform(1.0, 20.0, (f, h, w, 1)).astype(np.float32)
    rgb = rng.rand(f, h, w, 3).astype(np.float32)
    if kind == "projected":
        # A smooth warp of the pixel grid: shift, scale and a little noise.
        ys, xs = np.meshgrid(np.linspace(-1, 1, ho), np.linspace(-1, 1, wo), indexing="ij")
        gx = 0.9 * xs[None] + rng.uniform(-0.2, 0.2, (f, 1, 1)) + rng.randn(f, ho, wo) * 0.01
        gy = 0.9 * ys[None] + rng.uniform(-0.2, 0.2, (f, 1, 1)) + rng.randn(f, ho, wo) * 0.01
        coords = np.stack([gx, gy], -1).astype(np.float32)
    else:
        # Out of range, exactly 2.0 (cam2pixel's out-of-frame value), and +-1.
        coords = rng.uniform(-1.4, 1.4, (f, ho, wo, 2)).astype(np.float32)
        coords[:, ::3, :, 0] = 2.0
        coords[:, 1, :, :] = 1.0
        coords[:, :, 2, :] = -1.0
        coords[:, 4, 5, :] = 1.7
    dout = rng.randn(f, ho, wo, 4).astype(np.float32)
    return depth, rgb, coords, dout


@pytest.mark.parametrize("kind", ["projected", "out_of_range"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_warp_plain_grads_match_jax(padding_mode, kind):
    depth, rgb, coords, dout = _warp_inputs(kind)

    def jax_loss(d, c):
        src = jnp.concatenate([d, jax.lax.stop_gradient(jnp.asarray(rgb))], -1)
        return jnp.sum(jax_grid_sample(src, c, padding_mode) * dout)

    ref_d, ref_c = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(depth), jnp.asarray(coords))
    d = torch.from_numpy(depth).requires_grad_(True)
    c = torch.from_numpy(coords).requires_grad_(True)
    rgb_t = torch.from_numpy(rgb).requires_grad_(True)
    out = warp_sample_plain(d, c, padding_mode, frozen=rgb_t)
    assert out.shape == dout.shape
    out.backward(torch.from_numpy(dout))
    _close(d.grad, ref_d, "d(depth)")
    _close(c.grad, ref_c, "d(coords)")
    assert rgb_t.grad is None  # the camera images get no gradient


@pytest.mark.parametrize("pair", ["independent", "correlated"])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 3, 2, 2), (1, 2, 9, 4), (2, 1, 13, 17)])
def test_ssim_plain_grads_match_jax(shape, pair):
    rng = np.random.RandomState(sum(shape))
    x = rng.rand(*shape).astype(np.float32)
    if pair == "independent":
        y = rng.rand(*shape).astype(np.float32)
    else:
        y = np.clip(x + rng.randn(*shape) * 0.05, 0.0, 1.0).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)

    jax_loss = lambda a, b: jnp.sum(jax_ssim_nchw(a, b) * g)
    ref_x, ref_y = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    ssim_nchw_plain(tx, ty).backward(torch.from_numpy(g))
    _close(tx.grad, ref_x, "d/dx", SSIM_TOL[pair])
    _close(ty.grad, ref_y, "d/dy", SSIM_TOL[pair])
