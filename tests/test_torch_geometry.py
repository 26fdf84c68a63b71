"""Port geometry and warp sampler against the JAX package (CPU).

The same numpy inputs go through the JAX functions and their counterparts
in ``sc_sfmlearner_release_tpu_torch``; the port's ``warp_sample`` runs its
plain version here because its tensors lie on the CPU. Tolerance: atol 1e-5
(fp32 on both sides, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu.ops import geometry as jgeo
from sc_sfmlearner_release_tpu.ops.grid_sample import grid_sample as jgrid_sample
from sc_sfmlearner_release_tpu_torch.ops import geometry as tgeo
from sc_sfmlearner_release_tpu_torch.ops.grid_sample import grid_sample as tgrid_sample
from sc_sfmlearner_release_tpu_torch.ops.warp import warp_sample, warp_sample_plain

ATOL = 1e-5
B, H, W = 3, 12, 20


def _close(port, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(
        port.detach().numpy() if isinstance(port, torch.Tensor) else port,
        np.asarray(ref), atol=atol, rtol=rtol,
    )


def _intrinsics(b=B, h=H, w=W):
    k = np.array([[0.8 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]], np.float32)
    return np.broadcast_to(k, (b, 3, 3)).copy()


def _rng(seed):
    return np.random.RandomState(seed)


def test_pixel2cam_matches_jax():
    rng = _rng(0)
    depth = rng.uniform(0.5, 10.0, (B, H, W)).astype(np.float32)
    k_inv = np.linalg.inv(_intrinsics()).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jgeo.pixel2cam(jnp.asarray(depth), jnp.asarray(k_inv))
    _close(tgeo.pixel2cam(torch.from_numpy(depth), torch.from_numpy(k_inv)), ref)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_cam2pixel_matches_jax(padding_mode):
    rng = _rng(1)
    cam = rng.uniform(-3.0, 3.0, (B, H, W, 3)).astype(np.float32)
    cam[..., 2] = rng.uniform(-0.5, 8.0, (B, H, W))  # some points behind the camera
    proj = np.concatenate(
        [_intrinsics(), rng.randn(B, 3, 1).astype(np.float32)], axis=2
    ).astype(np.float32)
    coords, z = jgeo.cam2pixel(jnp.asarray(cam), jnp.asarray(proj), padding_mode)
    t_coords, t_z = tgeo.cam2pixel(torch.from_numpy(cam), torch.from_numpy(proj), padding_mode)
    _close(t_z, z, rtol=1e-6)
    _close(t_coords, coords, rtol=1e-5)
    if padding_mode == "zeros":
        assert (t_coords == 2.0).any()


@pytest.mark.parametrize("fn", ["euler2mat", "quat2mat"])
def test_rotations_match_jax(fn):
    rng = _rng(2)
    angles = (rng.randn(5, 3) * 0.5).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = getattr(jgeo, fn)(jnp.asarray(angles))
    _close(getattr(tgeo, fn)(torch.from_numpy(angles)), ref)


@pytest.mark.parametrize("rotation_mode", ["euler", "quat"])
def test_pose_vec2mat_and_inverse_match_jax(rotation_mode):
    rng = _rng(3)
    vec = (rng.randn(5, 6) * 0.3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        m = jgeo.pose_vec2mat(jnp.asarray(vec), rotation_mode)
        m4 = jgeo.pose_mat4(m)
        inv = jgeo.invert_pose_mat4(m4)
    t_m = tgeo.pose_vec2mat(torch.from_numpy(vec), rotation_mode)
    t_m4 = tgeo.pose_mat4(t_m)
    t_inv = tgeo.invert_pose_mat4(t_m4)
    _close(t_m, m)
    _close(t_m4, m4)
    _close(t_inv, inv)
    eye = (t_m4 @ t_inv).numpy()
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(4), eye.shape), atol=1e-5)


def test_pixel_grid_matches_jax():
    _close(tgeo.pixel_grid(H, W), jgeo.pixel_grid(H, W), atol=0)


def _warp_inputs(seed, b=B, h=H, w=W):
    rng = _rng(seed)
    img = rng.rand(b, h, w, 3).astype(np.float32)
    depth = rng.uniform(1.0, 10.0, (b, h, w, 1)).astype(np.float32)
    ref_depth = rng.uniform(1.0, 10.0, (b, h, w, 1)).astype(np.float32)
    pose = (rng.randn(b, 6) * [0.2, 0.2, 0.2, 0.05, 0.05, 0.05]).astype(np.float32)
    return img, depth, ref_depth, pose, _intrinsics(b, h, w)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_inverse_warp2_matches_jax_gather(padding_mode):
    img, depth, ref_depth, pose, k = _warp_inputs(4)
    with jax.default_matmul_precision("highest"):
        ref = jgeo.inverse_warp2(
            *map(jnp.asarray, (img, depth, ref_depth, pose, k)),
            padding_mode=padding_mode, sampler="gather",
        )
    port = tgeo.inverse_warp2(*map(torch.from_numpy, (img, depth, ref_depth, pose, k)),
                              padding_mode=padding_mode)
    assert 0.0 < float(port[1].mean()) < 1.0  # the warp leaves the frame somewhere
    for p, r in zip(port, ref):
        assert tuple(p.shape) == r.shape
        _close(p, r, rtol=1e-5)


def test_inverse_warp_matches_jax():
    img, depth, _, pose, k = _warp_inputs(5)
    with jax.default_matmul_precision("highest"):
        ref_img, ref_valid = jgeo.inverse_warp(
            jnp.asarray(img), jnp.asarray(depth[..., 0]), jnp.asarray(pose), jnp.asarray(k)
        )
    t_img, t_valid = tgeo.inverse_warp(
        torch.from_numpy(img), torch.from_numpy(depth[..., 0]),
        torch.from_numpy(pose), torch.from_numpy(k),
    )
    _close(t_img, ref_img)
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(ref_valid))


def _coords_with_edges(seed, shape):
    """Coordinates inside and outside [-1, 1], with exact 2.0 and +-1 values."""
    c = _rng(seed).uniform(-1.4, 1.4, shape).astype(np.float32)
    c[:, ::3, :, 0] = 2.0
    c[:, :, ::4, 1] = 2.0
    c[:, 0] = 1.0
    c[:, -1] = -1.0
    return c


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("channels", [4, 3])
def test_warp_sample_cpu_matches_jax_grid_sample(padding_mode, channels):
    rng = _rng(6)
    src = rng.rand(2 * B, H, W, channels).astype(np.float32) * 5.0
    coords = _coords_with_edges(7, (2 * B, H + 3, W - 2, 2))
    ref = jgrid_sample(jnp.asarray(src), jnp.asarray(coords), padding_mode=padding_mode)
    before = warp_sample.launches
    got = warp_sample(torch.from_numpy(src), torch.from_numpy(coords), padding_mode)
    assert warp_sample.launches == before
    _close(got, ref)
    _close(warp_sample_plain(torch.from_numpy(src), torch.from_numpy(coords), padding_mode), ref)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_plain_grid_sample_matches_torch(padding_mode):
    """The plain sampler has F.grid_sample's semantics (align_corners=False)."""
    rng = _rng(8)
    src = rng.rand(2, H, W, 4).astype(np.float32)
    coords = _coords_with_edges(9, (2, H, W, 2))
    got = tgrid_sample(torch.from_numpy(src), torch.from_numpy(coords), padding_mode)
    want = torch.nn.functional.grid_sample(
        torch.from_numpy(src).permute(0, 3, 1, 2), torch.from_numpy(coords),
        mode="bilinear", padding_mode=padding_mode, align_corners=False,
    ).permute(0, 2, 3, 1)
    _close(got, want)


def test_warp_sample_rejects_bad_padding():
    src = torch.zeros(1, 4, 4, 4)
    with pytest.raises(ValueError):
        warp_sample(src, torch.zeros(1, 4, 4, 2), "reflection")


def test_inv3x3_matches_numpy():
    rng = _rng(10)
    m = rng.randn(6, 3, 3).astype(np.float32) + 3.0 * np.eye(3, dtype=np.float32)
    m[:2] = _intrinsics(2)
    _close(tgeo.inv3x3(torch.from_numpy(m)), np.linalg.inv(m.astype(np.float64)), rtol=1e-5)
