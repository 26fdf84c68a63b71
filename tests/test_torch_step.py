"""Port validation step and depth inference against the JAX package's (CPU).

ResNet-18 DispNet/PoseNet with JAX-initialised variables (non-trivial BN),
carried across by ``from_jax_variables``; a B=4, N=2 snippet at 64x96,
where the masked means clear the reference's 10000-element guard. fp32 on
both sides, the JAX side with its torch-exact ``gather`` sampler.
Tolerance rel 1e-4.

At initialisation the disparity heads are nearly constant and the poses
are ~1e-4, so the geometry term is a difference of nearly equal depths and
amplifies rounding: there the JAX step alone moves by 2e-4 between XLA's
optimization levels. The heads are therefore spread to a realistic scene
(depths varying by ~2x across the frame, motions of ~0.01) before the
comparison.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu.training import step as jstep
from sc_sfmlearner_release_tpu.training.state import TrainState
from sc_sfmlearner_release_tpu_torch.models import DispNet, PoseNet
from sc_sfmlearner_release_tpu_torch.models.convert import from_jax_variables
from sc_sfmlearner_release_tpu_torch.ops.ssim import ssim_nchw
from sc_sfmlearner_release_tpu_torch.ops.warp import warp_sample
from sc_sfmlearner_release_tpu_torch.training import (
    LossConfig,
    compute_depth,
    compute_pose_with_inv,
    make_eval_step,
    make_inference_fn,
)
from test_torch_models import jax_disp_vars, jax_pose_vars

B, N, H, W = 4, 2, 64, 96
RTOL = 1e-4
METRICS = ("loss", "photo_loss", "smooth_loss", "geometry_loss")


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    k = np.array([[50.0, 0, W / 2], [0, 55.0, H / 2], [0, 0, 1]], np.float32)
    return {"tgt": rng.rand(B, H, W, 3).astype(np.float32),
            "refs": rng.rand(B, N, H, W, 3).astype(np.float32),
            "intrinsics": np.broadcast_to(k, (B, 3, 3)).copy()}


def _realistic_heads(dv, pv, seed=11):
    dv, pv = copy.deepcopy(dv), copy.deepcopy(pv)
    for s in range(4):
        dv["params"]["decoder"][f"dispconv_{s}"]["conv"]["kernel"] *= 20.0
    motion = np.random.RandomState(seed).randn(6) * [1.0, 1.0, 1.0, 0.5, 0.5, 0.5]
    pv["params"]["decoder"]["pose_2"]["bias"][:] = motion  # pose = 0.01 * mean
    return dv, pv


@functools.cache
def _models():
    jdisp, dv = jax_disp_vars(18)
    jpose, pv = jax_pose_vars()
    dv, pv = _realistic_heads(dv, pv)
    disp_sd, pose_sd = from_jax_variables(dv, pv, 18)
    disp, pose = DispNet(18), PoseNet(18)
    disp.load_state_dict(disp_sd)
    pose.load_state_dict(pose_sd)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params={"disp": dv["params"], "pose": pv["params"]},
                       batch_stats={"disp": dv["batch_stats"], "pose": pv["batch_stats"]},
                       opt_state=None, rng=None)
    return jdisp, jpose, state, disp, pose


@functools.cache
def _jax_eval_step():
    jdisp, jpose, _, _, _ = _models()
    return jstep.make_eval_step(jdisp, jpose, jstep.LossConfig())


@pytest.mark.parametrize("n_valid", [None, 3])
def test_eval_step_matches_jax(n_valid):
    _, _, state, disp, pose = _models()
    batch = _batch()
    if n_valid is not None:
        batch["n_valid"] = np.int32(n_valid)
    with jax.default_matmul_precision("highest"):
        ref = _jax_eval_step()(state, {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_eval_step(disp, pose, LossConfig(), device="cpu", precision="fp32")
    launches = (warp_sample.launches, ssim_nchw.launches)
    got = step(batch)
    assert (warp_sample.launches, ssim_nchw.launches) == launches
    assert float(ref["photo_loss"]) > 0 and float(ref["geometry_loss"]) > 0
    for k in METRICS:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL, err_msg=k)


def test_eval_step_n_valid_equals_smaller_batch():
    """Padded samples past n_valid leave the metrics of the true batch."""
    _, _, _, disp, pose = _models()
    step = make_eval_step(disp, pose, device="cpu", precision="fp32")
    batch = _batch(1)
    small = {k: v[:3] for k, v in batch.items()}
    padded = {k: np.concatenate([v[:3], v[2:3]]) for k, v in batch.items()}
    padded["n_valid"] = 3
    got, want = step(padded), step(small)
    for k in METRICS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_inference_matches_jax():
    jdisp, _, state, disp, _ = _models()
    img = _batch(2)["tgt"]
    variables = {"params": state.params["disp"], "batch_stats": state.batch_stats["disp"]}
    with jax.default_matmul_precision("highest"):
        ref_disp, ref_depth = jstep.make_inference_fn(jdisp)(variables, jnp.asarray(img))
    got_disp, got_depth = make_inference_fn(disp, device="cpu", precision="fp32")(img)
    assert tuple(got_disp.shape) == (B, H, W, 1)
    np.testing.assert_allclose(got_disp.numpy(), np.asarray(ref_disp), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got_depth.numpy(), np.asarray(ref_depth), rtol=RTOL)


def test_frame_major_folding():
    """Depth and pose folding: frame-major batches, split back per frame."""
    calls = []

    def fake_disp(x):
        calls.append(x)
        return (x[..., :1] + 1.0,)

    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    tgt, refs = batch["tgt"], batch["refs"]
    tgt_depth, ref_depths = compute_depth(fake_disp, tgt, refs)
    assert calls[0].shape == ((1 + N) * B, H, W, 3)
    torch.testing.assert_close(tgt_depth[0], 1.0 / (tgt[..., :1] + 1.0))
    torch.testing.assert_close(ref_depths[0], 1.0 / (refs[..., :1] + 1.0))

    def fake_pose(a, b):
        return torch.cat([a[:, 0, 0, :3], b[:, 0, 0, :3]], dim=1)

    poses, poses_inv = compute_pose_with_inv(fake_pose, tgt, refs)
    for i in range(N):
        torch.testing.assert_close(poses[:, i, :3], tgt[:, 0, 0])
        torch.testing.assert_close(poses[:, i, 3:], refs[:, i, 0, 0])
        torch.testing.assert_close(poses_inv[:, i, :3], refs[:, i, 0, 0])
        torch.testing.assert_close(poses_inv[:, i, 3:], tgt[:, 0, 0])


def test_bf16_eval_step_runs_near_fp32():
    """The default precision (bf16 convolutions under autocast) on the CPU:
    finite, and within bf16's ~3 significant digits of fp32 after the
    networks' depth of rounding."""
    _, _, _, disp, pose = _models()
    batch = _batch(4)
    bf16 = make_eval_step(disp, pose, device="cpu")(batch)
    fp32 = make_eval_step(disp, pose, device="cpu", precision="fp32")(batch)
    for k in METRICS:
        assert np.isfinite(float(bf16[k]))
        np.testing.assert_allclose(float(bf16[k]), float(fp32[k]), rtol=5e-2, err_msg=k)
