"""Port training step, optimizer, depth metrics and eval-depth step against
the JAX package's (CPU).

ResNet-18 DispNet/PoseNet with JAX-initialised variables (random BatchNorm
statistics and affine), the heads spread as in ``test_torch_step.py`` (at
initialisation the geometry term is a difference of nearly equal depths),
carried across by ``from_jax_variables``. One B=2, N=2 snippet at 64x96,
fp32 on both sides, the JAX side with its torch-exact ``gather`` sampler.
One compiled JAX program serves the file: JAX's own ``make_train_step``
and, beside it, the gradient of its ``_total_loss``.

Tolerances, each with its reason:
  * loss terms rel 1e-4, as the validation step's (``test_torch_step.py``);
  * gradients, relative L2 per tensor: decoders and heads <= 5e-3, the
    encoders <= 3e-2. The loss is kinky at this point: BatchNorm on batch
    statistics spreads every ReLU kink over a channel, and the warp's
    validity mask flips pixels at the frame's edge. Perturbing the frames
    by 1e-6 moves each side's own gradients by up to 1.7e-3 (decoders) and
    1.5e-2 (encoders) per tensor (measured on a CPU), as far as the two sides lie
    apart; each side stays within 2e-5 of its own float64 run;
  * BatchNorm running statistics rel 1e-4 (abs 1e-5): the batch statistics
    agree with the forward, and the test checks that torch's unbiased
    variance would miss this tolerance (n/(n-1) = 36/35 at the deepest
    stage);
  * parameters after one Adam step: the first step moves each parameter
    by lr * g / (|g| + eps), about +-lr whatever |g|, so where a gradient
    is near 0 rounding flips it. Both sides move every parameter by at most
    lr (plus two roundings of the parameter itself); where |g| > 1e-6 and
    the two gradients agree within 10% (at least half of every tensor's
    elements of |g| > 1e-6), the moves agree within 1e-3 * lr plus those
    roundings.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sc_sfmlearner_release_tpu.ops import metrics as jmetrics
from sc_sfmlearner_release_tpu.training import state as jstate
from sc_sfmlearner_release_tpu.training import step as jstep
from sc_sfmlearner_release_tpu_torch.models import DispNet, PoseNet
from sc_sfmlearner_release_tpu_torch.models.convert import (
    from_jax_variables,
    gradient_state_dict,
    to_jax_variables,
)
from sc_sfmlearner_release_tpu_torch.ops.metrics import compute_depth_errors
from sc_sfmlearner_release_tpu_torch.ops.ssim import ssim_nchw, ssim_nchw_bwd
from sc_sfmlearner_release_tpu_torch.ops.warp import warp_sample, warp_sample_bwd
from sc_sfmlearner_release_tpu_torch.training import (
    LossConfig,
    create_train_state,
    make_eval_depth_step,
    make_optimizer,
    make_train_step,
)
from test_torch_models import jax_disp_vars, jax_pose_vars
from test_torch_step import _realistic_heads

B, N, H, W = 2, 2, 64, 96
LR = 1e-4
METRICS = ("loss", "photo_loss", "smooth_loss", "geometry_loss")
NETS = ("disp", "pose")


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    k = np.array([[50.0, 0, W / 2], [0, 55.0, H / 2], [0, 0, 1]], np.float32)
    return {"tgt": rng.rand(B, H, W, 3).astype(np.float32),
            "refs": rng.rand(B, N, H, W, 3).astype(np.float32),
            "intrinsics": np.broadcast_to(k, (B, 3, 3)).copy()}


@functools.cache
def _variables():
    jdisp, dv = jax_disp_vars(18)
    jpose, pv = jax_pose_vars()
    dv, pv = _realistic_heads(dv, pv)
    return jdisp, jpose, dv, pv


def _port_nets():
    _, _, dv, pv = _variables()
    disp_sd, pose_sd = from_jax_variables(dv, pv, 18)
    disp, pose = DispNet(18), PoseNet(18)
    disp.load_state_dict(disp_sd)
    pose.load_state_dict(pose_sd)
    return disp, pose


def _leaves(tree):
    """{path: numpy leaf} of a flax tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@functools.cache
def _jax_program():
    """(tx, run): JAX's make_train_step and, beside it, the gradient of its
    ``_total_loss``, in one jitted ``run(state, batch) -> (metrics, grads,
    new state)``."""
    jdisp, jpose, _, _ = _variables()
    tx = jstate.make_optimizer(lr=LR)
    cfg = jstep.LossConfig()
    train_step = jstep.make_train_step(jdisp, jpose, tx, cfg)

    def run(state, batch):
        grads = jax.grad(lambda p: jstep._total_loss(
            jdisp, jpose, p, state.batch_stats, batch, cfg, True)[0])(state.params)
        new_state, metrics = train_step(state, batch)
        return metrics, grads, new_state

    return tx, jax.jit(run)


def _jax_state(tx):
    """The JAX train state at step 0 over ``_variables()``."""
    _, _, dv, pv = _variables()
    params = {"disp": dv["params"], "pose": pv["params"]}
    stats = {"disp": dv["batch_stats"], "pose": pv["batch_stats"]}
    return jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                             opt_state=tx.init(params), rng=jax.random.PRNGKey(0))


@functools.cache
def _jax_run():
    """JAX's make_train_step on the batch, and the gradient of its loss:
    (metrics, grads, new batch_stats, new params, old params), numpy trees."""
    tx, run = _jax_program()
    state = _jax_state(tx)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    with jax.default_matmul_precision("highest"):
        metrics, grads, new_state = run(state, batch)
    out = (metrics, grads, new_state.batch_stats, new_state.params, state.params)
    return jax.tree_util.tree_map(np.asarray, out)


@functools.cache
def _port_run():
    """The port's make_train_step on the same batch (fp32, CPU): (metrics,
    grads, running statistics, new params, step count), as flax trees."""
    disp, pose = _port_nets()
    state = create_train_state(disp, pose, make_optimizer(disp, pose, lr=LR))
    step = make_train_step(disp, pose, state.optimizer, LossConfig(), device="cpu",
                           precision="fp32")
    metrics = {k: float(v) for k, v in step(_batch()).items()}
    grads = to_jax_variables(gradient_state_dict(disp), gradient_state_dict(pose), 18)
    new = to_jax_variables(disp.state_dict(), pose.state_dict(), 18)
    tree = lambda pair, key: {"disp": pair[0][key], "pose": pair[1][key]}
    return (metrics, tree(grads, "params"), tree(new, "batch_stats"), tree(new, "params"),
            state.step)


def test_train_step_losses_match_jax():
    ref = _jax_run()[0]
    got, _, _, _, steps = _port_run()
    assert steps == 1
    assert float(ref["photo_loss"]) > 0 and float(ref["geometry_loss"]) > 0
    for k in METRICS:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("net", NETS)
def test_train_step_gradients_match_jax(net):
    ref = _leaves(_jax_run()[1][net])
    got = _leaves(_port_run()[1][net])
    assert set(got) == set(ref) and len(ref) > 20
    worst = {}
    for path, r in ref.items():
        if not np.any(r):  # the heads of scales 1-3: one scale is trained
            assert "dispconv" in path and not np.any(got[path]), path
            continue
        worst[path] = np.linalg.norm(got[path] - r) / np.linalg.norm(r)
    assert len(worst) > 20
    tol = lambda path: 3e-2 if path.startswith("['encoder']") else 5e-3
    bad = {p: e for p, e in worst.items() if not e <= tol(p)}
    assert not bad, f"relative L2 above tolerance: {bad}"


@pytest.mark.parametrize("net", NETS)
def test_train_step_batch_stats_match_jax(net):
    ref = _leaves(_jax_run()[2][net])
    old = _leaves({"disp": _variables()[2]["batch_stats"],
                   "pose": _variables()[3]["batch_stats"]}[net])
    got = _leaves(_port_run()[2][net])
    assert set(got) == set(ref)
    for path, r in ref.items():
        np.testing.assert_allclose(got[path], r, rtol=1e-4, atol=1e-5, err_msg=path)
    # The deepest stage sees n = 36 (DispNet: 6 frames of 2x3) or 48
    # (PoseNet: 8 pairs) values per channel: torch's unbiased running
    # variance would land outside the tolerance.
    n = 36 if net == "disp" else 48
    path = next(p for p in ref if "layer4_1" in p and "bn2" in p and "var" in p)
    batch_var = (ref[path] - 0.9 * old[path]) / 0.1
    unbiased = 0.9 * old[path] + 0.1 * batch_var * n / (n - 1)
    assert np.median(np.abs(unbiased - ref[path]) - 1e-4 * np.abs(ref[path])) > 1e-5


@pytest.mark.parametrize("net", NETS)
def test_train_step_params_after_adam_match_jax(net):
    _, grads, _, new_ref, old = _jax_run()
    ref, g, before = _leaves(new_ref[net]), _leaves(grads[net]), _leaves(old[net])
    got, g_port = _leaves(_port_run()[3][net]), _leaves(_port_run()[1][net])
    for path, r in ref.items():
        moved_ref, moved = r - before[path], got[path] - before[path]
        ulps = 2.0**-22 * max(1.0, np.abs(before[path]).max())  # rounding of p + move
        assert np.abs(moved).max() <= LR + ulps, path
        assert np.abs(moved_ref).max() <= LR + ulps, path
        if not np.any(g[path]):
            assert not np.any(moved), path  # no gradient, no move
            continue
        live = np.abs(g[path]) > 1e-6
        firm = live & (np.abs(g_port[path] - g[path]) < 0.1 * np.abs(g[path]))
        assert firm.sum() >= 0.5 * live.sum(), (path, firm.sum(), live.sum())
        np.testing.assert_allclose(moved[firm], moved_ref[firm], rtol=0,
                                   atol=1e-3 * LR + ulps, err_msg=path)


def _translating_batch(b=2, h=32, w=64, seed=0):
    """A translating camera: shifted crops of one textured image (the JAX
    package's ``tests/test_training.py`` scene)."""
    rng = np.random.RandomState(seed)
    base = rng.rand(h + 8, w + 8, 3).astype(np.float32)
    tgt = np.stack([base[4:4 + h, 4:4 + w] for _ in range(b)])
    refs = np.stack([np.stack([base[4:4 + h, 2:2 + w], base[4:4 + h, 6:6 + w]])
                     for _ in range(b)])
    k = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]], np.float32)
    return {"tgt": tgt, "refs": refs, "intrinsics": np.broadcast_to(k, (b, 3, 3)).copy()}


def test_train_step_loss_falls_and_both_nets_learn():
    g = torch.Generator().manual_seed(0)
    disp, pose = DispNet(18, generator=g), PoseNet(18, generator=g)
    state = create_train_state(disp, pose, make_optimizer(disp, pose, lr=1e-3))
    before = {n: [p.detach().clone() for p in m.parameters()] for n, m in
              (("disp", disp), ("pose", pose))}
    step = make_train_step(disp, pose, state.optimizer, device="cpu", precision="fp32")
    launches = (warp_sample.launches, warp_sample_bwd.launches, ssim_nchw.launches,
                ssim_nchw_bwd.launches)
    batch = _translating_batch()
    losses = [float(step(batch)["loss"]) for _ in range(8)]
    assert (warp_sample.launches, warp_sample_bwd.launches, ssim_nchw.launches,
            ssim_nchw_bwd.launches) == launches  # CPU tensors: the plain versions
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    assert state.step == 8
    for name, net in (("disp", disp), ("pose", pose)):
        changed = sum(not torch.allclose(a, b) for a, b in zip(net.parameters(), before[name]))
        assert changed > 0.9 * len(before[name]), f"{name}: {changed} of {len(before[name])}"


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_make_optimizer_matches_optax(weight_decay):
    """Three steps on fixed gradients: torch's Adam with coupled L2 against
    the JAX package's optimizer (optax.add_decayed_weights, then adam)."""
    rng = np.random.RandomState(3)
    w0 = {"disp": rng.randn(5, 4).astype(np.float32), "pose": rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in w0.items()}
             for _ in range(3)]
    tx = jstate.make_optimizer(lr=1e-2, weight_decay=weight_decay)
    params = {k: jnp.asarray(v) for k, v in w0.items()}
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                       params)
        params = optax.apply_updates(params, updates)

    disp, pose = torch.nn.Linear(1, 1), torch.nn.Linear(1, 1)
    disp.weight = torch.nn.Parameter(torch.from_numpy(w0["disp"]))
    pose.weight = torch.nn.Parameter(torch.from_numpy(w0["pose"]))
    del disp.bias, pose.bias
    disp.bias = pose.bias = None
    opt = make_optimizer(disp, pose, lr=1e-2, weight_decay=weight_decay)
    for g in grads:
        disp.weight.grad = torch.from_numpy(g["disp"])
        pose.weight.grad = torch.from_numpy(g["pose"])
        opt.step()
    for k, net in (("disp", disp), ("pose", pose)):
        # The two round the same update differently: a few ulps of |w| < 3.
        np.testing.assert_allclose(net.weight.detach().numpy(), np.asarray(params[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def _depth_batch(gt_size, seed=0):
    """Images, and ground truth with missing (0) and out-of-range pixels."""
    rng = np.random.RandomState(seed)
    gt = rng.uniform(1.0, 90.0, (B,) + gt_size).astype(np.float32)
    gt[rng.rand(*gt.shape) < 0.3] = 0.0
    return {"img": rng.rand(B, H, W, 3).astype(np.float32), "depth": gt}


@pytest.mark.parametrize("dataset", ["kitti", "nyu"])
@pytest.mark.parametrize("n_valid", [None, 1])
def test_compute_depth_errors_matches_jax(dataset, n_valid):
    rng = np.random.RandomState(5)
    gt = rng.uniform(0.0, 85.0, (3, 40, 60)).astype(np.float32)
    gt[rng.rand(*gt.shape) < 0.2] = 0.0
    pred = (gt * rng.uniform(0.5, 1.5, gt.shape) + rng.rand(*gt.shape)).astype(np.float32)
    ref = jmetrics.compute_depth_errors(jnp.asarray(gt), jnp.asarray(pred), dataset,
                                        n_valid=n_valid)
    got = compute_depth_errors(torch.from_numpy(gt), torch.from_numpy(pred), dataset,
                               n_valid=n_valid)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)


@functools.cache
def _jax_eval_depth_step():
    return jstep.make_eval_depth_step(_variables()[0])


@pytest.mark.parametrize("gt_size,n_valid", [((H, W), None), ((80, 120), 1)])
def test_eval_depth_step_matches_jax(gt_size, n_valid):
    """Median-scaled errors (a1..a3 count thresholds, so a pixel on a
    threshold could move them by one pixel's share: rel 1e-4 holds here)."""
    jdisp, jpose, dv, pv = _variables()
    batch = _depth_batch(gt_size)
    state = jstate.TrainState(step=None, params={"disp": dv["params"]},
                              batch_stats={"disp": dv["batch_stats"]}, opt_state=None, rng=None)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if n_valid is not None:
        batch["n_valid"] = n_valid
        jbatch["n_valid"] = jnp.int32(n_valid)
    with jax.default_matmul_precision("highest"):
        ref = _jax_eval_depth_step()(state, jbatch)
    disp, _ = _port_nets()
    got = make_eval_depth_step(disp, device="cpu", precision="fp32")(batch)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4, err_msg=k)
