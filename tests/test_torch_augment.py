"""Port device augmentation against the JAX package's (CPU).

``augment_with_draws`` and ``normalize_batch`` of both packages on the same
numpy inputs and the same pinned draws (the draws' random streams differ
by design: the port draws from a CPU ``torch.Generator`` seeded from
(seed, step), JAX from ``jax.random``); ``sample_draws``' determinism and
configs; and a full train step with ``augment_fn`` on a uint8 batch against
JAX's ``make_train_step(augment_fn=...)``, both given the same draws.

Tolerances: normalized frames 1e-5 abs (the same fp32 arithmetic; JAX
resamples by dense one-hot contractions, the port by gathers, so only the
rounding of the two-tap sums differs), intrinsics 1e-5 rel. The JAX
function runs op by op, as the JAX package's own tests run it: under
``jax.jit`` XLA turns the positions' division by the scale into a
multiplication by its reciprocal, which moves a position by one ulp and a
normalized frame by up to 3.4e-5 here (against 7e-7 between the port and
the op-by-op JAX function, whose positions agree exactly). The train step
as ``test_torch_train.py`` (losses rel 1e-4, gradients per-tensor relative
L2 5e-3 for decoders and heads, 3e-2 for the encoders, for the reasons
given there).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu.data import device_augment as jaug
from sc_sfmlearner_release_tpu.training import state as jstate
from sc_sfmlearner_release_tpu.training import step as jstep
from sc_sfmlearner_release_tpu_torch.data import device_augment as aug
from sc_sfmlearner_release_tpu_torch.models.convert import gradient_state_dict, to_jax_variables
from sc_sfmlearner_release_tpu_torch.training import (
    LossConfig,
    create_train_state,
    make_optimizer,
    make_train_step,
)
from test_torch_train import LR, METRICS, NETS, _leaves, _port_nets, _variables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on shared cores: one torch
    thread each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CFG = aug.AugmentConfig()
SHAPES = {"32x48": (3, 2, 32, 48), "37x53": (3, 2, 37, 53)}
# Per sample (sx, sy, ox01, oy01): the identity; inside the range; at the
# top of the scale range with the crop at its far end.
DRAWS = {
    "identity": [(1.0, 1.0, 0.0, 0.0)] * 3,
    "middle": [(1.07, 1.11, 0.5, 0.3), (1.02, 1.13, 0.9, 0.05), (1.12, 1.01, 0.25, 0.75)],
    "max_scale": [(np.nextafter(np.float32(1.15), np.float32(0)),) * 2 + (0.999999, 0.999999),
                  (1.149, 1.15, 0.0, 0.999), (1.15, 1.149, 0.999, 0.0)],
}


def _raw(shape, dtype, seed=0):
    b, n, h, w = shape
    rng = np.random.RandomState(seed)
    k = np.array([[30.0, 0, w / 2], [0, 25.0, h / 2 + 1], [0, 0, 1]], np.float32)
    frames = rng.randint(0, 256, (b, 1 + n, h, w, 3)).astype(np.uint8)
    if dtype == "float32":
        frames = frames.astype(np.float32) / 255.0
    return {"tgt": frames[:, 0], "refs": frames[:, 1:],
            "intrinsics": np.broadcast_to(k, (b, 3, 3)).copy()}


def _draws(kind, flip):
    table = np.asarray(DRAWS[kind], np.float32)
    return {"flip": np.full(len(table), flip), "scales": table[:, :2],
            "offsets01": table[:, 2:]}


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", DRAWS)
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_augment_with_draws_matches_jax(shape, kind, flip, dtype):
    raw, draws = _raw(SHAPES[shape], dtype), _draws(kind, flip)
    ref = jaug.augment_with_draws(jaug._to_unit_float(_jax(raw)), _jax(draws),
                                  jaug.AugmentConfig())
    got = aug.augment_with_draws(aug._to_unit_float(_torch(raw)), _torch(draws), CFG)
    for k in ("tgt", "refs"):
        assert got[k].dtype == torch.float32 and got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["intrinsics"].numpy(), np.asarray(ref["intrinsics"]),
                               rtol=1e-5, atol=0)
    if kind == "identity" and not flip:  # the identity resample returns the frames
        np.testing.assert_allclose(got["tgt"].numpy() * 0.225 + 0.45,
                                   aug._to_unit_float(_torch(raw))["tgt"].numpy(), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_normalize_batch_matches_jax(dtype):
    raw = _raw(SHAPES["37x53"], dtype)
    raw["img"] = raw["tgt"][:2]
    ref = jaug.normalize_batch(_jax(raw))
    got = aug.normalize_batch(_torch(raw))
    assert set(got) == set(ref)
    for k in ("tgt", "refs", "img"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(got["intrinsics"].numpy(), raw["intrinsics"])


def test_sample_draws_are_fixed_by_seed_and_step():
    a = aug.sample_draws(aug.step_generator(7, 3), 64, CFG)
    b = aug.sample_draws(aug.step_generator(7, 3), 64, CFG)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for other in (aug.step_generator(7, 4), aug.step_generator(8, 3)):
        c = aug.sample_draws(other, 64, CFG)
        assert not torch.equal(a["scales"], c["scales"])
    assert a["flip"].dtype == torch.bool and a["scales"].dtype == torch.float32
    assert a["offsets01"].dtype == torch.float32
    # Different per sample, inside their ranges.
    assert 10 < int(a["flip"].sum()) < 54
    assert len(torch.unique(a["scales"])) == 128
    assert a["scales"].min() >= 1.0 and a["scales"].max() < CFG.max_scale
    assert a["offsets01"].min() >= 0.0 and a["offsets01"].max() < 1.0
    # The stream itself is pinned: a resumed run must draw what it would have.
    np.testing.assert_allclose(a["scales"][0].numpy(), _PINNED_SCALES, rtol=1e-6)


# sample_draws(step_generator(7, 3), ...)["scales"][0], the first sample's.
_PINNED_SCALES = [1.108354091644287, 1.1350802183151245]


@pytest.mark.parametrize("flip,scale_crop", [(False, True), (True, False), (False, False)])
def test_sample_draws_configs(flip, scale_crop):
    cfg = aug.AugmentConfig(flip=flip, scale_crop=scale_crop)
    full = aug.sample_draws(aug.step_generator(1, 2), 16, CFG)
    got = aug.sample_draws(aug.step_generator(1, 2), 16, cfg)
    assert torch.equal(got["flip"], full["flip"] if flip else torch.zeros(16, dtype=bool))
    assert torch.equal(got["scales"], full["scales"] if scale_crop else torch.ones(16, 2))
    assert torch.equal(got["offsets01"], full["offsets01"])


def test_make_device_augment_uses_the_generators_draws():
    raw = _torch(_raw(SHAPES["32x48"], "uint8"))
    got = aug.make_device_augment(CFG)(aug.step_generator(0, 5), raw)
    draws = aug.sample_draws(aug.step_generator(0, 5), 3, CFG)
    want = aug.augment_with_draws(aug._to_unit_float(raw), draws, CFG)
    for k in ("tgt", "refs", "intrinsics"):
        assert torch.equal(got[k], want[k]), k


# ---- a train step with the augmentation, against JAX's -------------------

B, N, H, W = 2, 2, 64, 96
STEP_DRAWS = {"flip": np.array([True, False]),
              "scales": np.array([[1.07, 1.11], [1.13, 1.02]], np.float32),
              "offsets01": np.array([[0.5, 0.3], [0.9, 0.6]], np.float32)}


def _uint8_batch(seed=0):
    rng = np.random.RandomState(seed)
    k = np.array([[50.0, 0, W / 2], [0, 55.0, H / 2], [0, 0, 1]], np.float32)
    return {"tgt": rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
            "refs": rng.randint(0, 256, (B, N, H, W, 3)).astype(np.uint8),
            "intrinsics": np.broadcast_to(k, (B, 3, 3)).copy()}


@functools.cache
def _jax_aug_run():
    """JAX's make_train_step with an augment_fn that applies STEP_DRAWS,
    and the gradient of its loss on the augmented batch."""
    jdisp, jpose, dv, pv = _variables()
    tx = jstate.make_optimizer(lr=LR)
    cfg = jstep.LossConfig()
    params = {"disp": dv["params"], "pose": pv["params"]}
    stats = {"disp": dv["batch_stats"], "pose": pv["batch_stats"]}
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                              opt_state=tx.init(params), rng=jax.random.PRNGKey(0))
    draws = _jax(STEP_DRAWS)
    augment = lambda key, b: jaug.augment_with_draws(jaug._to_unit_float(b), draws,
                                                     jaug.AugmentConfig())
    train_step = jstep.make_train_step(jdisp, jpose, tx, cfg, augment_fn=augment)

    def run(state, batch):
        grads = jax.grad(lambda p: jstep._total_loss(
            jdisp, jpose, p, state.batch_stats, augment(None, batch), cfg, True)[0]
        )(state.params)
        new_state, metrics = train_step(state, batch)
        return metrics, grads, new_state.step

    with jax.default_matmul_precision("highest"):
        out = jax.jit(run)(state, _jax(_uint8_batch()))
    return jax.tree_util.tree_map(np.asarray, out)


@functools.cache
def _port_aug_run():
    disp, pose = _port_nets()
    state = create_train_state(disp, pose, make_optimizer(disp, pose, lr=LR))
    seen = []

    def augment(generator, batch):
        seen.append({k: v.dtype for k, v in batch.items()})
        return aug.augment_with_draws(aug._to_unit_float(batch), _torch(STEP_DRAWS), CFG)

    step = make_train_step(disp, pose, state.optimizer, LossConfig(), device="cpu",
                           precision="fp32", augment_fn=augment)
    metrics = {k: float(v) for k, v in step(_uint8_batch()).items()}
    grads = to_jax_variables(gradient_state_dict(disp), gradient_state_dict(pose), 18)
    return metrics, {"disp": grads[0]["params"], "pose": grads[1]["params"]}, state.step, seen


def test_train_step_with_augmentation_losses_match_jax():
    ref, _, jax_steps = _jax_aug_run()
    got, _, steps, seen = _port_aug_run()
    assert steps == 1 and int(jax_steps) == 1
    assert seen == [{"tgt": torch.uint8, "refs": torch.uint8, "intrinsics": torch.float32}]
    for k in METRICS:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("net", NETS)
def test_train_step_with_augmentation_gradients_match_jax(net):
    ref = _leaves(_jax_aug_run()[1][net])
    got = _leaves(_port_aug_run()[1][net])
    assert set(got) == set(ref)
    worst = {p: np.linalg.norm(got[p] - r) / np.linalg.norm(r) for p, r in ref.items()
             if np.any(r)}
    assert len(worst) > 20
    tol = lambda path: 3e-2 if path.startswith("['encoder']") else 5e-3
    bad = {p: e for p, e in worst.items() if not e <= tol(p)}
    assert not bad, f"relative L2 above tolerance: {bad}"


def test_train_step_keys_the_draws_by_the_optimizer_step():
    """The step's generator is (aug_seed, optimizer steps before the
    update), read from the optimizer once, then counted."""
    disp, pose = _port_nets()
    state = create_train_state(disp, pose, make_optimizer(disp, pose, lr=LR))
    seen = []

    def augment(generator, batch):
        seen.append(torch.rand(4, generator=generator))
        return aug.normalize_batch(batch)

    batch = _uint8_batch()
    step = make_train_step(disp, pose, state.optimizer, device="cpu", precision="fp32",
                           augment_fn=augment, aug_seed=3)
    step(batch)
    # A second step function over the same optimizer picks up at its count.
    make_train_step(disp, pose, state.optimizer, device="cpu", precision="fp32",
                    augment_fn=augment, aug_seed=3)(batch)
    assert state.step == 2
    for s, drawn in enumerate(seen):
        assert torch.equal(drawn, torch.rand(4, generator=aug.step_generator(3, s))), s
