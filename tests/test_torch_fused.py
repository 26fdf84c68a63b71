"""The port's ``make_train_step(fused_steps=K)`` and the train CLI's
``--fused-steps`` and ``--profile-dir``, on the CPU (fp32), where K fused
steps are K eager steps.

At ``test_torch_train.py``'s size (ResNet-18, B2 N2 64x96, JAX-initialised
variables with spread heads):

  * the port's ``fused_steps=2`` against two calls of JAX's unfused
    ``make_train_step`` (that file's jitted program; JAX's own fused step
    is held to its sequential one by its slow test, whose compile alone
    takes minutes on a CPU). Losses per step rel 1e-4, as one step's.
    Parameters: every element within 2 * lr * steps, the elementwise bound
    of that slow test (``tests/test_training.py::
    test_fused_steps_match_sequential``): each Adam update moves a
    parameter by about lr whatever its gradient, so where a gradient is
    near 0 the two sides' rounding can flip its sign. The disagreement's L2
    norm stays under 20% of the two steps' update, not that test's 2%,
    which holds one framework's reduction orders against each other. Here
    the loss is kinky at random init (``test_torch_train.py``) and the two
    frameworks' gradients differ by up to 3e-2 per tensor, so more signs
    flip: measured on a CPU, 1.7-3.7% after one step and 3.9-9.2% after
    two (disp, pose; one or all torch threads), against 42-135% for faults
    of the fused loop (the two batches swapped, one batch twice, a third
    step);
  * ``fused_steps=3`` with the device augmentation on uint8 frames against
    three unfused calls: on the CPU the same eager ops, so equal metrics,
    step count and parameters.

The CLI on the packed tree of ``test_torch_train_cli.py`` with ``--packed
--device-augment``: three epochs of two steps with ``--fused-steps 2``
beside two epochs unfused (equal losses: same batches, same draws), one
log row per optimizer step, ``--checkpoint-freq 3`` saving where a
dispatch crosses a multiple, a trace of exactly one dispatch from
``--profile-dir``, and a ``--resume`` epoch with K clamped to the epoch
size.
"""

import contextlib
import copy
import functools
import glob
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu_torch import train as cli
from sc_sfmlearner_release_tpu_torch.data.device_augment import (
    AugmentConfig, make_device_augment, step_generator,
)
from sc_sfmlearner_release_tpu_torch.models.convert import to_jax_variables
from sc_sfmlearner_release_tpu_torch.training import (
    LossConfig, make_optimizer, make_train_step,
)
from sc_sfmlearner_release_tpu_torch.training.state import optimizer_step
from sc_sfmlearner_release_tpu_torch.training.step import METRIC_KEYS
from sc_sfmlearner_release_tpu_torch.utils import StepTimer, trace
from test_torch_train import (
    LR, NETS, _batch, _jax_program, _jax_state, _leaves, _port_nets,
)
from test_torch_train_cli import BASE, _one_torch_thread, _rows, _run, tree  # noqa: F401

K_JAX = 2
SEEDS = (0, 1)


@functools.cache
def _jax_two_steps():
    """Two calls of JAX's unfused step: (losses [2], params, initial params)."""
    tx, run = _jax_program()
    state = _jax_state(tx)
    start = state.params
    losses = []
    with jax.default_matmul_precision("highest"):
        for seed in SEEDS:
            metrics, _, state = run(state, {k: jnp.asarray(v) for k, v in _batch(seed).items()})
            losses.append({k: float(metrics[k]) for k in METRIC_KEYS})
    return losses, jax.tree_util.tree_map(np.asarray, (state.params, start))


@functools.cache
def _port_fused_two_steps():
    """The port's fused_steps=2 on the same two batches: (metrics, params, steps)."""
    disp, pose = _port_nets()
    optimizer = make_optimizer(disp, pose, lr=LR)
    step = make_train_step(disp, pose, optimizer, LossConfig(), device="cpu",
                           precision="fp32", fused_steps=K_JAX)
    batches = [_batch(seed) for seed in SEEDS]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    metrics = {k: v.numpy() for k, v in step(stacked).items()}
    new = to_jax_variables(disp.state_dict(), pose.state_dict(), 18)
    return metrics, {net: new[i]["params"] for i, net in enumerate(NETS)}, \
        optimizer_step(optimizer)


def test_fused_losses_match_two_jax_steps():
    ref, _ = _jax_two_steps()
    got, _, steps = _port_fused_two_steps()
    assert steps == K_JAX
    for k in METRIC_KEYS:
        assert got[k].shape == (K_JAX,), k
        np.testing.assert_allclose(got[k], [r[k] for r in ref], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("net", NETS)
def test_fused_params_match_two_jax_steps(net):
    _, (ref_params, start) = _jax_two_steps()
    ref, before = _leaves(ref_params[net]), _leaves(start[net])
    got = _leaves(_port_fused_two_steps()[1][net])
    assert set(got) == set(ref) and len(ref) > 20
    max_div = 2 * LR * K_JAX
    diff_sq = upd_sq = 0.0
    for path, r in ref.items():
        ulps = 2.0**-22 * max(1.0, np.abs(before[path]).max())  # rounding of p + move
        assert np.abs(got[path] - r).max() <= max_div + ulps, path
        diff_sq += float(np.sum((got[path] - r) ** 2))
        upd_sq += float(np.sum((r - before[path]) ** 2))
    assert upd_sq > 0
    rel = np.sqrt(diff_sq / upd_sq)
    assert rel < 0.2, f"fused port / unfused JAX trajectories diverge: {rel:.4f}"


def _uint8_batches(k, seed=0, b=2, n=2, h=64, w=96):
    rng = np.random.RandomState(seed)
    intr = np.array([[50.0, 0, w / 2], [0, 55.0, h / 2], [0, 0, 1]], np.float32)
    return {"tgt": rng.randint(0, 256, (k, b, h, w, 3)).astype(np.uint8),
            "refs": rng.randint(0, 256, (k, b, n, h, w, 3)).astype(np.uint8),
            "intrinsics": np.broadcast_to(intr, (k, b, 3, 3)).copy()}


@functools.cache
def _augmented_runs():
    """fused_steps=3 with the device augmentation on uint8 frames, and three
    unfused calls from the same networks: (fused metrics, unfused metrics,
    fused nets, unfused nets, fused steps, unfused steps)."""
    nets = _port_nets()
    twins = copy.deepcopy(nets)
    augment = make_device_augment(AugmentConfig())
    batches = _uint8_batches(3)
    runs = []
    for fused, pair in ((3, nets), (1, twins)):
        optimizer = make_optimizer(*pair, lr=LR)
        step = make_train_step(*pair, optimizer, LossConfig(), device="cpu", precision="fp32",
                               augment_fn=augment, aug_seed=7, fused_steps=fused)
        if fused == 3:
            metrics = step(batches)
        else:
            per_step = [step({k: v[i] for k, v in batches.items()}) for i in range(3)]
            metrics = {k: torch.stack([m[k] for m in per_step]) for k in METRIC_KEYS}
        runs.append((metrics, pair, optimizer_step(optimizer)))
    return runs


def test_fused_augmented_steps_equal_unfused_calls():
    (fused, nets, steps), (unfused, twins, twin_steps) = _augmented_runs()
    assert steps == twin_steps == 3
    for k in METRIC_KEYS:
        assert torch.equal(fused[k], unfused[k]), k
    for a, b in zip(nets, twins):
        for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), name


def test_fused_metrics_have_a_leading_step_axis():
    (fused, _, _), _ = _augmented_runs()
    assert tuple(fused) == METRIC_KEYS
    for k, v in fused.items():
        assert v.shape == (3,) and v.dtype == torch.float32 and torch.isfinite(v).all(), k
    # Three distinct batches and draws: three distinct losses.
    assert len(set(fused["loss"].tolist())) == 3


def test_fused_step_checks_its_input():
    disp, pose = _port_nets()
    step = make_train_step(disp, pose, make_optimizer(disp, pose), device="cpu",
                           precision="fp32", fused_steps=3)
    with pytest.raises(ValueError, match="expected 3 batches stacked"):
        step(_uint8_batches(2))
    with pytest.raises(ValueError, match="fused_steps must be >= 1"):
        make_train_step(disp, pose, make_optimizer(disp, pose), device="cpu", fused_steps=0)


def test_make_optimizer_passes_capturable_through():
    disp, pose = torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)
    assert not make_optimizer(disp, pose).param_groups[0]["capturable"]
    assert make_optimizer(disp, pose, capturable=True).param_groups[0]["capturable"]


def test_host_map_and_apply_map_are_the_augmentation():
    """The fused step's split of the augmentation (the map made on the host,
    applied on the device) is the augmentation itself."""
    augment = make_device_augment(AugmentConfig())
    batch = {k: torch.from_numpy(v[0]) for k, v in _uint8_batches(1, seed=3).items()}
    want = augment(step_generator(5, 11), batch)
    packed = augment.host_map(step_generator(5, 11), 2, 64, 96)
    assert packed.shape == (2, 96 + 64 + 5) and packed.dtype == torch.float32
    got = augment.apply_map(batch, packed)
    for k in ("tgt", "refs", "intrinsics"):
        assert torch.equal(got[k], want[k]), k


def test_step_timer_and_trace_without_a_directory():
    timer = StepTimer(skip=1)
    for _ in range(3):
        with trace(None), timer:
            pass
    assert len(timer.times) == 2 and timer.p50 >= 0.0 and "steps=2" in timer.summary()


# ---- the CLI -------------------------------------------------------------

CLI_ARGS = ["--packed", "--device-augment", "--with-pretrain", "0", "--with-auto-mask", "1"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The module's runs, removed after it: each writes ~0.5 GB of
    checkpoints (full-width ResNet-18 weights and Adam state)."""
    path = tmp_path_factory.mktemp("fused_runs")
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module")
def eager_run(tree, workdir):
    with pytest.MonkeyPatch.context() as m:
        return _run(workdir, [tree, "--name", "eager", "--epochs", "2"] + CLI_ARGS + BASE, m)


@pytest.fixture(scope="module")
def fused_run(tree, workdir):
    """Three epochs of one dispatch of 2 steps, saving every 3 steps and
    profiling one dispatch: (experiment directory, (step, epoch) of every
    save, trace directory)."""
    saves = []
    trace_dir = os.path.join(str(workdir), "trace")
    real_save = cli.save_checkpoint

    def save(save_path, state, *args, **kwargs):
        saves.append((state.step, kwargs["epoch"]))
        real_save(save_path, state, *args, **kwargs)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(cli, "save_checkpoint", save)
        path = _run(workdir, [tree, "--name", "fused", "--epochs", "3", "--fused-steps", "2",
                              "--checkpoint-freq", "3", "--profile-dir", trace_dir]
                    + CLI_ARGS + BASE, m)
    return path, saves, trace_dir


def test_fused_cli_logs_one_row_per_optimizer_step(fused_run):
    path, _, _ = fused_run
    full = _rows(os.path.join(path, "progress_log_full.csv"))
    assert len(full) == 1 + 6 and all(np.isfinite(float(v)) for r in full[1:] for v in r)
    times = _rows(os.path.join(path, cli.TIME_LOG))
    assert [int(r[0]) for r in times[1:]] == [1, 2, 3, 4, 5, 6]
    # Each dispatch's two rows share its time and wait.
    assert all(times[i][1:] == times[i + 1][1:] for i in (1, 3, 5))
    assert len(_rows(os.path.join(path, "progress_log_summary.csv"))) == 1 + 3
    assert json.load(open(os.path.join(path, "meta.json"))) == {"step": 6, "epoch": 3}


def test_fused_cli_losses_equal_the_unfused_cli(fused_run, eager_run):
    """The same batches in the same order with the same draws (the fused
    run's first two epochs against the unfused run's two)."""
    fused = _rows(os.path.join(fused_run[0], "progress_log_full.csv"))
    eager = _rows(os.path.join(eager_run, "progress_log_full.csv"))
    assert len(eager) == 1 + 4 and fused[:5] == eager


def test_fused_cli_checkpoints_where_a_multiple_is_crossed(fused_run):
    # Dispatches end at steps 2, 4 and 6: 4 crosses 3 and 6 crosses 6 (saved
    # under the running epoch); every epoch's end saves too (under the next).
    assert fused_run[1] == [(2, 1), (4, 1), (4, 2), (6, 2), (6, 3)]


@pytest.fixture(scope="module")
def resumed_run(tree, workdir, fused_run):
    """One epoch resumed from the fused run with ``--fused-steps 5``, more
    than the epoch's 2 steps: (experiment directory, standard output)."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as m, contextlib.redirect_stdout(out):
        path = _run(workdir, [tree, "--name", "fused_resumed", "--epochs", "1",
                              "--fused-steps", "5", "--resume", fused_run[0]]
                    + CLI_ARGS + BASE, m)
    return path, out.getvalue()


def test_fused_cli_clamps_k_to_the_epoch_size(resumed_run):
    path, out = resumed_run
    assert "=> clamping --fused-steps 5 to epoch size 2" in out
    times = _rows(os.path.join(path, cli.TIME_LOG))
    assert all(r[1:] == times[1][1:] for r in times[1:])  # one dispatch of 2 steps


def test_fused_cli_resume_continues_the_step(resumed_run):
    times = _rows(os.path.join(resumed_run[0], cli.TIME_LOG))
    assert [int(r[0]) for r in times[1:]] == [7, 8]
    after = torch.load(os.path.join(resumed_run[0], "train_state.pth.tar"), weights_only=True)
    assert after["step"] == 8


def test_profile_dir_traces_exactly_one_dispatch(fused_run):
    (trace_file,) = glob.glob(os.path.join(fused_run[2], "*.pt.trace.json"))
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    # One dispatch of --fused-steps 2: two Adam updates, two backward passes.
    assert sum(n.startswith("Optimizer.step#Adam.step") for n in names) == 2
    assert sum(n.startswith("Optimizer.zero_grad#Adam.zero_grad") for n in names) == 2
