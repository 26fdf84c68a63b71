"""The repository's other published training configurations on the port,
held against the JAX package on the CPU.

``scripts/train_resnet50_depth_256.sh`` and ``train_resnet50_pose_256.sh``
train DispNet-50 beside PoseNet-18 with the auto-mask on;
``scripts/train_nyu.sh`` trains DispNet-18 on NYUv2 pair folders (N=1,
``--folder-type pair``) with the auto-mask on and validates on NYU depth.

1. The train step of each, fp32 on both sides, from the same JAX-initialised
   variables carried across by ``from_jax_variables`` (random BatchNorm
   statistics and affine, the heads spread as in ``test_torch_step.py``):
   JAX's ``make_train_step`` against the port's, one step. Checked as
   ``test_torch_train.py`` checks ResNet-18: losses, gradients, BatchNorm
   running statistics, the parameters after Adam's first step.
   JAX's gradients are read from its Adam state after the step: the first
   moment is ``(1 - beta1) * g`` (one rounding, ~1e-7 relative), so one
   compiled program per configuration gives both.

   * ``resnet50``: DispNet-50 + PoseNet-18, B2 N2 at 64x192 (KITTI's
     aspect). At 64x96 the auto-mask leaves the geometry term fewer than
     the reference's 10000 valid elements per pair group, so that term is 0
     on both sides and its gradient path goes unchecked; at 64x192 every
     term is live.
   * ``nyu_pair``: DispNet-18 + PoseNet-18, B4 N1 at 128x160 (NYU's 1.25
     aspect; DispNet needs sides divisible by 32, so 64x80 cannot run), the
     batch read from a pair-folder tree by both packages' ``PairSet``.

   Tolerances (relative L2 per gradient tensor; BatchNorm statistics as
   ``assert_allclose``), measured on a CPU by ``JAX_PLATFORMS=cpu
   PYTHONPATH=. python tests/test_torch_configs.py`` (this file's
   ``__main__``): each side's fp32 step against its own float64 run, the
   two float64 runs against each other, and each side's movement when the
   frames move by +-1e-6 (two draws). Each tolerance is about twice the
   larger of a side's own fp32 error and its movement; statistics in
   units of ResNet-18's rtol 1e-4 / atol 1e-5 ("x"), gradients as
   encoders / decoders and heads:

   * ``resnet50``: encoders 1e-1, decoders 1.5e-2, statistics rtol 5e-4 /
     atol 5e-5. The fp32 steps lie 4.92e-2 / 2.26e-4 / 2.27x apart; in
     float64 they agree within 3.2e-6 / 2.2e-6 / 0.001x, so no fault. The
     port's fp32 lies 1.63e-2 / 3.5e-5 / 0.40x from its float64 run, JAX's
     5.01e-2 / 2.26e-4 / 2.23x: the gap is JAX's own fp32 rounding. The
     frames' +-1e-6 move the port by up to 4.62e-2 / 2.39e-3 / 2.54x and
     JAX by up to 4.50e-2 / 7.64e-3 / 2.35x: 16 Bottleneck blocks, each a
     BatchNorm on batch statistics, condition the step worse than
     ResNet-18's 8 basic blocks.
   * ``nyu_pair``: encoders 3e-2 and statistics 1e-4 / 1e-5 as
     ``test_torch_train.py``'s ResNet-18, decoders 1e-2. The fp32 steps lie
     1.79e-2 / 5.40e-3 / 0.15x apart; in float64 2.1e-5 / 1.2e-5 / 0.001x.
     The port's fp32 lies 1.62e-2 / 9.7e-4 / 0.010x from its float64 run,
     JAX's 1.63e-2 / 5.54e-3 / 0.14x (PoseNet's ``squeeze`` kernel); the
     frames' +-1e-6 move the port by up to 1.62e-2 / 1.77e-3 / 0.022x and
     JAX by up to 1.13e-2 / 1.21e-3 / 0.023x.

2. ``make_eval_depth_step(dataset="nyu")`` on the NYU nets and both
   packages' ``ValidationSet(dataset="nyu")`` batches (16-bit depth PNGs):
   rel 1e-4, as ``test_torch_train.py``'s eval-depth check.

3. The train CLI on the CPU with each script's own flags at a tiny size:
   ``--resnet-layers 50 --with-auto-mask 1 --fused-steps 2 --with-gt``
   with ``--with-pretrain 1`` from seeded torchvision-layout files, and
   ``--folder-type pair --dataset nyu --with-gt -b 4`` on
   ``tools/make_smoke_nyu.py``'s tree: logs, checkpoints, ``--resume``,
   and the grafted ImageNet tensors equal to the files'.

Every file a test writes is removed when its test or this module ends.
"""

import functools
import glob
import json
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu.data import datasets as jdatasets
from sc_sfmlearner_release_tpu.data import transforms as jtransforms
from sc_sfmlearner_release_tpu.training import state as jstate
from sc_sfmlearner_release_tpu.training import step as jstep
from sc_sfmlearner_release_tpu_torch import train as cli
from sc_sfmlearner_release_tpu_torch.data import PairSet, ValidationSet, transforms
from sc_sfmlearner_release_tpu_torch.models import DispNet, PoseNet
from sc_sfmlearner_release_tpu_torch.models.convert import (
    from_jax_variables,
    gradient_state_dict,
    to_jax_variables,
)
from sc_sfmlearner_release_tpu_torch.tools import make_smoke_nyu
from sc_sfmlearner_release_tpu_torch.training import (
    LossConfig,
    create_train_state,
    make_eval_depth_step,
    make_optimizer,
    make_train_step,
)
from test_torch_models import jax_disp_vars, jax_pose_vars
from test_torch_step import _realistic_heads
from test_torch_train import _leaves

LR = 1e-4
BETA1 = 0.9  # make_optimizer's on both sides
METRICS = ("loss", "photo_loss", "smooth_loss", "geometry_loss")
NETS = ("disp", "pose")
NYU_HW = (128, 160)
NYU_PAIRS = 4
# Per configuration: DispNet's depth and the tolerances of the module
# docstring (gradients by part; BatchNorm statistics rtol, atol).
CONFIGS = {
    "resnet50": {"layers": 50, "encoder": 1e-1, "decoder": 1.5e-2, "stats": (5e-4, 5e-5)},
    "nyu_pair": {"layers": 18, "encoder": 3e-2, "decoder": 1e-2, "stats": (1e-4, 1e-5)},
}
LOSS = LossConfig(with_auto_mask=True)
JLOSS = jstep.LossConfig(with_auto_mask=True)


def _kitti_batch(b=2, n=2, h=64, w=192, seed=0, jitter=None):
    """Noise frames at KITTI's aspect; ``jitter`` adds +-1e-6 from that seed."""
    rng = np.random.RandomState(seed)
    k = np.array([[50.0, 0, w / 2], [0, 55.0, h / 2], [0, 0, 1]], np.float32)
    batch = {"tgt": rng.rand(b, h, w, 3).astype(np.float32),
             "refs": rng.rand(b, n, h, w, 3).astype(np.float32),
             "intrinsics": np.broadcast_to(k, (b, 3, 3)).copy()}
    if jitter is not None:
        signs = np.random.RandomState(jitter)
        for key in ("tgt", "refs"):
            step = 1e-6 * signs.choice([-1.0, 1.0], batch[key].shape)
            batch[key] = (batch[key] + step).astype(np.float32)
    return batch


def _stack(samples):
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


@functools.cache
def _nyu_batches():
    """(port, JAX) x (train, validation) batches: ``NYU_PAIRS`` pairs and as
    many validation images with their 16-bit depth, read by each package's
    ``PairSet`` / ``ValidationSet(dataset="nyu")`` from one tree written by
    ``make_smoke_nyu`` (removed after)."""
    root = tempfile.mkdtemp(prefix="nyu_pairs_")
    try:
        make_smoke_nyu.make_training(root, *NYU_HW, scenes=1, pairs=NYU_PAIRS)
        rng = np.random.default_rng(0)
        out = {}
        for side, pairs, val, tf in (
                ("port", PairSet, ValidationSet, transforms.valid_transform()),
                ("jax", jdatasets.PairSet, jdatasets.ValidationSet,
                 jtransforms.valid_transform())):
            train = pairs(root, train=True, transform=tf)
            valid = val(root, transform=tf, dataset="nyu")
            assert len(train) == NYU_PAIRS and len(valid) >= NYU_PAIRS
            out[side] = (_stack([train.load(i, rng) for i in range(NYU_PAIRS)]),
                         _stack([valid.load(i, rng) for i in range(NYU_PAIRS)]))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _batch(name):
    return _kitti_batch() if name == "resnet50" else _nyu_batches()["port"][0]


@functools.cache
def _variables(layers):
    jdisp, dv = jax_disp_vars(layers)
    jpose, pv = jax_pose_vars()
    dv, pv = _realistic_heads(dv, pv)
    return jdisp, jpose, dv, pv


def _port_nets(layers):
    _, _, dv, pv = _variables(layers)
    disp_sd, pose_sd = from_jax_variables(dv, pv, layers)
    disp, pose = DispNet(layers), PoseNet(18)
    disp.load_state_dict(disp_sd)
    pose.load_state_dict(pose_sd)
    return disp, pose


@functools.cache
def _jax_step(layers):
    jdisp, jpose, _, _ = _variables(layers)
    tx = jstate.make_optimizer(lr=LR)
    return tx, jstep.make_train_step(jdisp, jpose, tx, JLOSS)


def _jax_run(name, batch=None):
    """JAX's make_train_step, one step: (metrics, grads, new batch_stats,
    new params, old params), numpy trees."""
    layers = CONFIGS[name]["layers"]
    _, _, dv, pv = _variables(layers)
    tx, step = _jax_step(layers)
    params = {"disp": dv["params"], "pose": pv["params"]}
    state = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"disp": dv["batch_stats"], "pose": pv["batch_stats"]},
        opt_state=tx.init(params), rng=jax.random.PRNGKey(0))
    batch = _batch(name) if batch is None else batch
    with jax.default_matmul_precision("highest"):
        new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m, np.float64) / (1.0 - BETA1),
                                   new.opt_state[0].mu)
    out = (metrics, grads, new.batch_stats, new.params, params)
    return jax.tree_util.tree_map(np.asarray, out)


def _port_run(name, batch=None):
    """The port's make_train_step on the same batch (fp32, CPU): (metrics,
    grads, running statistics, new params), as flax trees."""
    layers = CONFIGS[name]["layers"]
    disp, pose = _port_nets(layers)
    state = create_train_state(disp, pose, make_optimizer(disp, pose, lr=LR))
    step = make_train_step(disp, pose, state.optimizer, LOSS, device="cpu", precision="fp32")
    metrics = {k: float(v) for k, v in step(_batch(name) if batch is None else batch).items()}
    assert state.step == 1
    grads = to_jax_variables(gradient_state_dict(disp), gradient_state_dict(pose), layers)
    new = to_jax_variables(disp.state_dict(), pose.state_dict(), layers)
    tree = lambda pair, key: {"disp": pair[0][key], "pose": pair[1][key]}
    return metrics, tree(grads, "params"), tree(new, "batch_stats"), tree(new, "params")


_jax_result = functools.cache(_jax_run)
_port_result = functools.cache(_port_run)


def _is_encoder(path):
    return path.startswith("['encoder']")


def _gradient_errors(got, ref):
    """Relative L2 per tensor of trees ``got`` against ``ref`` (one net)."""
    got, ref = _leaves(got), _leaves(ref)
    assert set(got) == set(ref) and len(ref) > 20
    errors = {}
    for path, r in ref.items():
        if not np.any(r):  # the heads of scales 1-3: one scale is trained
            assert "dispconv" in path and not np.any(got[path]), path
            continue
        errors[path] = np.linalg.norm(got[path] - r) / np.linalg.norm(r)
    return errors


def _stats_errors(got, ref, rtol, atol):
    """Per BatchNorm buffer: max |got - ref| / (atol + rtol |ref|)."""
    got, ref = _leaves(got), _leaves(ref)
    assert set(got) == set(ref)
    return {p: float(np.max(np.abs(got[p] - r) / (atol + rtol * np.abs(r))))
            for p, r in ref.items()}


def test_pair_batches_equal_jax():
    """Both packages' PairSet and NYU ValidationSet read the same arrays
    (the port's JPEG and PNG codecs against the JAX package's readers)."""
    port, ref = _nyu_batches()["port"], _nyu_batches()["jax"]
    for got, want in zip(port, ref):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    train, valid = port
    assert train["refs"].shape == (NYU_PAIRS, 1, *NYU_HW, 3)
    assert valid["depth"].shape == (NYU_PAIRS, *NYU_HW) and valid["depth"].min() >= 1.0


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_losses_match_jax(name):
    ref, got = _jax_result(name)[0], _port_result(name)[0]
    for k in METRICS:
        assert float(ref[k]) > 0, k  # every term live
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_gradients_match_jax(name, net):
    errors = _gradient_errors(_port_result(name)[1][net], _jax_result(name)[1][net])
    assert len(errors) > 20
    tol = lambda path: CONFIGS[name]["encoder" if _is_encoder(path) else "decoder"]
    bad = {p: e for p, e in errors.items() if not e <= tol(p)}
    assert not bad, f"relative L2 above tolerance: {bad}"


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_batch_stats_match_jax(name, net):
    rtol, atol = CONFIGS[name]["stats"]
    errors = _stats_errors(_port_result(name)[2][net], _jax_result(name)[2][net], rtol, atol)
    bad = {p: e for p, e in errors.items() if not e <= 1.0}
    assert not bad, f"BatchNorm statistics outside rtol {rtol}, atol {atol}: {bad}"
    # The running variance moves towards the batch's biased variance, as
    # flax's: at the deepest stage (n values per channel: resnet50 6 frames
    # or 8 pairs of 2x6, 72 or 96; nyu_pair 8 frames or pairs of 4x5, 160)
    # torch's unbiased n/(n-1) would lie more than twice as far from JAX's.
    ref = _leaves(_jax_result(name)[2][net])
    old = _leaves({"disp": _variables(CONFIGS[name]["layers"])[2]["batch_stats"],
                   "pose": _variables(CONFIGS[name]["layers"])[3]["batch_stats"]}[net])
    batch = _batch(name)
    frames = batch["tgt"].shape[0] * (1 + batch["refs"].shape[1])
    pairs = 2 * batch["refs"].shape[1] * batch["tgt"].shape[0]
    h, w = batch["tgt"].shape[1:3]
    n = (frames if net == "disp" else pairs) * (h // 32) * (w // 32)
    path = next(p for p in ref if "layer4_1" in p and "bn2" in p and "var" in p)
    batch_var = (ref[path] - 0.9 * old[path]) / 0.1
    unbiased = 0.9 * old[path] + 0.1 * batch_var * n / (n - 1)
    got = _leaves(_port_result(name)[2][net])[path]
    assert np.median(np.abs(got - ref[path])) < 0.5 * np.median(np.abs(unbiased - ref[path]))


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_params_after_adam_match_jax(name, net):
    """As ``test_torch_train.py``: Adam's first step moves each parameter by
    about +-lr whatever |g|; where |g| > 1e-6 and the two gradients agree
    within 10% (at least half of each tensor's live elements), the moves
    agree within 1e-3 * lr plus two roundings of the parameter."""
    _, grads, _, new_ref, old = _jax_result(name)
    ref, g, before = _leaves(new_ref[net]), _leaves(grads[net]), _leaves(old[net])
    got, g_port = _leaves(_port_result(name)[3][net]), _leaves(_port_result(name)[1][net])
    for path, r in ref.items():
        moved_ref, moved = r - before[path], got[path] - before[path]
        ulps = 2.0**-22 * max(1.0, np.abs(before[path]).max())
        assert np.abs(moved).max() <= LR + ulps, path
        assert np.abs(moved_ref).max() <= LR + ulps, path
        if not np.any(g[path]):
            assert not np.any(moved), path
            continue
        live = np.abs(g[path]) > 1e-6
        firm = live & (np.abs(g_port[path] - g[path]) < 0.1 * np.abs(g[path]))
        assert firm.sum() >= 0.5 * live.sum(), (path, firm.sum(), live.sum())
        np.testing.assert_allclose(moved[firm], moved_ref[firm], rtol=0,
                                   atol=1e-3 * LR + ulps, err_msg=path)


@functools.cache
def _jax_eval_depth_step():
    return jstep.make_eval_depth_step(_variables(18)[0], dataset="nyu")


def test_eval_depth_step_nyu_matches_jax():
    """NYU's depth metrics on the pair configuration's DispNet-18 and the
    tree's 16-bit ground truth, rel 1e-4."""
    _, _, dv, _ = _variables(18)
    valid, jvalid = _nyu_batches()["port"][1], _nyu_batches()["jax"][1]
    state = jstate.TrainState(step=None, params={"disp": dv["params"]},
                              batch_stats={"disp": dv["batch_stats"]}, opt_state=None, rng=None)
    with jax.default_matmul_precision("highest"):
        ref = _jax_eval_depth_step()(state, {k: jnp.asarray(v) for k, v in jvalid.items()})
    disp, _ = _port_nets(18)
    got = make_eval_depth_step(disp, "nyu", device="cpu", precision="fp32")(valid)
    assert set(got) == set(ref) and float(ref["abs_rel"]) > 0
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4, err_msg=k)


# --- 3. The train CLI with the scripts' flags, tiny trees, CPU. -----------

CLI_HW = (64, 128)
BASE = ["--device", "cpu", "--precision", "fp32", "-j", "2", "--no-tensorboard",
        "--log-style", "line", "--val-batches", "1", "--log-output"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the cores: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The module's trees, ImageNet files and runs (``checkpoints/`` lands
    here); removed with the module."""
    path = tmp_path_factory.mktemp("configs")
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(autouse=True)
def _remove_runs(request):
    """A test's runs (ResNet-50's hold ~0.5 GB each) go when it ends."""
    yield
    if "workdir" in request.fixturenames:
        shutil.rmtree(request.getfixturevalue("workdir") / "checkpoints", ignore_errors=True)


@pytest.fixture(scope="module")
def imagenet(workdir):
    """``--imagenet-weights-dir`` with ``chip_smoke.py``'s seeded
    torchvision-layout ``resnet50.pth`` and ``resnet18.pth`` (the ResNet-50
    scripts graft both: PoseNet is ResNet-18): (directory, {layers: state
    dict})."""
    import chip_smoke

    d = chip_smoke.write_imagenet_files(str(workdir / "imagenet"), 0)
    return d, {layers: torch.load(os.path.join(d, f"resnet{layers}.pth"), weights_only=True)
               for layers in (50, 18)}


@pytest.fixture(scope="module")
def kitti_tree(workdir):
    """A KITTI-format sequence tree at 64x128 (two train scenes, a val scene
    with ``.npy`` ground truth)."""
    from sc_sfmlearner_release_tpu_torch.data import jpeg_io

    root = workdir / "kitti"
    h, w = CLI_HW
    rng = np.random.RandomState(0)
    k = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]])
    for scene, n in (("s1", 6), ("s2", 5), ("v1", 4)):
        d = root / scene
        d.mkdir(parents=True)
        for i in range(n):
            jpeg_io.encode(str(d / f"{i:07d}.jpg"), (rng.rand(h, w, 3) * 255).astype(np.uint8))
        np.savetxt(d / "cam.txt", k)
    for i in range(4):
        np.save(root / "v1" / f"{i:07d}.npy", rng.uniform(1, 80, (h, w)).astype(np.float32))
    (root / "train.txt").write_text("s1\ns2\n")
    (root / "val.txt").write_text("v1\n")
    return str(root)


@pytest.fixture(scope="module")
def nyu_tree(workdir):
    """``tools/make_smoke_nyu.py``'s pair-folder tree at its defaults
    (64x96, two scenes of 6 pairs, a val scene with 16-bit depth PNGs)."""
    root = workdir / "nyu"
    make_smoke_nyu.main([str(root)])
    return str(root / "rectified")


def _run(workdir, argv, monkeypatch):
    monkeypatch.chdir(workdir)
    assert cli.main(argv) == 0
    (path,) = glob.glob(os.path.join(str(workdir), "checkpoints",
                                     argv[argv.index("--name") + 1], "*"))
    return path


def _rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def _check_run(path, steps, epochs, first_step=1):
    """The logs and checkpoints of a run of ``steps`` optimizer steps over
    ``epochs`` epochs, its first step numbered ``first_step``."""
    full = _rows(os.path.join(path, "progress_log_full.csv"))
    assert full[0] == ["train_loss", "photo_loss", "smooth_loss", "geometry_consistency_loss"]
    assert len(full) == 1 + steps and all(np.isfinite(float(v)) for r in full[1:] for v in r)
    summary = _rows(os.path.join(path, "progress_log_summary.csv"))
    assert summary[0] == ["train_loss", "validation_loss"] and len(summary) == 1 + epochs
    assert all(0 < float(r[1]) < 10 for r in summary[1:]), summary  # abs_rel of the depths
    times = _rows(os.path.join(path, cli.TIME_LOG))
    assert [int(r[0]) for r in times[1:]] == list(range(first_step, first_step + steps))
    assert set(os.listdir(path)) >= {
        "dispnet_checkpoint.pth.tar", "exp_pose_checkpoint.pth.tar",
        "dispnet_model_best.pth.tar", "exp_pose_model_best.pth.tar", "train_state.pth.tar",
        "meta.json"}
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["step"] == first_step - 1 + steps


def _state_dict(run, name):
    return torch.load(os.path.join(run, f"{name}_checkpoint.pth.tar"),
                      weights_only=True)["state_dict"]


def test_resnet50_depth_cli_fused_with_gt_and_resume(kitti_tree, imagenet, workdir,
                                                     monkeypatch):
    """``train_resnet50_depth_256.sh``'s flags (``--fused-steps`` at 2, B2):
    2 epochs of 2 steps, one dispatch each, ``--with-gt`` validation; then a
    ``--resume`` epoch continues the step and Adam's state."""
    weights, _ = imagenet
    flags = [kitti_tree, "--resnet-layers", "50", "--num-scales", "1", "-b", "2", "-s0.1",
             "-c0.5", "--sequence-length", "3", "--with-ssim", "1", "--with-mask", "1",
             "--with-auto-mask", "1", "--with-pretrain", "1", "--imagenet-weights-dir",
             weights, "--fused-steps", "2", "--with-gt", "--epoch-size", "2"] + BASE
    run = _run(workdir, flags + ["--name", "r50", "--epochs", "2"], monkeypatch)
    _check_run(run, steps=4, epochs=2)
    assert _state_dict(run, "dispnet")["encoder.encoder.layer4.2.conv3.weight"].shape == (
        2048, 512, 1, 1)
    saved = torch.load(os.path.join(run, "train_state.pth.tar"), weights_only=True)
    resumed = _run(workdir, flags + ["--name", "r50_resumed", "--epochs", "1", "--resume", run],
                   monkeypatch)
    _check_run(resumed, steps=2, epochs=1, first_step=5)
    after = torch.load(os.path.join(resumed, "train_state.pth.tar"), weights_only=True)
    assert after["step"] == 6 and saved["step"] == 4
    for i, moments in saved["optimizer"]["state"].items():
        assert float(after["optimizer"]["state"][i]["step"]) == 6
        assert not torch.equal(after["optimizer"]["state"][i]["exp_avg_sq"],
                               moments["exp_avg_sq"])


def test_resnet50_with_pretrain_grafts_the_files_tensors(kitti_tree, imagenet, workdir,
                                                         monkeypatch):
    """``--with-pretrain 1`` at ResNet-50: DispNet's encoder takes
    ``resnet50.pth`` (the Bottlenecks and their downsamples), PoseNet's
    ``resnet18.pth`` with its first convolution spread over the pair's 6
    channels; at ``--lr 0`` the weights stay as grafted."""
    weights, files = imagenet
    run = _run(workdir, [kitti_tree, "--name", "r50_graft", "--resnet-layers", "50",
                         "--with-pretrain", "1", "--imagenet-weights-dir", weights, "-b", "2",
                         "--epochs", "1", "--epoch-size", "1", "--lr", "0"] + BASE, monkeypatch)
    disp, pose = _state_dict(run, "dispnet"), _state_dict(run, "exp_pose")
    r50, r18 = files[50], files[18]
    for key in ("conv1.weight", "layer1.0.downsample.0.weight", "layer3.5.conv2.weight",
                "layer4.2.conv3.weight", "layer4.2.bn3.weight", "layer4.2.bn3.bias"):
        assert torch.equal(disp[f"encoder.encoder.{key}"], r50[key]), key
    conv1 = r18["conv1.weight"]
    assert torch.equal(pose["encoder.encoder.conv1.weight"], torch.cat([conv1, conv1], 1) / 2)
    assert torch.equal(pose["encoder.encoder.layer4.1.conv2.weight"],
                       r18["layer4.1.conv2.weight"])


def test_nyu_pair_cli_with_gt_and_resume(nyu_tree, imagenet, workdir, monkeypatch):
    """``train_nyu.sh``'s flags at B4 (``--epoch-size 0``: the whole set, 12
    pairs in 3 batches): 2 epochs, NYU ``--with-gt`` validation on the
    16-bit depth PNGs, ``--with-pretrain 1``; then a ``--resume`` epoch."""
    weights, _ = imagenet
    flags = [nyu_tree, "--folder-type", "pair", "--resnet-layers", "18", "--num-scales", "1",
             "-b", "4", "-s0.1", "-c0.5", "--epoch-size", "0", "--with-ssim", "1",
             "--with-mask", "1", "--with-auto-mask", "1", "--with-pretrain", "1",
             "--imagenet-weights-dir", weights, "--with-gt", "--dataset", "nyu"] + BASE
    run = _run(workdir, flags + ["--name", "nyu", "--epochs", "2"], monkeypatch)
    _check_run(run, steps=6, epochs=2)
    resumed = _run(workdir, flags + ["--name", "nyu_resumed", "--epochs", "1", "--resume", run],
                   monkeypatch)
    _check_run(resumed, steps=3, epochs=1, first_step=7)


# --- The measurements behind the tolerances (not a test). ----------------

def _float64_port_run(name):
    """The port's step in float64: nets, batch and every cast to fp32
    (BatchNorm, the heads, the warp's source) in float64 for this run."""
    layers = CONFIGS[name]["layers"]
    disp, pose = (net.double() for net in _port_nets(layers))
    to_float = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else to_float(t, *a,
                                                                                          **k)
    try:
        from sc_sfmlearner_release_tpu_torch.training.step import total_loss

        batch = {k: torch.from_numpy(v).double() for k, v in _batch(name).items()}
        loss, metrics = total_loss(disp, pose, batch, LOSS, precision="fp32", train=True)
        loss.backward()
    finally:
        torch.Tensor.float = to_float
    grads = to_jax_variables(gradient_state_dict(disp), gradient_state_dict(pose), layers)
    new = to_jax_variables(disp.state_dict(), pose.state_dict(), layers)
    tree = lambda pair, key: {"disp": pair[0][key], "pose": pair[1][key]}
    return {k: v.item() for k, v in metrics.items()}, tree(grads, "params"), tree(new,
                                                                                 "batch_stats")


def _float64_jax_run(name):
    """JAX's loss gradient and new statistics with x64 on and the networks'
    dtype float64."""
    layers = CONFIGS[name]["layers"]
    jdisp, jpose, dv, pv = _variables(layers)
    with jax.enable_x64(True):
        jdisp, jpose = jdisp.clone(dtype=jnp.float64), jpose.clone(dtype=jnp.float64)
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        params = f64({"disp": dv["params"], "pose": pv["params"]})
        stats = f64({"disp": dv["batch_stats"], "pose": pv["batch_stats"]})
        batch = f64(_batch(name))
        run = jax.jit(jax.grad(lambda p: jstep._total_loss(jdisp, jpose, p, stats, batch,
                                                           JLOSS, True), has_aux=True))
        with jax.default_matmul_precision("highest"):
            grads, (metrics, new_stats) = run(params)
        return jax.tree_util.tree_map(np.asarray, (metrics, grads, new_stats))


def _report(label, got, ref, name):
    """Worst gradient errors by part and statistics error, in units of the
    ResNet-18 statistics tolerance, of ``got`` against ``ref``
    ((metrics, grads, stats) each)."""
    worst = {"encoders": 0.0, "decoders": 0.0}
    for net in NETS:
        for path, e in _gradient_errors(got[1][net], ref[1][net]).items():
            part = "encoders" if _is_encoder(path) else "decoders"
            worst[part] = max(worst[part], e)
    stats = max(max(_stats_errors(got[2][n], ref[2][n], 1e-4, 1e-5).values()) for n in NETS)
    loss = max(abs(float(got[0][k]) - float(ref[0][k])) / abs(float(ref[0][k])) for k in METRICS)
    print(f"{name} {label}: losses rel {loss:.2e}, gradients rel L2 encoders "
          f"{worst['encoders']:.3e}, decoders {worst['decoders']:.3e}, statistics "
          f"{stats:.3f}x (rtol 1e-4, atol 1e-5)", flush=True)


def measure(name):
    """Prints the measurements of the module docstring for ``name``."""
    port, ref = _port_run(name)[:3], _jax_run(name)[:3]
    _report("port fp32 vs JAX fp32", port, ref, name)
    port64, ref64 = _float64_port_run(name), _float64_jax_run(name)
    _report("port float64 vs JAX float64", port64, ref64, name)
    _report("port fp32 vs its float64", port, port64, name)
    _report("JAX fp32 vs its float64", ref, ref64, name)
    for draw in (99, 7):
        if name == "resnet50":
            batch = _kitti_batch(jitter=draw)
        else:
            batch = dict(_batch(name))
            signs = np.random.RandomState(draw)
            for key in ("tgt", "refs"):
                step = 1e-6 * signs.choice([-1.0, 1.0], batch[key].shape)
                batch[key] = (batch[key] + step).astype(np.float32)
        _report(f"port, frames +-1e-6 (draw {draw})", _port_run(name, batch)[:3], port, name)
        _report(f"JAX, frames +-1e-6 (draw {draw})", _jax_run(name, batch)[:3], ref, name)


def card_gate_sensitivity():
    """The CPU's own movement under +-1e-6 frames (two draws) at the inputs
    of ``chip_smoke.py``'s fp32 card-against-CPU checks in ``[configs]``:
    DispNet-50 at ``CHECK_SHAPE`` and the NYU pair step at
    ``NYU_CHECK_SHAPE``, the scripts' auto-mask on. Prints the worst
    gradient rel L2 by part."""
    import copy

    import chip_smoke as cs

    b, n, h, w = cs.NYU_CHECK_SHAPE
    for label, seed, layers, shape, intrinsics in (
            ("resnet50", 41, cs.R50, cs.CHECK_SHAPE, None),
            ("nyu_pair", 51, 18, cs.NYU_CHECK_SHAPE, cs.nyu_intrinsics(b, h, w))):
        nets, batch = cs.check_step_inputs(seed, np.random.RandomState(seed), layers, shape,
                                           intrinsics)
        runs = []
        for draw in (None, 99, 7):
            twins = copy.deepcopy(nets)
            frames = dict(batch)
            if draw is not None:
                signs = np.random.RandomState(draw)
                for key in ("tgt", "refs"):
                    step = 1e-6 * signs.choice([-1.0, 1.0], frames[key].shape)
                    frames[key] = (frames[key] + step).astype(np.float32)
            make_train_step(*twins, make_optimizer(*twins), LOSS, device="cpu",
                            precision="fp32")(frames)
            runs.append(cs.grads_by_name(*twins))
        for draw, got in zip((99, 7), runs[1:]):
            worst = {"encoders": 0.0, "decoders": 0.0}
            for k, ref in runs[0].items():
                part = "encoders" if ".encoder." in k else "decoders"
                e = ((got[k] - ref).norm() / ref.norm().clamp_min(1e-30)).item()
                worst[part] = max(worst[part], e)
            print(f"card gate {label} at {shape}, CPU frames +-1e-6 (draw {draw}): gradients "
                  f"rel L2 encoders {worst['encoders']:.3e}, decoders {worst['decoders']:.3e}",
                  flush=True)


if __name__ == "__main__":
    import sys

    for config in sys.argv[1:] or list(CONFIGS) + ["card-gates"]:
        card_gate_sensitivity() if config == "card-gates" else measure(config)
