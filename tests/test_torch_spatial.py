"""The port's width sharding (``--spatial-shards``: ``parallel/spatial.py``
and the halo collectives of ``parallel/distributed.py``) on gloo CPU ranks
against one process on the whole batch and against the JAX package's step
over a data x spatial mesh (``make_mesh_2d``).

One spawn of 2 ranks at S = 2 (``tests/torch_dist_worker.py::
spatial_checks``) and one of 4 ranks at data 2 x spatial 2
(``spatial_step``) compute every check's result on their columns, while
this process computes the references:

  (a) the halo exchange, the all-gather along W and the spatial sum, and
      the halo-aware conv (7x7/s2/p3, 3x3/s1/p1, 3x3/s2/p1, 1x1/s2, 1x1/s1),
      max-pool (3x3/s2/p1) and reflect pad (shards of 8 columns and of 1),
      outputs and input gradients in float64 against the whole-image op:
      1e-6 of the largest value;
  (b) the fp32 train step (ResNet-18, B2 N2 64x128, device augmentation)
      at S = 2 and at data 2 x spatial 2 against one process on the
      global batch, within ``tests/test_torch_distributed.py``'s bounds:
      losses rel 1e-5, gradients rel L2 5e-3 (encoders 3e-2), BatchNorm
      statistics rel 1e-4 (abs 1e-5); every rank's networks bit-identical;
  (c) the S = 2 step from JAX-initialised nets against JAX's
      ``make_train_step`` over ``make_mesh_2d(2, jax.devices()[:2])``:
      every metric within rtol 2e-4 (``tests/test_parallel_spatial.py``'s
      bound);
  (d) every shard's loader gives its data group's rows at full width,
      and the shards' columns of the augmented batch
      (``distributed.local_frames``), concatenated, equal one process's
      augmentation bit for bit;
  (e) the eval steps on a padded batch (global 2, ``n_valid`` 1) equal one
      process's within rel 1e-4.
"""

import functools
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sc_sfmlearner_release_tpu.parallel import make_mesh_2d, replicate, shard_batch
from sc_sfmlearner_release_tpu.training import state as jstate
from sc_sfmlearner_release_tpu.training import step as jstep
from sc_sfmlearner_release_tpu_torch.data import BatchLoader
from sc_sfmlearner_release_tpu_torch.data.device_augment import (
    AugmentConfig, make_device_augment, step_generator,
)
from sc_sfmlearner_release_tpu_torch.models.convert import from_jax_variables
from sc_sfmlearner_release_tpu_torch.parallel import distributed
from sc_sfmlearner_release_tpu_torch.parallel.spatial import halo_widths, reflect_pad1
from sc_sfmlearner_release_tpu_torch.training import (
    LossConfig, make_eval_depth_step, make_eval_step,
)
from test_torch_train import LR, METRICS, _jax_state, _variables
from torch_dist_worker import ImageSet, nets_from, seeded_nets, step_run

B, N, H, W = 2, 2, 64, 128
S = 2
N_VALID = 1
CONVS = {"conv7s2": (7, 2, 3), "conv3s1": (3, 1, 1), "conv3s2": (3, 2, 1),
         "conv1s2": (1, 2, 0), "conv1s1": (1, 1, 0)}


def _intrinsics(b):
    k = np.array([[50.0, 0, W / 2], [0, 55.0, H / 2], [0, 0, 1]], np.float32)
    return np.broadcast_to(k, (b, 3, 3)).copy()


@functools.cache
def _inputs() -> dict:
    rng = np.random.RandomState(11)
    g = torch.Generator().manual_seed(11)
    rand = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float64)
    ops = {}
    for name, (k, s, p) in CONVS.items():
        ops[name] = {"x": rand(2, 3, 5, 16), "conv": (k, s, p), "weight": rand(4, 3, k, k),
                     "bias": rand(4)}
    ops["max_pool"] = {"x": rand(2, 3, 5, 16).relu()}
    ops["reflect8"] = {"x": rand(2, 3, 5, 16)}
    ops["reflect1"] = {"x": rand(2, 3, 5, 2)}
    ops["halo"] = {"x": rand(2, 3, 5, 16)}
    ops["gather"] = {"x": rand(2, 3, 5, 16)}
    ops["sum"] = {"x": rand(2, 3, 5, 16)}
    for name, case in ops.items():
        case["cotangents"] = [rand(*_local_out(name, case, i)) for i in range(S)]
    _, _, dv, pv = _variables()
    disp_sd, pose_sd = from_jax_variables(dv, pv, 18)
    depth = rng.uniform(1.0, 90.0, (B, H, W)).astype(np.float32)
    depth[rng.rand(*depth.shape) < 0.3] = 0.0
    return {
        "ops": ops,
        "aug_seed": 4,
        "aug_batch": {"tgt": rng.randint(0, 256, (B, H, W, 3), np.uint8),
                      "refs": rng.randint(0, 256, (B, N, H, W, 3), np.uint8),
                      "intrinsics": _intrinsics(B)},
        "weights": {"disp": disp_sd, "pose": pose_sd},
        "jax_batch": {"tgt": rng.rand(B, H, W, 3).astype(np.float32),
                      "refs": rng.rand(B, N, H, W, 3).astype(np.float32),
                      "intrinsics": _intrinsics(B)},
        "eval_batch": {"tgt": rng.rand(B, H, W, 3).astype(np.float32),
                       "refs": rng.rand(B, N, H, W, 3).astype(np.float32),
                       "intrinsics": _intrinsics(B), "depth": depth},
        "n_valid": N_VALID,
    }


def _local_out(name, case, rank):
    """The shape of shard ``rank``'s output of op ``name``."""
    n, c, h, w = case["x"].shape
    w //= S
    if name in CONVS:
        k, s, p = case["conv"]
        return (n, 4, (h + 2 * p - k) // s + 1, w // s)
    if name == "max_pool":
        return (n, c, (h - 1) // 2 + 1, w // 2)
    if name.startswith("reflect"):
        return (n, c, h + 2, w + 2)
    if name == "halo":  # 2 columns from the right neighbour, 3 from the left
        return (n, c, h, w + (2 if rank == 0 else 3))
    if name == "gather":
        return (n, c, h, w * S)
    return (n, c, h)


@functools.cache
def _jax_mesh_step():
    """JAX's make_train_step over ``make_mesh_2d(2, jax.devices()[:2])``
    on the JAX batch: its metrics. GSPMD-sharded programs need XLA's full
    optimization on the CPU (the ``fullopt`` marker's switch)."""
    jdisp, jpose, _, _ = _variables()
    tx = jstate.make_optimizer(lr=LR)
    step = jstep.make_train_step(jdisp, jpose, tx, jstep.LossConfig())
    mesh = make_mesh_2d(2, jax.devices()[:2])
    state = replicate(_jax_state(tx), mesh)
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", False)
    try:
        with jax.default_matmul_precision("highest"):
            _, metrics = step(state, shard_batch(_inputs()["jax_batch"], mesh))
    finally:
        jax.config.update("jax_disable_most_optimizations", before)
    return {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def ranks():
    """(inputs, S = 2 ranks' results, data 2 x spatial 2 ranks' results).
    JAX's reference compiles while the ranks run."""
    import torch_dist_worker

    out = tempfile.mkdtemp(prefix="spatial")
    path = os.path.join(out, "inputs.pt")
    inputs = _inputs()
    torch.save(inputs, path)
    try:
        with ThreadPoolExecutor(1) as pool:
            two = pool.submit(distributed.run_processes, torch_dist_worker.spatial_checks, S,
                              "cpu", (path,), 600.0, S)
            _jax_mesh_step()
            two = two.result()
        four = distributed.run_processes(torch_dist_worker.spatial_step, 4, "cpu", (path,),
                                         600.0, S)
        yield inputs, two, four
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol * float(np.abs(np.asarray(want)).max()))


def _whole(name, case):
    """The unsharded op on the whole input: (output, input gradient) for
    the shards' cotangents put together."""
    x = case["x"].clone().requires_grad_()
    cts = case["cotangents"]
    if name in CONVS:
        k, s, p = case["conv"]
        y = F.conv2d(x, case["weight"], case["bias"], s, p)
    elif name == "max_pool":
        y = F.max_pool2d(x, 3, 2, 1)
    elif name.startswith("reflect"):
        y = reflect_pad1(x)
    elif name == "sum":
        y = x.sum((-1))
    else:
        y = x
    if name.startswith("reflect"):  # each shard's tile: its columns and one either side
        w = x.shape[-1] // S
        ct = torch.zeros_like(y)
        for i, c in enumerate(cts):
            ct[..., i * w:(i + 1) * w + 2] += c
    elif name == "halo":
        w = x.shape[-1] // S
        ct = torch.zeros_like(y)
        ct[..., :w + 2] += cts[0]
        ct[..., w - 3:] += cts[1]
    elif name == "gather" or name == "sum":
        ct = cts[0] + cts[1]
    else:
        ct = torch.cat(cts, -1)
    (y * ct).sum().backward()
    return y.detach(), x.grad


@pytest.mark.parametrize("name", list(CONVS) + ["max_pool", "reflect8", "reflect1", "halo",
                                                 "gather", "sum"])
def test_halo_ops_equal_the_whole_image_op(ranks, name):
    inputs, two, _ = ranks
    case = inputs["ops"][name]
    y, grad = _whole(name, case)
    got = [r["ops"][name] for r in two]
    w = case["x"].shape[-1] // S
    if name.startswith("reflect"):
        for i, g in enumerate(got):
            _close(g["y"], y[..., i * w:(i + 1) * w + 2])
    elif name == "halo":
        _close(got[0]["y"], y[..., :w + 2])
        _close(got[1]["y"], y[..., w - 3:])
    elif name in ("gather", "sum"):
        for g in got:
            _close(g["y"], y)
    else:
        _close(torch.cat([g["y"] for g in got], -1), y)
    _close(torch.cat([g["grad"] for g in got], -1), grad)


def test_halo_widths_of_the_networks_windows():
    assert halo_widths(7, 2, 3, 16) == (3, 2)
    assert halo_widths(3, 2, 1, 16) == (1, 0)
    assert halo_widths(1, 2, 0, 16) == (0, 0)
    assert halo_widths(3, 1, 1, 1) == (1, 1)
    with pytest.raises(ValueError, match="multiple of 32"):
        halo_widths(3, 2, 1, 13)


@functools.cache
def _one_process_aug_step():
    inputs = _inputs()
    batch = {k: torch.from_numpy(v) for k, v in inputs["aug_batch"].items()}
    nets = seeded_nets(inputs["aug_seed"])
    result = step_run(nets, batch, augment_fn=make_device_augment(AugmentConfig()),
                      aug_seed=5)
    result["buffers"] = {f"{i}.{k}": v.clone() for i, net in enumerate(nets)
                         for k, v in net.named_buffers()}
    return result


@pytest.mark.parametrize("split", ["spatial2", "data2_spatial2"])
def test_sharded_step_equals_one_process(ranks, split):
    _, two, four = ranks
    results = [r["aug_step"] for r in two] if split == "spatial2" else four
    want = _one_process_aug_step()
    for r in results:
        for k in METRICS:
            np.testing.assert_allclose(r["metrics"][k], want["metrics"][k], rtol=1e-5,
                                       err_msg=k)
    got = results[0]["grads"]
    assert set(got) == set(want["grads"]) and len(got) > 100
    tol = lambda name: 3e-2 if ".encoder." in name else 5e-3
    bad = {n: e for n, e in ((n, _rel_l2(got[n], g)) for n, g in want["grads"].items())
           if not e <= tol(n)}
    assert not bad, f"relative L2 above tolerance: {bad}"
    for r in results:
        assert set(r["buffers"]) == set(want["buffers"])
        for key, v in want["buffers"].items():
            if v.is_floating_point():
                np.testing.assert_allclose(r["buffers"][key], v, rtol=1e-4, atol=1e-5,
                                           err_msg=key)
        for sd, sd0 in zip(r["nets"], results[0]["nets"]):
            for key, v in sd0.items():
                assert torch.equal(sd[key], v), key


def test_sharded_step_matches_jax_mesh_2d_step(ranks):
    _, two, _ = ranks
    ref = _jax_mesh_step()
    for r in two:
        for k in METRICS:
            assert np.isfinite(r["jax_step"]["metrics"][k])
            np.testing.assert_allclose(r["jax_step"]["metrics"][k], ref[k], rtol=2e-4,
                                       err_msg=k)


def test_loader_rows_and_augmented_columns_concatenate_to_one_process(ranks):
    inputs, two, _ = ranks
    whole = list(BatchLoader(ImageSet(), 2, shuffle=True, num_workers=2, drop_last=False,
                             seed=3))
    per_rank = [r["loader"] for r in two]
    assert len(whole) == 3
    for i, batch in enumerate(whole):  # one data group: every shard loads its rows whole
        assert set(batch) == set(per_rank[0][i])
        for key in batch:
            for p in per_rank:
                np.testing.assert_array_equal(p[i][key], batch[key])
    aug = {k: torch.from_numpy(v) for k, v in inputs["aug_batch"].items()}
    want = make_device_augment(AugmentConfig())(step_generator(5, 0), aug)
    got = [r["augmented"] for r in two]
    assert torch.equal(torch.cat([g["tgt"] for g in got], 2), want["tgt"])
    assert torch.equal(torch.cat([g["refs"] for g in got], 3), want["refs"])
    for g in got:
        assert torch.equal(g["intrinsics"], want["intrinsics"])


@pytest.mark.parametrize("which", ["photometric", "depth"])
def test_sharded_eval_steps_equal_one_process(ranks, which):
    inputs, two, _ = ranks
    disp, pose = nets_from(inputs["weights"])
    ev = inputs["eval_batch"]
    if which == "photometric":
        want = make_eval_step(disp, pose, LossConfig(), device="cpu", precision="fp32")(
            {"tgt": ev["tgt"], "refs": ev["refs"], "intrinsics": ev["intrinsics"],
             "n_valid": N_VALID})
    else:
        want = make_eval_depth_step(disp, device="cpu", precision="fp32")(
            {"img": ev["tgt"], "depth": ev["depth"], "n_valid": N_VALID})
    for r in two:
        got = r["eval" if which == "photometric" else "eval_depth"]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], float(v), rtol=1e-4, err_msg=k)


def test_spatial_helpers_are_the_identity_without_sharding():
    x = torch.arange(12.0).reshape(1, 1, 3, 4)
    assert distributed.spatial_count() == 1 and distributed.data_count() == 1
    assert distributed.halo(x, 3, 2) is x
    assert distributed.gather_width(x, -1) is x
    assert distributed.spatial_sum(x) is x
    assert distributed.local_columns(8) == slice(0, 8)
    batch = {"tgt": x, "intrinsics": x}
    assert distributed.local_frames(batch) is batch
