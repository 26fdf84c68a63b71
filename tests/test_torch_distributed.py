"""The port's data parallelism over processes (``parallel/distributed.py``,
the train CLI's ``--distributed``): 2 processes with gloo on the CPU against
one process on the global batch and against the JAX package's step over a
2-device data mesh.

One spawn of 2 ranks (``tests/torch_dist_worker.py checks``) computes every
check's result on its slice while this process computes the references:

  (a) the loader's slices, concatenated, are the 1-process global batch
      (the padded trailing batch and ``_n_valid`` included) and JAX's
      ``BatchLoader``'s slices: exact;
  (b) ``mean_on_mask``, ``_grouped_mean_on_mask`` and ``_sample_mean``:
      the ranks' shares add up to JAX's function on the concatenated
      arrays, rel 1e-6 (fp32 sums in another order), also where rank 0's
      mask sum is under the 10000-element guard and the global one is
      over it, where the mean of per-rank means differs by far more;
  (c) ``BatchNorm2d`` in train mode: output, input gradient, the summed
      weight and bias gradients and the running statistics equal one
      process on the concatenated batch within 1e-5 of each tensor's
      largest value (the sums and sums of squares round otherwise than
      ``F.batch_norm``'s statistics);
  (d) a train step (ResNet-18, 64x96, fp32, device augmentation on):
      losses rel 1e-5, every gradient before Adam within
      ``tests/test_torch_train.py``'s bounds (rel L2 5e-3, encoders 3e-2;
      the loss is kinky, and the statistics round otherwise), the moves
      after Adam under its rule, BatchNorm statistics rel 1e-4 (abs
      1e-5); both ranks end with bit-identical networks;
  (e) the 2-rank step from JAX-initialised nets against JAX's
      ``make_train_step`` jitted over ``make_mesh(jax.devices()[:2])`` on
      the batch of ``tests/test_torch_train.py``, within that file's
      tolerances;
  (f) the eval steps on a padded trailing batch (global 4, ``n_valid`` 3)
      against JAX's eval steps on the global batch, rel 1e-4 as
      ``tests/test_torch_train.py``'s eval-depth test;
  (g) ``fused_steps=2`` under 2 ranks against two unfused steps: exact;
      ``remat`` against the plain step (rel 1e-5), and ``replicate``: every
      rank holds rank 0's networks and Adam state, exactly.

The checkpoint manager (exact, also under the 2 ranks), the train CLI with
``--distributed`` under 2 ranks (only rank 0 writes, and its files hold
rank 1's networks), ``graft_entry.dryrun_multigpu(2)`` and the error
without torchrun's environment are checked too.
"""

import functools
import glob
import hashlib
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_sfmlearner_release_tpu.data.loader import BatchLoader as JaxBatchLoader
from sc_sfmlearner_release_tpu.ops import losses as jlosses
from sc_sfmlearner_release_tpu.parallel import make_mesh, replicate, shard_batch
from sc_sfmlearner_release_tpu.training import state as jstate
from sc_sfmlearner_release_tpu.training import step as jstep
from sc_sfmlearner_release_tpu_torch import train as cli
from sc_sfmlearner_release_tpu_torch.data import BatchLoader, pack_dataset
from sc_sfmlearner_release_tpu_torch.data.device_augment import (
    AugmentConfig, make_device_augment,
)
from sc_sfmlearner_release_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from sc_sfmlearner_release_tpu_torch.models.resnet import BatchNorm2d
from sc_sfmlearner_release_tpu_torch.parallel import distributed
from sc_sfmlearner_release_tpu_torch.training import create_train_state, make_optimizer
from sc_sfmlearner_release_tpu_torch.training.checkpoint import CheckpointManager
from test_torch_train import LR, METRICS, NETS, _batch, _jax_state, _leaves, _variables
from torch_dist_worker import LOADER_BATCH, CountingSet, seeded_nets, step_run

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_dist_worker.py")
H, W = 64, 96
N_VALID = 3
AUG_SEED = 0


def _spawn(mode: str, out_dir: str, *args: str):
    """Two ranks of the worker on a free port, each logging to a file."""
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(distributed.free_port()), OMP_NUM_THREADS="2")
    procs = []
    for rank in range(2):
        log = open(os.path.join(out_dir, f"{mode}{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, mode, out_dir, *args], stdout=log,
            stderr=subprocess.STDOUT, cwd=REPO,
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank))), log))
    return procs


def _wait(procs, out_dir: str, mode: str, timeout: float = 300) -> None:
    try:
        for proc, _ in procs:
            proc.wait(timeout=timeout)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    logs = "".join(open(os.path.join(out_dir, f"{mode}{r}.log")).read()[-3000:]
                   for r in range(2))
    assert all(proc.returncode == 0 for proc, _ in procs), logs


@functools.cache
def _inputs() -> dict:
    """The global arrays and network weights every check starts from."""
    rng = np.random.RandomState(7)
    # Rank 0's rows hold a sparse mask (about 4150 of 13824 elements, under
    # the guard), rank 1's a dense one: the global sum clears the guard.
    density = np.array([0.3, 0.3, 0.9, 0.9])
    mask = (rng.rand(4, 48, 48, 1) < density[:, None, None, None]).astype(np.float32)
    gmask = (rng.rand(2, 4, 48, 48, 1) < density[None, :, None, None, None]).astype(np.float32)
    k = np.array([[50.0, 0, W / 2], [0, 55.0, H / 2], [0, 0, 1]], np.float32)
    depth = rng.uniform(1.0, 90.0, (4, H, W)).astype(np.float32)
    depth[rng.rand(*depth.shape) < 0.3] = 0.0
    bn_x = (rng.randn(4, 5, 6, 7) * 2 + 1).astype(np.float32)
    bn_state = BatchNorm2d(5).state_dict()
    for key in ("weight", "bias", "running_mean"):
        bn_state[key] = torch.from_numpy(rng.randn(5).astype(np.float32))
    bn_state["running_var"] = torch.from_numpy(rng.uniform(0.5, 2, 5).astype(np.float32))
    _, _, dv, pv = _variables()
    disp_sd, pose_sd = from_jax_variables(dv, pv, 18)
    return {
        "losses": {"diff": rng.rand(4, 48, 48, 3).astype(np.float32), "mask": mask,
                   "gdiff": rng.rand(2, 4, 48, 48, 3).astype(np.float32), "gmask": gmask,
                   "x": rng.rand(4, 5, 6, 1).astype(np.float32),
                   "sample_mask": np.array([1, 1, 1, 0], np.float32)},
        "bn": {"x": bn_x, "cotangent": rng.randn(*bn_x.shape).astype(np.float32),
               "state": bn_state},
        "aug_seed": AUG_SEED,
        "aug_batch": {"tgt": rng.randint(0, 256, (4, H, W, 3), np.uint8),
                      "refs": rng.randint(0, 256, (4, 2, H, W, 3), np.uint8),
                      "intrinsics": np.broadcast_to(k, (4, 3, 3)).copy()},
        "weights": {"disp": disp_sd, "pose": pose_sd},
        "jax_batch": _batch(),
        "eval_batch": {"tgt": rng.rand(4, H, W, 3).astype(np.float32),
                       "refs": rng.rand(4, 2, H, W, 3).astype(np.float32),
                       "intrinsics": np.broadcast_to(k, (4, 3, 3)).copy(), "depth": depth},
        "n_valid": N_VALID,
    }


@functools.cache
def _jax_mesh_run():
    """JAX's make_train_step jitted over a 2-device data mesh, with the
    gradient of its loss beside it: (metrics, grads, new params, old
    params), numpy trees. GSPMD-sharded programs need XLA's full
    optimization on the CPU (the ``fullopt`` marker's switch)."""
    jdisp, jpose, _, _ = _variables()
    tx = jstate.make_optimizer(lr=LR)
    cfg = jstep.LossConfig()
    train_step = jstep.make_train_step(jdisp, jpose, tx, cfg)

    def run(state, batch):
        grads = jax.grad(lambda p: jstep._total_loss(
            jdisp, jpose, p, state.batch_stats, batch, cfg, True)[0])(state.params)
        new_state, metrics = train_step(state, batch)
        return metrics, grads, new_state.params

    mesh = make_mesh(jax.devices()[:2])
    state = replicate(_jax_state(tx), mesh)
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", False)
    try:
        with jax.default_matmul_precision("highest"):
            out = jax.jit(run)(state, shard_batch(_batch(), mesh))
    finally:
        jax.config.update("jax_disable_most_optimizations", before)
    return jax.tree_util.tree_map(np.asarray, out + (state.params,))


@functools.cache
def _jax_eval():
    """JAX's eval steps on the global eval batch with ``n_valid``."""
    inputs = _inputs()
    jdisp, jpose, dv, pv = _variables()
    state = jstate.TrainState(step=None, params={"disp": dv["params"], "pose": pv["params"]},
                              batch_stats={"disp": dv["batch_stats"],
                                           "pose": pv["batch_stats"]},
                              opt_state=None, rng=None)
    ev = inputs["eval_batch"]
    n_valid = jnp.int32(inputs["n_valid"])
    with jax.default_matmul_precision("highest"):
        photo = jstep.make_eval_step(jdisp, jpose, jstep.LossConfig())(state, {
            "tgt": jnp.asarray(ev["tgt"]), "refs": jnp.asarray(ev["refs"]),
            "intrinsics": jnp.asarray(ev["intrinsics"]), "n_valid": n_valid})
        depth = jstep.make_eval_depth_step(jdisp)(state, {
            "img": jnp.asarray(ev["tgt"]), "depth": jnp.asarray(ev["depth"]),
            "n_valid": n_valid})
    return ({k: float(v) for k, v in photo.items()}, {k: float(v) for k, v in depth.items()})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, [rank 0's results, rank 1's]). The JAX references compile
    while the ranks run."""
    out = str(tmp_path_factory.mktemp("dist"))
    inputs = _inputs()
    torch.save(inputs, os.path.join(out, "inputs.pt"))
    procs = _spawn("checks", out)
    try:
        _jax_mesh_run()
        _jax_eval()
    finally:
        _wait(procs, out, "checks")
    results = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
               for r in range(2)]
    yield inputs, results
    shutil.rmtree(out, ignore_errors=True)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_loader_slices_concatenate_to_the_global_batch(ranks):
    _, results = ranks
    port = list(BatchLoader(CountingSet(), LOADER_BATCH, shuffle=True, num_workers=2,
                            drop_last=False, seed=3))
    jax_slices = [list(JaxBatchLoader(CountingSet(), LOADER_BATCH, shuffle=True, num_workers=2,
                                      drop_last=False, seed=3, process_index=p,
                                      process_count=2)) for p in range(2)]
    per_rank = [r["loader"] for r in results]
    assert len(port) == 3 and [int(b["_n_valid"]) for b in port] == [4, 4, 2]
    for i, whole in enumerate(port):
        for p in range(2):
            assert int(per_rank[p][i]["_n_valid"]) == int(whole["_n_valid"])
            for key in ("tgt", "index"):
                np.testing.assert_array_equal(per_rank[p][i][key], jax_slices[p][i][key])
        for key in ("tgt", "index"):
            np.testing.assert_array_equal(
                np.concatenate([per_rank[0][i][key], per_rank[1][i][key]]), whole[key])
    # The padded trailing batch: rank 1 holds two copies of the last sample.
    assert per_rank[1][2]["index"][0] == per_rank[1][2]["index"][1] == port[2]["index"][1]


@pytest.mark.parametrize("name", ["mean_on_mask", "grouped", "sample_mean",
                                  "sample_mean_masked"])
def test_masked_means_are_global(ranks, name):
    inputs, results = ranks
    b = {k: jnp.asarray(v) for k, v in inputs["losses"].items()}
    want = {"mean_on_mask": lambda: jlosses.mean_on_mask(b["diff"], b["mask"]),
            "grouped": lambda: jlosses._grouped_mean_on_mask(b["gdiff"], b["gmask"]),
            "sample_mean": lambda: jlosses._sample_mean(b["x"], None),
            "sample_mean_masked": lambda: jlosses._sample_mean(b["x"], b["sample_mask"])}[name]()
    got = np.asarray(results[0][name]) + np.asarray(results[1][name])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
    assert np.all(np.asarray(want) > 0)


def test_per_rank_means_differ_under_the_guard(ranks):
    """Rank 0's mask is under the 10000-element guard, the global one over
    it: the global mean is not the mean of per-rank means."""
    inputs, results = ranks
    b = inputs["losses"]
    halves = [slice(0, 2), slice(2, 4)]
    assert b["mask"][halves[0]].sum() * 3 <= 10000 < b["mask"].sum() * 3
    per_rank = [float(jlosses.mean_on_mask(jnp.asarray(b["diff"][s]), jnp.asarray(b["mask"][s])))
                for s in halves]
    assert per_rank[0] == 0.0
    glob_mean = results[0]["mean_on_mask"] + results[1]["mean_on_mask"]
    assert abs(np.mean(per_rank) - glob_mean) > 0.1 * glob_mean
    grouped = [np.asarray(jlosses._grouped_mean_on_mask(jnp.asarray(b["gdiff"][:, s]),
                                                        jnp.asarray(b["gmask"][:, s])))
               for s in halves]
    glob_grouped = results[0]["grouped"] + results[1]["grouped"]
    assert np.all(grouped[0] == 0.0)
    assert np.all(np.abs(np.mean(grouped, 0) - glob_grouped) > 0.1 * glob_grouped)


def test_batch_norm_equals_one_process(ranks):
    inputs, results = ranks
    bn_in = inputs["bn"]
    bn = BatchNorm2d(5)
    bn.load_state_dict(bn_in["state"])
    x = torch.from_numpy(bn_in["x"]).requires_grad_()
    out = bn(x)
    (out * torch.from_numpy(bn_in["cotangent"])).sum().backward()
    got = [r["bn"] for r in results]
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=0, atol=1e-5 * float(np.abs(np.asarray(b)).max()))
    close(torch.cat([g["out"] for g in got]), out.detach())
    close(torch.cat([g["x_grad"] for g in got]), x.grad)
    close(got[0]["weight_grad"] + got[1]["weight_grad"], bn.weight.grad)
    close(got[0]["bias_grad"] + got[1]["bias_grad"], bn.bias.grad)
    for key, want in bn.state_dict().items():
        for g in got:
            close(g["state"][key], want)


@functools.cache
def _one_process_aug_step():
    inputs = _inputs()
    batch = {k: torch.from_numpy(v) for k, v in inputs["aug_batch"].items()}
    return step_run(seeded_nets(inputs["aug_seed"]), batch,
                    augment_fn=make_device_augment(AugmentConfig()), aug_seed=5)


def test_augmented_step_losses_and_gradients_equal_one_process(ranks):
    _, results = ranks
    want = _one_process_aug_step()
    for r in results:
        for k in METRICS:
            np.testing.assert_allclose(r["aug_step"]["metrics"][k], want["metrics"][k],
                                       rtol=1e-5, err_msg=k)
    got = results[0]["aug_step"]["grads"]
    assert set(got) == set(want["grads"]) and len(got) > 100
    tol = lambda name: 3e-2 if ".encoder." in name else 5e-3
    bad = {n: e for n, e in ((n, _rel_l2(got[n], g)) for n, g in want["grads"].items())
           if not e <= tol(n)}
    assert not bad, f"relative L2 above tolerance: {bad}"


def test_augmented_step_networks_equal_one_process(ranks):
    """Parameters after Adam under ``tests/test_torch_train.py``'s rule,
    BatchNorm statistics rel 1e-4; both ranks bit-identical."""
    _, results = ranks
    want = _one_process_aug_step()
    before = [net.state_dict() for net in seeded_nets(AUG_SEED)]
    for i, (got_sd, want_sd) in enumerate(zip(results[0]["aug_step"]["nets"], want["nets"])):
        for key, w in want_sd.items():
            for r in results[1:]:
                assert torch.equal(r["aug_step"]["nets"][i][key], got_sd[key]), key
            g = got_sd[key]
            if "running" in key:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=key)
            elif g.is_floating_point():
                moved, moved_ref = g - before[i][key], w - before[i][key]
                grad = want["grads"].get(f"{i}.{key}")
                ulps = 2.0**-22 * max(1.0, float(before[i][key].abs().max()))
                assert float(moved.abs().max()) <= LR + ulps, key
                if grad is None:
                    assert not torch.any(moved), key
                    continue
                live = grad.abs() > 1e-6
                firm = live & ((results[0]["aug_step"]["grads"][f"{i}.{key}"] - grad).abs()
                               < 0.1 * grad.abs())
                assert firm.sum() >= 0.5 * live.sum(), key
                np.testing.assert_allclose(moved[firm], moved_ref[firm], rtol=0,
                                           atol=1e-3 * LR + ulps, err_msg=key)


def test_remat_step_equals_the_plain_step_under_two_ranks(ranks):
    """``remat`` recomputes the forward in the backward, BatchNorm's
    all-reduces included: the same losses, gradients (rel 1e-5: the
    recomputation rounds as the forward) and networks after the step."""
    _, results = ranks
    for r in results:
        plain, remat = r["aug_step"], r["remat_step"]
        assert remat["metrics"] == plain["metrics"]
        for name, g in plain["grads"].items():
            assert _rel_l2(remat["grads"][name], g) <= 1e-5, name
        for got_sd, want_sd in zip(remat["nets"], plain["nets"]):
            for key, v in want_sd.items():
                np.testing.assert_allclose(got_sd[key], v, rtol=1e-5, atol=1e-7, err_msg=key)


def test_replicate_gives_every_rank_rank_0s_state(ranks):
    _, results = ranks
    (net0, adam0), (net1, adam1) = ((r["replicated"]["nets"], r["replicated"]["adam"])
                                    for r in results)
    for sd0, sd1 in zip(net0, net1):
        for key, v in sd0.items():
            assert torch.equal(sd1[key], v), key
    assert adam0["state"].keys() == adam1["state"].keys() and len(adam0["state"]) == 4
    for i, moments in adam0["state"].items():
        for key, v in moments.items():
            assert torch.equal(adam1["state"][i][key], v), (i, key)
    # Before the broadcast rank 1 moved by its own gradients (2, not 1).
    assert float(adam0["state"][0]["exp_avg"].flatten()[0]) == pytest.approx(0.1)


def test_two_rank_step_losses_match_jax_mesh_step(ranks):
    _, results = ranks
    ref = _jax_mesh_run()[0]
    for r in results:
        for k in METRICS:
            np.testing.assert_allclose(r["jax_step"]["metrics"][k], float(ref[k]), rtol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("net", NETS)
def test_two_rank_step_gradients_and_moves_match_jax_mesh_step(ranks, net):
    """``tests/test_torch_train.py``'s gradient and Adam-move rules."""
    _, results = ranks
    _, grads, new_ref, old = _jax_mesh_run()
    step = results[0]["jax_step"]
    flax = lambda sds: to_jax_variables(sds[0], sds[1], 18)[NETS.index(net)]["params"]
    got_g, got_new = _leaves(flax(step["grad_sds"])), _leaves(flax(step["nets"]))
    ref_g, ref_new, before = _leaves(grads[net]), _leaves(new_ref[net]), _leaves(old[net])
    assert set(got_g) == set(ref_g) and len(ref_g) > 20
    for path, g in ref_g.items():
        if not np.any(g):  # the heads of scales 1-3: one scale is trained
            assert not np.any(got_g[path]), path
            continue
        tol = 3e-2 if path.startswith("['encoder']") else 5e-3
        assert _rel_l2(got_g[path], g) <= tol, path
        moved_ref, moved = ref_new[path] - before[path], got_new[path] - before[path]
        ulps = 2.0**-22 * max(1.0, np.abs(before[path]).max())
        assert np.abs(moved).max() <= LR + ulps, path
        live = np.abs(g) > 1e-6
        firm = live & (np.abs(got_g[path] - g) < 0.1 * np.abs(g))
        assert firm.sum() >= 0.5 * live.sum(), (path, firm.sum(), live.sum())
        np.testing.assert_allclose(moved[firm], moved_ref[firm], rtol=0, atol=1e-3 * LR + ulps,
                                   err_msg=path)


@pytest.mark.parametrize("which", ["photometric", "depth"])
def test_eval_steps_on_a_padded_batch_match_jax(ranks, which):
    _, results = ranks
    ref = _jax_eval()[0 if which == "photometric" else 1]
    for r in results:
        got = r["eval" if which == "photometric" else "eval_depth"]
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)


def test_fused_distributed_steps_equal_unfused_steps(ranks):
    _, results = ranks
    for r in results:
        for k, v in r["unfused"]["metrics"].items():
            assert torch.equal(r["fused"]["metrics"][k], v), k
        for fused_sd, unfused_sd in zip(r["fused"]["nets"], r["unfused"]["nets"]):
            for key, v in unfused_sd.items():
                assert torch.equal(fused_sd[key], v), key


def test_checkpoint_manager_under_two_ranks(ranks):
    _, results = ranks
    for r in results:
        m = r["manager"]
        assert m["steps"] == [2, 3] and m["latest"] == 3 and m["restored_step"] == 2
        for saved, restored in zip(m["saved"], m["restored"]):
            for key, v in saved.items():
                assert torch.equal(restored[key], v), key


def test_checkpoint_manager_retention_and_restore(tmp_path):
    nets = (torch.nn.Linear(3, 2), torch.nn.Linear(2, 1))
    state = create_train_state(*nets, make_optimizer(*nets))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    saved = {}
    for _ in range(5):
        for p in state.optimizer.param_groups[0]["params"]:
            p.grad = torch.full_like(p, 0.5)
        state.optimizer.step()
        mgr.save(state.step, state, epoch=7)
        saved[state.step] = [dict(net.state_dict()) for net in nets]
        saved[state.step] = [{k: v.clone() for k, v in sd.items()} for sd in saved[state.step]]
    assert mgr.all_steps() == [3, 4, 5] and mgr.latest_step() == 5
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["3", "4", "5"]
    for step in (None, 4, 3):
        fresh = (torch.nn.Linear(3, 2), torch.nn.Linear(2, 1))
        restored = mgr.restore(create_train_state(*fresh, make_optimizer(*fresh)), step=step)
        want = 5 if step is None else step
        assert restored.step == want
        for net, sd in zip(fresh, saved[want]):
            for key, v in sd.items():
                assert torch.equal(net.state_dict()[key], v), key
    with pytest.raises(FileNotFoundError, match="step 1"):
        mgr.restore(state, step=1)
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path / "other"), max_to_keep=0)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A packed tree of 64x96 frames: 8 train snippets, 2 validation ones."""
    import imageio.v2 as imageio

    root = tmp_path_factory.mktemp("dist_tree")
    rng = np.random.RandomState(0)
    k = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
    for scene, n in (("s1", 10), ("v1", 4)):
        d = root / scene
        d.mkdir()
        for i in range(n):
            imageio.imwrite(d / f"{i:07d}.jpg", (rng.rand(H, W, 3) * 255).astype(np.uint8))
        np.savetxt(d / "cam.txt", k)
    (root / "train.txt").write_text("s1\n")
    (root / "val.txt").write_text("v1\n")
    pack_dataset(str(root))
    yield str(root)
    shutil.rmtree(root, ignore_errors=True)


def test_cli_distributed_on_two_ranks(tree, tmp_path):
    """2 steps of B4 (2 per rank) and validation: rank 0 writes the
    experiment directory, rank 1 nothing, and the written networks are the
    ones rank 1 holds."""
    out = str(tmp_path)
    procs = _spawn("cli", out, tree, "--name", "dist", "--distributed", "--device", "cpu",
                   "--precision", "fp32", "-b", "4", "-j", "2", "--epochs", "1",
                   "--epoch-size", "2", "--packed", "--device-augment", "--with-pretrain", "0",
                   "--no-tensorboard", "--log-style", "line")
    _wait(procs, out, "cli")
    assert not os.path.exists(os.path.join(out, "rank1", "checkpoints"))
    (save,) = glob.glob(os.path.join(out, "rank0", "checkpoints", "dist", "*"))
    rows = list(open(os.path.join(save, "progress_log_full.csv")))[1:]
    assert len(rows) == 2 and all(np.isfinite(float(v)) for r in rows for v in r.split("\t"))
    assert len(list(open(os.path.join(save, "progress_log_summary.csv")))) == 2
    assert [int(r.split("\t")[0]) for r in list(open(os.path.join(save, cli.TIME_LOG)))[1:]] \
        == [1, 2]
    assert json.load(open(os.path.join(save, "meta.json"))) == {"step": 2, "epoch": 1}
    digest = lambda t: hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()
    written = {}
    for name, prefix in (("disp", "dispnet"), ("pose", "exp_pose")):
        blob = torch.load(os.path.join(save, f"{prefix}_checkpoint.pth.tar"), weights_only=True)
        written.update({f"{name}.{k}": digest(v) for k, v in blob["state_dict"].items()})
    nets = [json.load(open(os.path.join(out, f"nets{r}.json"))) for r in range(2)]
    assert nets[0] == nets[1] == written and len(written) > 200
    shutil.rmtree(os.path.join(out, "rank0"), ignore_errors=True)


def test_graft_entry_dryrun_on_two_cpu_processes():
    res = subprocess.run(
        [sys.executable, "-m", "sc_sfmlearner_release_tpu_torch.graft_entry", "2", "--device",
         "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr[-3000:]
    line = next(l for l in res.stdout.splitlines() if l.startswith("dryrun_multigpu"))
    assert "gloo over 2 CPU processes): OK, loss=" in line
    assert np.isfinite(float(line.rsplit("=", 1)[1]))


def test_distributed_without_torchrun_env_exits_clearly(tree, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for key in distributed.TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit, match="--distributed needs torchrun's environment.*RANK"):
        cli.main([tree, "--name", "x", "--distributed", "--device", "cpu", "--with-pretrain",
                  "0"])
    assert not distributed.is_distributed()
    assert not os.path.exists(tmp_path / "checkpoints")


def test_helpers_are_the_identity_without_a_process_group():
    x = torch.arange(6.0).reshape(2, 3)
    assert distributed.process_index() == 0 and distributed.process_count() == 1
    assert distributed.global_sum(x) is x
    assert distributed.local_rows(4) == slice(0, 4)
    assert torch.equal(distributed.global_rows(3), torch.arange(3))
    metrics = {"loss": torch.tensor(1.0)}
    assert distributed.sum_metrics(metrics) is metrics
    with pytest.raises(ValueError, match="not divisible"):
        BatchLoader(CountingSet(), 3, process_count=2)
