"""A whole run on the CPU at a tiny size (the card's look skipped), with the
timed path broken underneath: ``correct`` has to come out false for each
fault a training cell can have, and true with none."""

import pytest
import torch

import sc_sfmlearner_release_tpu_torch.training as training
import sc_sfmlearner_release_tpu_torch.training.step as step_module
from benchmark import cell as harness
from benchmark import run
from benchmark.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    return tiny.tiny_pool(str(tmp_path_factory.mktemp("pool")))


def _run(pool, workload="r18_kitti.packed"):
    return run.measure(tiny.tiny_cell(workload, pool), 2 ** 31 + 9, 0.3, False, CPU)


@pytest.mark.parametrize("workload", ["r18_kitti.packed", "r50_kitti.jpeg"])
def test_a_sound_run_is_correct(pool, workload):
    out = _run(pool, workload)
    assert out["correct"] is True, out["checked"]


def test_a_step_that_leaves_its_state_unchanged(pool, monkeypatch):
    make = training.make_optimizer

    def frozen(*args, **kwargs):
        opt = make(*args, **kwargs)
        opt.step = lambda closure=None: None
        return opt

    monkeypatch.setattr(training, "make_optimizer", frozen)
    out = _run(pool)
    assert out["correct"] is False
    assert out["checked"]["update_rel"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(pool, monkeypatch):
    total_loss = step_module.total_loss

    def half(disp, pose, batch, *args, **kwargs):
        rows = batch["tgt"].shape[0] // 2
        return total_loss(disp, pose, {k: v[:rows] for k, v in batch.items()}, *args, **kwargs)

    monkeypatch.setattr(step_module, "total_loss", half)
    out = _run(pool)
    assert out["correct"] is False


def test_the_loss_altered_where_it_is_produced(pool, monkeypatch):
    total_loss = step_module.total_loss

    def altered(*args, **kwargs):
        total, metrics = total_loss(*args, **kwargs)
        return 2.0 * total, dict(metrics, loss=2.0 * total)

    monkeypatch.setattr(step_module, "total_loss", altered)
    out = _run(pool)
    assert out["correct"] is False
    assert out["checked"]["loss1_rel"]["value"] == pytest.approx(1.0, rel=1e-2)


def test_a_replay_whose_inputs_were_never_refilled(pool, monkeypatch):
    """The second dispatch (on the card, the graph's first replay) trains
    on the first dispatch's batches again, as a graph whose static inputs
    were never refilled would: only the replay's numbers see it."""
    feed = harness.feed

    def stale(loader, device, k):
        batches = feed(loader, device, k)
        first = next(batches)
        yield first
        yield {key: v.clone() for key, v in first.items()}
        next(batches)
        yield from batches

    monkeypatch.setattr(harness, "feed", stale)
    out = _run(pool)
    assert out["correct"] is False
    assert out["checked"]["loss1_rel"]["value"] <= out["checked"]["loss1_rel"]["limit"]
    assert out["checked"]["replay_loss1_rel"]["value"] > \
        out["checked"]["replay_loss1_rel"]["limit"]
