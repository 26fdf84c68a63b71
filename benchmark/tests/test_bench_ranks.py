"""The several-card path on the CPU: four gloo ranks at a tiny size, as the
four-card cells run on NCCL, once sound and once with the exchange between
the ranks left out."""

import torch

from benchmark import check, follow, ranks, run
from benchmark.tests import tiny

SEED = 2 ** 31 + 21


def _cell(tmp_path):
    cell = tiny.tiny_cell("r18_kitti.packed", tiny.tiny_pool(str(tmp_path / "pool")))
    cell.traffic.update(world_size=4, workers=1, scenes=4)
    return cell


def test_four_ranks_are_correct(tmp_path):
    out = run.measure(_cell(tmp_path), SEED, 0.5, False, torch.device("cpu"))
    assert out["correct"] is True, out["checked"]
    assert out["attempted"] >= 1


def test_the_exchange_left_out(tmp_path):
    cell = _cell(tmp_path)
    cfg, traffic = cell.config, cell.traffic
    got = ranks.run(cfg, traffic, SEED, 0.0, False, "cpu", lambda msg: None,
                    rank_fn=ranks.no_exchange_rank)
    ref = follow.follow(cfg, traffic, SEED, 3, torch.device("cpu"),
                        precision=cell.limits["reference"])
    ref["replay"] = follow.follow_from(cfg, traffic, SEED, got["first"]["replay"],
                                       torch.device("cpu"), precision=cell.limits["reference"])
    ok, checked = check.judge(check.numbers(got["first"], ref), cell.limits["limits"])
    assert not ok, checked


def test_rank_zeros_spans_reach_the_readers(tmp_path):
    """A traced run on four ranks: rank 0's spans, recorded in its own
    process, are read where the ranks' results return."""
    out = run.measure(_cell(tmp_path), SEED, 0.3, True, torch.device("cpu"))
    assert out["correct"] is True, out["checked"]
    assert out["metrics"]["data.queue_wait_ms"]["value"] > 0
    assert out["metrics"]["data.sample_ms"]["value"] > 0
    assert out["device"]["busy_s"] >= 0
