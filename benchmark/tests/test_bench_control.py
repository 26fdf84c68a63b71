"""The control: the reference itself, put in the program's place one
precision below the configuration's (float8 e4m3 convolutions for bf16),
fails each cell's limits. The program runs its set-up for the replay's
start state, from which both the reference and the control follow the
replay. On the CPU at a tiny size; on the card at the cells' own sizes
(``-m card``)."""

import pytest
import torch

from benchmark import cell as harness
from benchmark import check, follow, spec
from benchmark.tests import tiny

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    return tiny.tiny_pool(str(tmp_path_factory.mktemp("pool")))


def _control_fails(cell, seed, device):
    cfg, traffic = cell.config, cell.traffic
    replay = harness.run(cfg, traffic, seed, 0.0, False, device, lambda msg: None)["first"]["replay"]
    sides = {}
    for name, precision in (("ref", cell.limits["reference"]), ("ctl", "fp8")):
        sides[name] = follow.follow(cfg, traffic, seed, 3, device, precision=precision)
        sides[name]["replay"] = follow.follow_from(cfg, traffic, seed, replay, device,
                                                   precision=precision)
    ok, checked = check.judge(check.numbers(sides["ctl"], sides["ref"]), cell.limits["limits"])
    assert not ok, checked


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_a_tiny_size(pool, workload):
    cell = tiny.tiny_cell(workload, pool)
    for seed in (1, 2, 2 ** 31 + 1):
        _control_fails(cell, seed, torch.device("cpu"))


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_size(card, workload):
    cell = spec.resolve(BENCH, workload)
    for seed in (11, 12, 2 ** 31 + 13):
        _control_fails(cell, seed, card)
