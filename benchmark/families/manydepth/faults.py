"""Readings of the cell ``manydepth_r18_kitti.packed`` with the cost volume
broken in the program, against the bf16 reference, beside the sound
program's on the same seed: the faults a change of the cost-volume kernel
or of its bins could bring, which the control and the shared faults of
``benchmark.calibrate`` (half a batch, stale inputs) do not exercise.

- ``zeroed_volume``: the volume the matching network reads is all zeros
  (the lowest cost and the confidence stay right);
- ``wrong_bins``: the bins run from the lower tracker to twice the upper
  one.

For each seed and each side (``sound`` and the faults) it runs the
program's set-up as a run makes it (no window), follows the reference
from the seed and from the program's state before its first replay
(``follow``), and prints every number of ``check.NUMBERS`` and the verdict
of ``check.judge`` under the cell's limits file: one JSON line a side and
seed, then the sound side's largest and each fault's smallest reading of
every number.

    python3 -m benchmark.families.manydepth.faults --seeds N [N ...] [--out FILE]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from benchmark import cell as harness
from benchmark import check, follow, spec

CELL = "manydepth_r18_kitti.packed"
FAULTS = ("zeroed_volume", "wrong_bins")


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted (``None``: sound)."""
    from sc_sfmlearner_release_tpu_torch.models import manydepth as models
    from sc_sfmlearner_release_tpu_torch.training import manydepth as training

    if fault is None:
        yield
        return
    if fault == "zeroed_volume":
        module, name = models, "cost_volume"
        real = module.cost_volume

        def broken(*args):
            volume, lowest, confidence = real(*args)
            return torch.zeros_like(volume), lowest, confidence
    elif fault == "wrong_bins":
        module, name = training, "depth_bins"
        real = module.depth_bins

        def broken(lo, hi, n):
            return real(lo, 2 * hi, n)
    else:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    setattr(module, name, broken)
    try:
        yield
    finally:
        setattr(module, name, real)


def readings(cell: spec.Cell, seed: int, device, faults=FAULTS) -> list:
    """One row a side: ``{"seed", "side", "numbers", "correct", "failed"}``."""
    cfg, traffic = cell.config, cell.traffic
    want = follow.follow(cfg, traffic, seed, harness.CHECKED_STEPS, device, precision="bf16")
    rows = []
    for fault in (None,) + tuple(faults):
        with planted(fault):
            first = harness.run(cfg, traffic, seed, 0.0, False, device, lambda s: None)["first"]
        ref = dict(want, replay=follow.follow_from(cfg, traffic, seed, first["replay"], device,
                                                   precision="bf16"))
        numbers = check.numbers(first, ref)
        ok, judged = check.judge(numbers, cell.limits["limits"])
        rows.append({"seed": seed, "side": fault or "sound", "numbers": numbers, "correct": ok,
                     "failed": sorted(n for n, v in judged.items()
                                      if not v["value"] <= v["limit"]),
                     "worst": check.worst_leaves(first, ref)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="+", default=list(FAULTS), choices=FAULTS)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("faults needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.resolve(spec.load_benchmark(), CELL)
    device = torch.device("cuda", 0)
    rows = [r for seed in args.seeds for r in readings(cell, seed, device, args.faults)]
    summary = {}
    for side in ["sound"] + args.faults:
        got = [r["numbers"] for r in rows if r["side"] == side]
        pick = max if side == "sound" else min
        summary[side] = {n: pick(g[n] for g in got) for n in check.NUMBERS if n in got[0]}
        summary[side]["correct_runs"] = sum(r["correct"] for r in rows if r["side"] == side)
    print(json.dumps({"workload": CELL, "seeds": args.seeds, "summary": summary}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": CELL, "rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
