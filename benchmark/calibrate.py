"""Readings that the correctness limits are set from (``limits/<cell>.json``).

For each seed, in one process: the program's set-up as a run makes it (its
first dispatches, no window), the control (the reference with float8
convolutions) and the faults of half the batch left out, of a replay whose
inputs were never refilled and, on several cards, of the exchange between
the ranks left out (each planted in the reference), each against the
reference in float32 and in the configurations' bf16. A state left unchanged reads 1 by the measure of
``check.py`` and needs no run. The benchmark's own runs never run this.

    python3 -m benchmark.calibrate --workload CELL --seeds 101 102 ... [--out FILE]
        [--references bf16] [--fault-seeds 3]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import cell as harness
from . import check, follow, spec

REFERENCES = ("fp32", "bf16")


def _program(cfg: dict, traffic: dict, seed: int, device) -> dict:
    if traffic.get("world_size", 1) > 1:
        from . import ranks

        return ranks.run(cfg, traffic, seed, 0.0, False, device.type, lambda s: None)["first"]
    return harness.run(cfg, traffic, seed, 0.0, False, device, lambda s: None)["first"]


def readings(cell: spec.Cell, seed: int, device, fp32: bool = False,
             program: bool = True, references=REFERENCES, faults: bool = True) -> dict:
    """One seed's readings against the reference in each of ``REFERENCES``
    (``<kind>@<reference precision>``); ``fp32`` adds the program run in
    float32, a second witness beside the reference. With ``program``, the
    replay's numbers too: every side follows the program's replay from its
    state before it (``follow.follow_from``), and the fault of a replay
    whose inputs were never refilled (``stale_inputs``) is read beside the
    control's and half a batch's."""
    cfg, traffic = cell.config, cell.traffic
    steps = harness.CHECKED_STEPS
    refs = {p: follow.follow(cfg, traffic, seed, steps, device, precision=p) for p in references}
    others = {}
    if faults:
        others["control"] = follow.follow(cfg, traffic, seed, steps, device, precision="fp8")
        others["half_batch"] = follow.follow(cfg, traffic, seed, steps, device,
                                             precision=references[-1], drop_half=True)
        if traffic.get("world_size", 1) > 1:  # the exchange between the ranks left out
            others["no_exchange"] = follow.follow(cfg, traffic, seed, steps, device,
                                                  precision=references[-1], no_exchange=True)
    if program:
        others["program"] = _program(cfg, traffic, seed, device)
        replay = others["program"]["replay"]
        after = lambda **kw: follow.follow_from(cfg, traffic, seed, replay, device, **kw)
        for p, ref in refs.items():
            ref["replay"] = after(precision=p)
        if faults:
            others["control"]["replay"] = after(precision="fp8")
            others["half_batch"]["replay"] = after(precision=references[-1], drop_half=True)
            if "no_exchange" in others:
                others["no_exchange"]["replay"] = after(precision=references[-1],
                                                        no_exchange=True)
            others["stale_inputs"] = dict(refs[references[-1]],
                                          replay=after(precision=references[-1], stale=True))
    if fp32:
        others["program_fp32"] = _program(dict(cfg, precision="fp32"), traffic, seed, device)
    out = {"seed": seed, "losses": {k: v["losses"] for k, v in {**refs, **others}.items()}}
    out["replay_losses"] = {k: v["replay"]["losses"] for k, v in {**refs, **others}.items()
                            if "replay" in v}
    for kind, got in others.items():
        for p, ref in refs.items():
            out[f"{kind}@{p}"] = check.numbers(got, ref)
            out[f"{kind}@{p}_worst"] = check.worst_leaves(got, ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--fp32-seeds", type=int, default=0,
                   help="also run the program in float32 on the first N seeds")
    p.add_argument("--references", nargs="+", default=list(REFERENCES), choices=REFERENCES)
    p.add_argument("--reference-only", action="store_true",
                   help="only the control's and the fault's readings (no program run)")
    p.add_argument("--fault-seeds", type=int, default=None,
                   help="the control and the faults on the first N seeds only")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    device = torch.device("cuda", 0)
    rows = []
    for i, seed in enumerate(args.seeds):
        faults = args.fault_seeds is None or i < args.fault_seeds
        rows.append(readings(cell, seed, device, fp32=i < args.fp32_seeds,
                             program=not args.reference_only, references=args.references,
                             faults=faults))
        print(json.dumps(rows[-1]), flush=True)
    kinds = sorted({k for r in rows for k in r if "@" in k and not k.endswith("_worst")})
    summary = {name: {kind: (max if kind.startswith("program") else min)(
        r[kind][name] for r in rows if name in r.get(kind, {}))
        for kind in kinds if any(name in r.get(kind, {}) for r in rows)}
        for name in check.NUMBERS}
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "lower_and_upper": summary}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
