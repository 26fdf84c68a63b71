"""The comparison that decides ``correct``: the program's first steps
against the reference's, as three numbers, each against its limit.

- ``loss_rel``: the largest relative gap of a step's loss over the
  checked steps; ``loss1_rel`` the first step's alone.
- ``grad1_rel``: the worst leaf's gap between the program's gradient norm
  after step 1 (as Adam holds it) and the reference's, over the larger of
  that leaf's reference norm and the median leaf's.
- ``update_rel``: the same for each leaf's change over the checked steps,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (smaller ones move by Adam's rounding alone).
- ``grad1_median_rel``, ``update_median_rel``: the median leaf's gap of
  each, steadier from seed to seed than the worst leaf's.
- ``replay_loss1_rel``, ``replay_loss_rel``, ``replay_update_rel``,
  ``replay_update_median_rel``: the same of the program's first CUDA-graph
  replay (its second dispatch) against the reference followed from the
  program's state before it (``follow.follow_from``): the first replayed
  step's loss, the worst over the dispatch, and each leaf's change over
  the dispatch.

A cell's ``limits/<cell>.json`` names the numbers it compares, each with
its limit and the readings that limit was set from.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

REPLAY = ("replay_loss1_rel", "replay_loss_rel", "replay_update_rel",
          "replay_update_median_rel")
NUMBERS = ("loss_rel", "loss1_rel", "grad1_rel", "update_rel", "grad1_median_rel",
           "update_median_rel") + REPLAY
MOVED = 1e-3


def _median(values):
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    scale = _median([ref[n] for n in ref])
    out = {}
    for n in leaves:
        p = prog.get(n, 0.0)
        out[n] = abs(p - ref[n]) / max(ref[n], scale) if math.isfinite(p) else math.inf
    return out


def _loss_gaps(prog, ref):
    return [abs(p - r) / abs(r) if math.isfinite(p) else math.inf for p, r in zip(prog, ref)]


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every number of the module's list; the replay's where both sides
    carry a ``"replay"`` (``follow.follow_from``'s result on the
    reference's side)."""
    losses = _loss_gaps(prog["losses"], ref["losses"])
    floor = MOVED * _median(ref["grad1"].values())
    moved = [n for n, g in ref["grad1"].items() if g >= floor]
    grad1 = leaf_gaps(prog["grad1"], ref["grad1"], ref["grad1"])
    update = leaf_gaps(prog["update"], ref["update"], moved)
    out = {"loss_rel": max(losses), "loss1_rel": losses[0], "grad1_rel": max(grad1.values()),
           "update_rel": max(update.values()),
           "grad1_median_rel": _median(list(grad1.values())),
           "update_median_rel": _median(list(update.values()))}
    if "replay" in prog and "replay" in ref:
        got, want = prog["replay"], ref["replay"]
        losses = _loss_gaps(got["losses"], want["losses"])
        update = leaf_gaps(got["update"], want["update"], moved)
        out.update(replay_loss1_rel=losses[0], replay_loss_rel=max(losses),
                   replay_update_rel=max(update.values()),
                   replay_update_median_rel=_median(list(update.values())))
    return out


def worst_leaves(prog: Dict, ref: Dict, n: int = 3) -> Dict[str, list]:
    """The ``n`` worst leaves of each leaf number, for the look at a number
    that swings (not compared)."""
    floor = MOVED * _median(ref["grad1"].values())
    moved = [k for k, g in ref["grad1"].items() if g >= floor]
    out = {}
    for name, gaps in (("grad1", leaf_gaps(prog["grad1"], ref["grad1"], ref["grad1"])),
                       ("update", leaf_gaps(prog["update"], ref["update"], moved))):
        ranked = sorted(gaps.items(), key=lambda kv: -kv[1])
        out[name] = ranked[:n] + [("median", _median(list(gaps.values())))]
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(every number that ``limits`` names within its limit, ``{name:
    {"value", "limit"}}``)."""
    out = {n: {"value": values.get(n, math.inf), "limit": limit} for n, limit in limits.items()}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in out.values())
    return ok, out
