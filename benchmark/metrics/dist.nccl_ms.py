"""The collectives' device time per optimizer step on rank 0, ms: the
traced dispatches' NCCL kernels (global BatchNorm's statistics and the
gradient all-reduce), over their optimizer steps."""

from benchmark import yardstick


def read(rec):
    t = rec["trace"]
    if not t:
        return None
    us = sum(e - s for n, s, e in t["kernels"]
             if yardstick.group_of(n, rec.get("groups", ())) == "nccl")
    return us / 1e3 / t["steps"] if us > 0 else None
