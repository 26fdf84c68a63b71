"""The cost volume's device time per optimizer step in the traced
dispatches, ms: the kernels of the family's ``cost_volume`` group
(``families/<family>/kernels.py``'s ``GROUPS``); None where the trace holds
none of them."""

from benchmark import yardstick


def read(rec):
    t = rec["trace"]
    if not t:
        return None
    us = sum(e - s for n, s, e in t["kernels"]
             if yardstick.group_of(n, rec.get("groups", ())) == "cost_volume")
    return us / 1e3 / t["steps"] if us > 0 else None
