"""The card's idle share of the traced dispatches, %: the part of the span
from their first device record to their last that no kernel, copy or fill
covers (the union of the records' intervals)."""

from benchmark import trace


def read(rec):
    if not rec["trace"]:
        return None
    busy, span = trace.busy_and_span_us(rec["trace"]["kernels"])
    if span <= 0:
        return None
    return 100.0 * (1.0 - busy / span)
