"""How busy the loader's threads were in the traced dispatches, %: the union
of each thread's ``data.sample`` spans, summed over threads, over the
mix's ``workers`` times the traced host window."""

from benchmark import spans, yardstick


def read(rec):
    found = spans.named(rec, "data.sample")
    if found is None:
        return None
    busy = sum(yardstick.union_us((s, e) for t, s, e in found if t == thread)
               for thread in {t for t, _, _ in found})
    lo, hi = spans.window_us(rec)
    return 100.0 * busy / (rec["traffic"]["workers"] * (hi - lo))
