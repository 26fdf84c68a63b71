"""The part of ``device.idle_host_pct`` during which the host waited on the
loader's queue, %: the host-caused idle gaps cut to the program's
``data.queue_wait`` spans, over the device span."""

from benchmark import spans


def read(rec):
    gaps = spans.host_gaps(rec)
    waits = spans.named(rec, "data.queue_wait")
    if gaps is None or waits is None:
        return None
    # One consumer thread waits at a time: the spans are disjoint.
    waited = spans.overlap_us(gaps, [(s, e) for _, s, e in waits])
    return 100.0 * waited / spans.device_span_us(rec)
