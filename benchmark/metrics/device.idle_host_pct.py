"""The card's idle share that the host caused in the traced dispatches, %:
the idle gaps of the device span inside which a host CUDA call that
enqueues work (``spans.ENQUEUE``) begins or returns, so the card had
nothing queued, over the device span. The rest of ``device.idle_pct`` is
idle with work queued: between the records of a replay."""

from benchmark import spans


def read(rec):
    gaps = spans.host_gaps(rec)
    if gaps is None:
        return None
    return 100.0 * sum(e - s for s, e in gaps) / spans.device_span_us(rec)
