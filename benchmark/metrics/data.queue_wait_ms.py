"""The host's wait on the loader's queue per optimizer step in the traced
dispatches, ms: the program's ``data.queue_wait`` spans (the consumer's
wait for its next batch, ``_Pass.take`` in ``data/loader.py``), over their
optimizer steps."""

from benchmark import spans


def read(rec):
    return spans.ms_per_step(rec, "data.queue_wait")
