"""The loader's work per optimizer step in the traced dispatches, ms summed
over its threads: the program's ``data.sample`` spans (``load_one`` on the
pool's threads in ``data/loader.py``: read or decode, transform), over
their optimizer steps."""

from benchmark import spans


def read(rec):
    return spans.ms_per_step(rec, "data.sample")
