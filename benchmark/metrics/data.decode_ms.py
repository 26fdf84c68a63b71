"""JPEG decoding per optimizer step in the traced dispatches, ms summed over
the loader's threads: the program's ``data.decode`` spans (each frame's
``_imread_f32`` in ``data/datasets.py``), over their optimizer steps."""

from benchmark import spans


def read(rec):
    return spans.ms_per_step(rec, "data.decode")
