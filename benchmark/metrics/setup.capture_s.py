"""Host seconds of the set-up's second dispatch (the CUDA graph's capture,
instantiation and first launch): the program's ``setup.capture_s``
counter."""

from benchmark import spans


def read(rec):
    return spans.counter("setup.capture_s", rec)
