"""Host seconds of the set-up's first dispatch (K eager steps that warm up
Adam's state, cuDNN's plans and the allocator): the program's
``setup.warm_s`` counter."""

from benchmark import spans


def read(rec):
    return spans.counter("setup.warm_s", rec)
