"""Kernel nodes of the train step's CUDA graph per optimizer step: the
program's ``step.graph_kernels`` counter (the nodes of the captured graph
of ``fused_steps`` steps), over ``fused_steps``."""

from benchmark import spans


def read(rec):
    nodes = spans.counter("step.graph_kernels", rec)
    return None if nodes is None else nodes / rec["config"]["fused_steps"]
