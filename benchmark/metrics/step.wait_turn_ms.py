"""The host held back by the card per optimizer step in the traced
dispatches, ms: the program's ``step.wait_turn`` spans (``_GraphedSteps``
waiting for the replay two calls back before it refills a pinned buffer),
over their optimizer steps."""

from benchmark import spans


def read(rec):
    return spans.ms_per_step(rec, "step.wait_turn")
