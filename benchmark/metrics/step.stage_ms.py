"""The host's staging of each dispatch per optimizer step in the traced
dispatches, ms: the program's ``step.stage`` spans (``_GraphedSteps._stage``:
the batch copied into the graph's inputs, the K host maps, their copy),
over their optimizer steps."""

from benchmark import spans


def read(rec):
    return spans.ms_per_step(rec, "step.stage")
