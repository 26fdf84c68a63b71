"""The card's time per optimizer step of the train step's dispatches, ms:
CUDA events on the step's stream around each dispatch of the window
(inputs staged, the graph replayed, metrics copied), summed, over the
window's optimizer steps. Only the traced run times them."""


def read(rec):
    win = rec["window"]
    if not win["device_ms"] or not win["steps"]:
        return None
    return sum(win["device_ms"]) / win["steps"]
