"""Host data wait per optimizer step, ms: the host clock around each fetch
of the next group of batches in the window (the train CLI's ``waited``),
summed, over the window's optimizer steps."""


def read(rec):
    win = rec["window"]
    if not win["steps"]:
        return None
    return 1e3 * sum(win["wait_s"]) / win["steps"]
