"""Model FLOPs utilization of the whole window, %: the configuration's
frozen FLOPs per snippet times the snippets trained, over the window's
wall seconds and every card's bf16 dense peak."""

from benchmark import yardstick


def read(rec):
    win = rec["window"]
    if not win["steps"] or win["seconds"] <= 0:
        return None
    cfg, shapes = rec["config"], rec["shapes"]
    snippets = win["steps"] * shapes["global_batch"]
    flops = cfg["flops_per_step"] / cfg["batch_size"] * snippets
    return 100.0 * flops / win["seconds"] / (rec["chips"] * yardstick.PEAK_BF16_FLOPS)
