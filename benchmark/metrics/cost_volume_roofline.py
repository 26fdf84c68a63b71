"""The cost-volume kernel's share of its bandwidth bound in the traced
dispatches, %: the bytes of its launch at the cell's shapes (each input
and output once, the family's ``kernels.KERNEL_BYTES``) at 3.35 TB/s, over
its device time per launch. Its taps are served from L1/L2, so it reads
far below 100."""

from benchmark import yardstick


def read(rec):
    return yardstick.roofline_pct("cost_volume", rec)
