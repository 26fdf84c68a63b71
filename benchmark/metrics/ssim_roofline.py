"""The ssim kernel's share of its bandwidth bound in the traced
dispatches, %: the bytes of its launches at the cell's shapes
(``yardstick.KERNEL_BYTES``) at 3.35 TB/s, over its device time per step."""

from benchmark import yardstick


def read(rec):
    return yardstick.roofline_pct("ssim", rec)
