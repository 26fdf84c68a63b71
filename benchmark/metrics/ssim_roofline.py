"""The ssim kernel's share of its bandwidth bound in the traced
dispatches, %: the bytes of its launches at the cell's shapes (the
family's ``kernels.KERNEL_BYTES``, as ``rec["kernel_bytes"]``) at
3.35 TB/s, over its device time per step."""

from benchmark import yardstick


def read(rec):
    return yardstick.roofline_pct("ssim", rec)
