"""The networks' device time per optimizer step in the traced dispatches,
ms: the kernels of the convolution/GEMM, BatchNorm and cuDNN layout groups
(``yardstick.KERNEL_GROUPS``)."""

from benchmark import yardstick


def read(rec):
    t = rec["trace"]
    if not t:
        return None
    us = sum(e - s for n, s, e in t["kernels"]
             if yardstick.group_of(n, rec.get("groups", ())) in yardstick.NETWORK_GROUPS)
    return us / 1e3 / t["steps"] if us > 0 else None
