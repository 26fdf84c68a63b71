"""FLOPs of one optimizer step of a configuration, as its family counts
them (``families/<family>/flops.py``'s ``flops_per_step``). The
configuration files hold the result (``flops_per_step``); a test recounts
it.

    python3 -m benchmark.flops benchmark/configs/<config>.json
"""

from __future__ import annotations

import json
import sys

from . import spec


def flops_per_step(cfg: dict) -> float:
    return spec.family(cfg["family"], "flops").flops_per_step(cfg)


if __name__ == "__main__":
    for path in sys.argv[1:]:
        with open(path) as f:
            print(path, repr(flops_per_step(json.load(f))))
