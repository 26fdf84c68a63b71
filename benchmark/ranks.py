"""A cell on several cards: one process per card, as the train CLI's
``--distributed`` runs, started by the port's
``parallel.distributed.run_processes`` (torchrun's environment, NCCL on
the cards). The dataset is built once, before the ranks start. Every rank
runs the same set-up and window; rank 0 decides when the window ends and
tells the others over a gloo group (every dispatch holds collectives, so
the ranks must dispatch alike). Every rank runs its traced dispatches
under the profiler, so that they stay in step; rank 0's trace, spans and
counters stand for the run (carried to the reader's process), its busy
seconds beside its own traced window, and the peak memory is the fullest
card's.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
import time
from typing import Callable, Dict

import torch

from . import cell as harness
from . import spans


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _rank(device, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
          root: str) -> Dict:
    import torch.distributed as dist

    from sc_sfmlearner_release_tpu_torch.parallel import distributed

    rank = distributed.process_index()
    gloo = dist.new_group(backend="gloo")

    def go(elapsed: float) -> bool:
        flag = torch.tensor([int(elapsed < seconds)], dtype=torch.int32)
        dist.broadcast(flag, 0, group=gloo)
        return bool(flag.item())

    out = harness.run(cfg, traffic, seed, seconds, trace, device,
                      _log if rank == 0 else (lambda msg: None), root=root, go=go,
                      ready=lambda: dist.barrier(group=gloo))
    if rank:
        return {"peak_bytes": out["peak_bytes"], "failed": out["window"]["failed"]}
    if trace:
        spans.carry(out)
    return out


def no_exchange_rank(device, *args) -> Dict:
    """A rank with a planted fault, for the limits' readings and the tests:
    its gradients and metrics are never summed over the ranks."""
    from sc_sfmlearner_release_tpu_torch.parallel import distributed

    distributed.sum_grads_and_metrics = lambda params, metrics: metrics
    return _rank(device, *args)


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device_type: str,
        log: Callable[[str], None], rank_fn: Callable = _rank) -> Dict:
    """``cell.run``'s result for ``traffic["world_size"]`` ranks, each
    running ``rank_fn`` (a module's top-level function, as spawned
    processes import it)."""
    from sc_sfmlearner_release_tpu_torch.parallel import distributed

    world = traffic["world_size"]
    workdir = tempfile.mkdtemp(prefix="benchmark-data-")
    try:
        t = time.perf_counter()
        root = harness.build_data(cfg, traffic, seed, workdir)
        log(f"[setup] data for {world} ranks {time.perf_counter() - t:.3f} s")
        results = distributed.run_processes(
            rank_fn, world, device_type, args=(cfg, traffic, seed, seconds, trace, root),
            timeout=330.0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out = results[0]
    out["peak_bytes"] = max(r["peak_bytes"] for r in results)
    out["window"]["failed"] = max(r["failed"] if "failed" in r else r["window"]["failed"]
                                  for r in results)
    return out
