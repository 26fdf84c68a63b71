"""One run of a training cell on the port, in one process (one rank).

Set-up builds the one train step that the window drives, as the port's
train CLI composes it (``train.py``): the dataset (a JPEG tree from the
pool, packed once by ``data.packed.pack_dataset`` for the packed mixes),
``BatchLoader`` -> ``device_prefetch`` -> groups of K stacked batches, the
host ``train_transform`` for JPEG mixes that augment on the host, and the
configuration's family's program (``families/<family>/program.py``): its
networks, optimizer and train step of K steps a dispatch. Its first two
dispatches (on the card: K eager steps, then the CUDA graph's capture and
first replay) train on the loader's first batches, and the optimizer's step
hook reads what the reference checks: every leaf's gradient as Adam holds
it after step 1 and its change after step 3. The state before the second
dispatch, and that dispatch's losses and changes, are kept too, so that the
check also holds a replay of the graph. The window then dispatches until
``seconds`` have passed and waits for the card. With ``trace`` the window
also times each dispatch on the card (CUDA events) and a few dispatches
after it run under the profiler.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
from typing import Callable, Dict

import numpy as np
import torch

from . import dataset, spec, trace as tracing

CHECKED_STEPS = 3
TRACED_DISPATCHES = 2


def grouped(batches, k: int):
    """``k`` consecutive staged ``(batch, n_valid)`` pairs stacked on a new
    leading axis on the device, a trailing partial group dropped (the train
    CLI's ``_grouped``)."""
    if k == 1:
        yield from batches
        return
    group = []
    for batch, _ in batches:
        group.append(batch)
        if len(group) == k:
            yield {key: torch.stack([g[key] for g in group]) for key in group[0]}, None
            group = []


def feed(loader, device, k: int):
    """The train CLI's batches, epoch after epoch (each epoch a fresh pass
    of the loader and of ``device_prefetch``, as in ``train.py``)."""
    from sc_sfmlearner_release_tpu_torch.parallel import device_prefetch

    epoch = 0
    while True:
        loader.set_epoch(epoch)
        for batch, _ in grouped(device_prefetch(loader, device), k):
            yield batch
        epoch += 1


def build_data(cfg: dict, traffic: dict, seed: int, workdir: str) -> str:
    """The traffic's dataset under ``workdir``: the JPEG tree and, for a
    packed mix, its packed directory. Returns the tree's root."""
    from sc_sfmlearner_release_tpu_torch.data import pack_dataset

    files = dataset.pool_files(traffic)
    scenes = dataset.layout(seed, traffic["scenes"], traffic["frames_per_scene"], len(files))
    root = dataset.write_tree(os.path.join(workdir, "tree"), scenes, files)
    if traffic["data_path"] == "packed":
        pack_dataset(root)
    return root


def train_set(cfg: dict, traffic: dict, root: str):
    from sc_sfmlearner_release_tpu_torch.data import (PackedSequenceSet, SequenceSet,
                                                       transforms)

    if traffic["data_path"] == "packed":
        tf = None if traffic["device_augment"] else transforms.train_transform()
        return PackedSequenceSet(os.path.join(root, "packed"), train=True,
                                 sequence_length=cfg["sequence_length"], transform=tf)
    tf = transforms.raw_train_transform() if traffic["device_augment"] \
        else transforms.train_transform()
    return SequenceSet(root, train=True, sequence_length=cfg["sequence_length"], transform=tf)


class Program:
    """The system under test, built once: the family's leaves, optimizer
    and train step, and the feed of its batches."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, root: str):
        from sc_sfmlearner_release_tpu_torch.data import BatchLoader
        from sc_sfmlearner_release_tpu_torch.parallel import distributed

        self.k = cfg["fused_steps"]
        self.device = device
        built = spec.family(cfg["family"], "program").build(cfg, traffic, seed, device)
        self.named, self.optimizer, self.step = built["named"], built["optimizer"], built["step"]
        self.loader = BatchLoader(
            train_set(cfg, traffic, root), cfg["batch_size"] * distributed.data_count(),
            shuffle=True, num_workers=traffic["workers"], drop_last=True, seed=seed,
            pin_memory=device.type == "cuda", process_index=distributed.data_index(),
            process_count=distributed.data_count())
        self.feed = feed(self.loader, device, self.k)

    def state(self) -> Dict[str, Dict]:
        """Each leaf's parameter, Adam's moments and step count, on the host."""
        out = {}
        for n, p in self.named:
            st = self.optimizer.state.get(p, {})
            zero = torch.zeros_like(p, device="cpu")
            out[n] = {"param": p.detach().to("cpu", copy=True),
                      "exp_avg": st["exp_avg"].to("cpu", copy=True) if st else zero,
                      "exp_avg_sq": st["exp_avg_sq"].to("cpu", copy=True) if st else zero,
                      "step": int(float(st["step"])) if st else 0}
        return out

    def first_steps(self, dispatches: int = 2) -> Dict:
        """The set-up's dispatches, with the optimizer's step hook reading
        each leaf's gradient after step 1 (Adam's first moment over
        ``1 - beta1``) and its change after step ``CHECKED_STEPS``. The last
        dispatch (on the card, the CUDA graph's capture and first replay)
        is kept whole for the check: the state it starts from (``state``),
        its losses and each leaf's change over it. Returns those norms and
        losses and the data waits."""
        if self.device.type == "cuda" and 1 < self.k < CHECKED_STEPS:
            raise ValueError(f"fused_steps {self.k}: the checked steps would be captured")
        params = [p for _, p in self.named]
        # On the host, so the snapshot adds nothing to the card's peak.
        start = [p.detach().to("cpu", copy=True) for p in params]
        read, count = {}, [0]

        def hook(opt, args, kwargs):
            count[0] += 1
            if count[0] == 1:
                beta1 = opt.param_groups[0]["betas"][0]
                zero = torch.zeros((), device=params[0].device)
                read["grad1"] = torch.stack([
                    opt.state[p]["exp_avg"].norm() / (1.0 - beta1)
                    if p in opt.state and "exp_avg" in opt.state[p] else zero for p in params])
            if count[0] == CHECKED_STEPS:
                read["update"] = torch.stack([(p.detach().cpu() - s).norm()
                                              for p, s in zip(params, start)])
                start.clear()

        handle = self.optimizer.register_step_post_hook(hook)
        losses, waits = [], []
        try:
            for d in range(dispatches):
                if d == dispatches - 1:
                    before = self.state()
                t = time.perf_counter()
                batch = next(self.feed)
                waits.append(time.perf_counter() - t)
                losses.append(self.step(batch)["loss"].reshape(-1))
                if count[0] >= CHECKED_STEPS:
                    handle.remove()
        finally:
            handle.remove()
        replay = {"first": (dispatches - 1) * self.k, "state": before,
                  "losses": losses[-1].double().cpu().tolist(),
                  "update": {n: float((p.detach().cpu() - before[n]["param"]).norm())
                             for n, p in self.named}}
        losses = torch.cat(losses)
        if len(losses) < CHECKED_STEPS:
            raise RuntimeError(f"the set-up ran {len(losses)} steps, fewer than {CHECKED_STEPS}")
        # An optimizer that never stepped left every leaf as it was.
        names = [n for n, _ in self.named]
        zeros = torch.zeros(len(names))
        return {"losses": losses[:CHECKED_STEPS].double().cpu().tolist(),
                "grad1": dict(zip(names, read.get("grad1", zeros).double().cpu().tolist())),
                "update": dict(zip(names, read.get("update", zeros).double().cpu().tolist())),
                "replay": replay, "waits": waits}

    def window(self, go: Callable[[float], bool], timed: bool) -> Dict:
        """Dispatch while ``go(seconds elapsed)``, then wait for the card.
        ``timed`` adds CUDA events around each dispatch."""
        cuda = self.device.type == "cuda"
        waits, events, losses = [], [], []
        t0 = time.perf_counter()
        while go(time.perf_counter() - t0):
            t = time.perf_counter()
            batch = next(self.feed)
            waits.append(time.perf_counter() - t)
            if timed and cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            losses.append(self.step(batch)["loss"])
            if timed and cuda:
                ev[1].record()
                events.append(ev)
        if cuda:
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        losses = torch.stack(losses).cpu() if losses else torch.zeros((0, self.k))
        return {"seconds": wall, "dispatches": len(waits), "steps": len(waits) * self.k,
                "wait_s": waits, "device_ms": [a.elapsed_time(b) for a, b in events] or None,
                "failed": int((~torch.isfinite(losses).all(dim=-1)).sum())}

    def close(self) -> None:
        self.feed.close()


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        log: Callable[[str], None] = print, root: str = None,
        go: Callable[[float], bool] = None, ready: Callable[[], None] = None) -> Dict:
    """Set-up, window and (``trace``) the profiled dispatches of one run in
    this process; the program is freed before returning. ``root`` is a
    dataset already built (else one is built here, and removed after);
    under a process group ``go`` is the ranks' shared decision to dispatch
    again and ``ready`` their meeting before the window."""
    cuda = device.type == "cuda"
    workdir = None
    program = None
    try:
        t = time.perf_counter()
        if root is None:
            workdir = tempfile.mkdtemp(prefix="benchmark-data-")
            root = build_data(cfg, traffic, seed, workdir)
        log(f"[setup] data {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        program = Program(cfg, traffic, seed, device, root)
        log(f"[setup] program {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        first = program.first_steps()
        if cuda:
            torch.cuda.synchronize(device)
        log(f"[setup] first dispatches {time.perf_counter() - t:.3f} s "
            f"(data waits {[round(w, 4) for w in first['waits']]})")
        if ready is not None:
            ready()
        window_start = time.monotonic()
        win = program.window(go or (lambda elapsed: elapsed < seconds), trace)
        # The program's peak through its set-up (the eager steps, the
        # capture) and the window: replays allocate nothing.
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        traced = None
        if trace:
            traced = tracing.profile(program.step, program.feed, TRACED_DISPATCHES, program.k,
                                     device)
        return {"first": first, "window": win, "window_start": window_start,
                "peak_bytes": peak, "trace": traced}
    finally:
        if program is not None:
            program.close()
        del program
        gc.collect()
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        if workdir is not None:
            shutil.rmtree(workdir, ignore_errors=True)
