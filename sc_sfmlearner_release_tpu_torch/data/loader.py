"""Host-side prefetching batch loader.

The port's own copy of the JAX package's ``data/loader.py`` (with its
per-process slices of the global batch), with one addition:
``pin_memory=True`` stacks every batch straight into page-locked host
tensors on the loader's thread, so that ``parallel.device_prefetch`` can
copy them to the card without blocking the step's thread.

Replaces ``torch.utils.data.DataLoader(num_workers=4, pin_memory=True)``
(reference: the reference's train.py:142-147) with a thread-pool pipeline:
JPEG decode + augmentation release the GIL in C, so threads keep the card
fed without process overhead. Batches are fixed-shape NHWC arrays; a
background prefetch queue overlaps host IO with device compute.

Determinism: worker randomness is keyed by (epoch seed, sample index), so a
run is reproducible for any worker count — stronger than the reference,
whose aug stream depends on worker scheduling.
"""

from __future__ import annotations

import concurrent.futures
import functools
import itertools
import queue
import threading
from typing import Dict, Iterator, List

import numpy as np

from ..utils import profiling

# Batches staged ahead of the consumer by the loader's thread.
PREFETCH = 2


def _stack(arrays: List[np.ndarray], pin_memory: bool):
    """``np.stack(arrays)``; with ``pin_memory``, into a page-locked torch
    tensor of the same dtype, written in place (no second copy)."""
    if not pin_memory:
        return np.stack(arrays)
    import torch

    first = np.asarray(arrays[0])
    dtype = torch.from_numpy(np.empty(0, first.dtype)).dtype
    out = torch.empty((len(arrays),) + first.shape, dtype=dtype, pin_memory=True)
    np.stack(arrays, out=out.numpy())
    return out


class BatchLoader:
    """Iterable over fixed-shape batches of a dataset with ``load(i, rng)``.

    Args:
      dataset: object with ``__len__`` and ``load(index, rng) -> dict``.
      batch_size: global batch size; must divide by ``process_count``.
      shuffle: reshuffle each epoch (seeded).
      num_workers: decode/augment thread count.
      drop_last: drop the trailing partial batch (training). When False, the
        final batch is padded by repeating the last sample and the true count
        of the global batch is reported in ``batch["_n_valid"]`` (validation).
      seed: base seed; epoch ``e`` uses ``seed + e``.
      pin_memory: yield page-locked torch tensors (needs a CUDA build)
        instead of numpy arrays; ``_n_valid`` stays a numpy scalar.
      process_index / process_count: data parallelism over processes (the
        train CLI's ``--distributed``): each process loads only its
        contiguous ``batch_size / process_count`` slice of every global
        batch, rows ``process_index * b ... (process_index + 1) * b - 1``.
        Under width sharding the trainer passes its data group's index and
        count: the processes of a group load the same rows at full width,
        and the steps cut the columns (``distributed.local_frames``).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 8,
        drop_last: bool = True,
        seed: int = 0,
        pin_memory: bool = False,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if batch_size % process_count:
            raise ValueError(
                f"global batch {batch_size} not divisible by {process_count} processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.pin_memory = pin_memory
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._indices()
        bs = self.batch_size
        n_batches = len(self)
        if n_batches == 0:
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def load_one(b: int, i: int) -> Dict[str, np.ndarray]:
            with profiling.span("data.sample", b):
                rng = np.random.default_rng(
                    np.random.SeedSequence([self.seed + self.epoch, int(i)])
                )
                return self.dataset.load(int(i), rng)

        local_bs = bs // self.process_count

        def producer() -> None:
            try:
                produce()
            except Exception as exc:  # raised again on the consumer's side
                out_q.put(exc)
                return
            out_q.put(None)

        def produce() -> None:
            with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    chunk = indices[b * bs : (b + 1) * bs]
                    n_valid = len(chunk)
                    if n_valid < bs:  # pad the trailing validation batch
                        chunk = np.concatenate(
                            [chunk, np.repeat(chunk[-1:], bs - n_valid)]
                        )
                    # this process's contiguous slice of the global batch
                    chunk = chunk[self.process_index * local_bs
                                  : (self.process_index + 1) * local_bs]
                    samples = list(pool.map(functools.partial(load_one, b), chunk))
                    batch = {
                        k: _stack([s[k] for s in samples], self.pin_memory)
                        for k in samples[0]
                    }
                    batch["_n_valid"] = np.asarray(n_valid, np.int32)
                    out_q.put(batch)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            for b in itertools.count():
                with profiling.span("data.queue_wait", b):
                    batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            # Drain so the producer can exit if we stopped early.
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.1)
