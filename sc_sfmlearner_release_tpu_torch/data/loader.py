"""Host-side batch loader: the samples of the next batches in flight.

The port's own copy of the JAX package's ``data/loader.py`` (with its
per-process slices of the global batch), with its own schedule:

* ``num_workers`` threads load samples in the epoch's order, across batch
  boundaries, so that every thread has a sample to load while the
  consumer still wants batches: a batch of 4 keeps 8 threads busy, and no
  thread waits for a batch's slowest sample. The one limit is staging:
  the threads run ahead of the consumer by ``PREFETCH`` finished batches
  plus ``num_workers`` samples, the one constant.
* Each thread writes its sample's arrays into its row of the batch's
  output arrays: page-locked torch tensors under ``pin_memory``, so that
  ``parallel.device_prefetch`` can copy them to the card without blocking
  the step's thread, numpy arrays otherwise. No thread stacks a batch.
* The consumer takes the batches strictly in order, each once all of its
  rows are in; a sample's error is raised there in place of its batch.

Replaces ``torch.utils.data.DataLoader(num_workers=4, pin_memory=True)``
(reference: the reference's train.py:142-147) with threads: JPEG decode +
augmentation release the GIL in C, so threads keep the card fed without
process overhead. Batches are fixed-shape NHWC arrays.

Determinism: worker randomness is keyed by (epoch seed, sample index), so a
batch is the same for any worker count and any schedule — stronger than
the reference, whose aug stream depends on worker scheduling.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils import profiling

# Finished batches staged ahead of the consumer; the threads also start up
# to ``num_workers`` samples beyond them. A train step with
# ``--fused-steps 16`` takes 16 batches at once and then blocks through a
# CUDA-graph replay: the staging holds a whole dispatch's batches, so that
# the threads load through the replay instead of waiting for room. (With 2,
# the ResNet-50 JPEG script's 8 threads waited for room 56% of the time on
# an H100's host and trained 43-48 snippets/s; with 8, 58; with 32, 62-63.)
PREFETCH = 16


def _rows(first, n: int, pin_memory: bool):
    """An output of ``n`` rows of ``first``'s shape and dtype, and a numpy
    view of it to write the rows into; with ``pin_memory`` the output is a
    page-locked torch tensor."""
    first = np.asarray(first)
    if not pin_memory:
        out = np.empty((n,) + first.shape, first.dtype)
        return out, out
    import torch

    dtype = torch.from_numpy(np.empty(0, first.dtype)).dtype
    out = torch.empty((n,) + first.shape, dtype=dtype, pin_memory=True)
    return out, out.numpy()


class _Pass:
    """One pass of a ``BatchLoader``: the samples its threads share out,
    the batches they fill and the consumer's place."""

    def __init__(self, loader: "BatchLoader", order: np.ndarray, n_valid: List[int]):
        self.loader = loader
        self.order = order  # this process's sample indices, batch after batch
        self.n_valid = n_valid
        self.rows = len(order) // len(n_valid)
        self.epoch_seed = loader.seed + loader.epoch
        self.lock = threading.Lock()
        self.room = threading.Condition(self.lock)  # the threads wait here to start a sample
        self.ready = threading.Condition(self.lock)  # the consumer waits here for a batch
        self.alloc = threading.Lock()  # a batch's outputs, made by its first finished row
        self.next = 0  # position in ``order`` of the next sample to start
        self.taken = 0  # batches handed to the consumer
        self.left = [self.rows] * len(n_valid)  # rows of each batch not yet written
        self.out: List[Optional[Dict]] = [None] * len(n_valid)
        self.failed: Optional[Tuple[int, Exception]] = None  # earliest failed batch, error
        self.stopped = False

    def _claim(self) -> Optional[int]:
        """The position of the next sample to load, once staging has room;
        None when no sample is left to start."""
        with self.lock:
            while not (self.stopped or self.failed is not None or self.next == len(self.order)):
                if self.next < (self.taken + PREFETCH) * self.rows + self.loader.num_workers:
                    p = self.next
                    self.next += 1
                    return p
                self.room.wait()
            return None

    def _outputs(self, b: int, sample: Dict) -> Dict:
        with self.alloc:
            if self.out[b] is None:
                self.out[b] = {k: _rows(v, self.rows, self.loader.pin_memory)
                               for k, v in sample.items()}
            return self.out[b]

    def work(self) -> None:
        """One loader thread: load samples in order, each into its row."""
        while (p := self._claim()) is not None:
            b, r = divmod(p, self.rows)
            i = int(self.order[p])
            try:
                with profiling.span("data.sample", b):
                    rng = np.random.default_rng(np.random.SeedSequence([self.epoch_seed, i]))
                    sample = self.loader.dataset.load(i, rng)
                    out = self._outputs(b, sample)
                    if sample.keys() != out.keys():
                        raise KeyError(f"sample {i} has keys {sorted(sample)}, its batch "
                                       f"{sorted(out)}")
                    for k, v in sample.items():
                        out[k][1][r] = v
            except Exception as exc:  # raised again on the consumer's side
                with self.lock:
                    if self.failed is None or b < self.failed[0]:
                        self.failed = (b, exc)
                    self.ready.notify()
                return
            with self.lock:
                self.left[b] -= 1
                if not self.left[b]:
                    self.ready.notify()

    def take(self, b: int) -> Dict:
        """Batch ``b`` once all of its rows are in (the batches are taken in
        order); a failed sample of it raises its error."""
        with self.lock:
            while self.left[b] and (self.failed is None or self.failed[0] > b):
                self.ready.wait()
            if self.left[b]:  # every sample before this batch's was loaded
                raise self.failed[1]
            out, self.out[b] = self.out[b], None
            self.taken = b + 1
            self.room.notify_all()
        batch = {k: v for k, (v, _) in out.items()}
        batch["_n_valid"] = np.asarray(self.n_valid[b], np.int32)
        return batch

    def stop(self) -> None:
        """Start no more samples; those running finish."""
        with self.lock:
            self.stopped = True
            self.room.notify_all()


class BatchLoader:
    """Iterable over fixed-shape batches of a dataset with ``load(i, rng)``.

    Each pass starts ``num_workers`` threads, which load the pass's samples
    in order across batch boundaries, each straight into its row of its
    batch, up to ``PREFETCH`` finished batches plus ``num_workers`` samples
    ahead of the consumer; the batches are yielded in order. Leaving a pass
    early (``break``, ``close``) starts no more samples and joins the
    threads once their running samples end.

    Args:
      dataset: object with ``__len__`` and ``load(index, rng) -> dict``;
        every sample has the same keys, shapes and dtypes (a batch's
        outputs take the first finished sample's).
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

    Records the span ``data.sample`` around each sample's load and row
    write (on its thread, with its batch) and ``data.queue_wait`` around the
    consumer's wait for a batch.
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

    def _order(self, n_batches: int) -> Tuple[np.ndarray, List[int]]:
        """This process's sample indices, batch after batch, and each global
        batch's true count."""
        indices = self._indices()
        bs = self.batch_size
        local_bs = bs // self.process_count
        order, n_valid = [], []
        for b in range(n_batches):
            chunk = indices[b * bs : (b + 1) * bs]
            n_valid.append(len(chunk))
            if len(chunk) < bs:  # pad the trailing validation batch
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], bs - len(chunk))])
            # this process's contiguous slice of the global batch
            order.append(chunk[self.process_index * local_bs
                               : (self.process_index + 1) * local_bs])
        return np.concatenate(order), n_valid

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n_batches = len(self)
        if n_batches == 0:
            return
        run = _Pass(self, *self._order(n_batches))
        threads: List[threading.Thread] = []
        try:
            for b in range(n_batches):
                with profiling.span("data.queue_wait", b):
                    if b == 0:  # inside the first wait, so that no sample's span precedes it
                        for w in range(self.num_workers):
                            t = threading.Thread(target=run.work, name=f"BatchLoader-{w}",
                                                 daemon=True)
                            t.start()
                            threads.append(t)
                    batch = run.take(b)
                yield batch
        finally:
            run.stop()
            for t in threads:
                t.join()
