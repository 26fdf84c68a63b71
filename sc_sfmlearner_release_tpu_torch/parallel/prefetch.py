"""Stage host batches on the device ahead of the step.

The counterpart of the JAX package's ``parallel/mesh.py::device_prefetch``
for one card: the process's own (``cuda:LOCAL_RANK`` under the train CLI's
``--distributed``, where each process stages its slice of the global
batch). On CUDA, each batch's copy is enqueued on a side stream
``size`` steps ahead, so it overlaps the steps before it; when the step
takes the batch, the current stream waits for that copy's event (the step
never reads a half-copied batch) and each tensor is recorded on it (its
memory is not reused before the step is done with it). The copy is
asynchronous only from page-locked memory: give the loader
``pin_memory=True``, which pins on the loader's thread.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, Iterator, Optional, Tuple

import torch

Batch = Dict[str, torch.Tensor]


def device_prefetch(
    iterator: Iterable[Dict], device, size: int = 2
) -> Iterator[Tuple[Batch, Optional[int]]]:
    """Yield ``(batch, n_valid)`` for each host batch of ``iterator``, with
    every array a tensor on ``device`` in its own dtype (uint8 stays uint8)
    and ``n_valid`` the loader's ``_n_valid`` as an int (None where the
    batch has none). On the CPU the arrays are only wrapped."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    queue = collections.deque()

    def put(batch):
        batch = dict(batch)
        n_valid = batch.pop("_n_valid", None)
        n_valid = None if n_valid is None else int(n_valid)
        host = {k: torch.as_tensor(v) for k, v in batch.items()}
        if stream is None:
            return host, n_valid, None, None
        with torch.cuda.stream(stream):
            staged = {k: v.to(device, non_blocking=True) for k, v in host.items()}
            copied = torch.cuda.Event()
            copied.record(stream)
        return staged, n_valid, copied, host  # the host arrays live until taken

    def take():
        staged, n_valid, copied, _ = queue.popleft()
        if copied is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(copied)
            for t in staged.values():
                t.record_stream(current)
        return staged, n_valid

    for batch in iterator:
        queue.append(put(batch))
        if len(queue) > size:
            yield take()
    while queue:
        yield take()
