"""Data parallelism over processes: one process per card, the global batch
split across them.

The counterpart of the data-parallel half of the JAX package's
``parallel/mesh.py`` (``make_mesh``, ``shard_batch``, ``replicate``). There
the train step is one program over the global batch, sharded over a device
mesh, and XLA inserts the collectives. Here every process runs the step on
its own contiguous slice of the global batch (the loader's
``process_index``/``process_count``), and the port inserts the collectives
itself, where the JAX program's global reductions are:

  * BatchNorm's train-mode statistics (``models/resnet.py``): per-channel
    sums, sums of squares and counts, all-reduced in the forward, and the
    sums of the gradient's terms all-reduced in the backward, so each
    process's input gradient carries the other processes' losses;
  * the loss's masked means (``ops/losses.py``) and the depth metrics
    (``ops/metrics.py``): each process computes its numerator over the
    global denominator (:func:`global_sum` of masks and counts, which carry
    no gradient), so each process's loss is its share of the global loss;
  * the gradients and the logged metrics (:func:`sum_grads_and_metrics`):
    summed over processes after the backward, in one collective, which
    makes each process's gradient the global loss's.

Every helper is the identity where no process group is initialised, so one
process computes exactly what it did before. ``init_distributed`` joins
the group that ``torchrun`` describes: NCCL on CUDA, gloo on the CPU.
:func:`run_processes` starts such a group itself, on this host, and
returns what each rank computed. :func:`replicate` broadcasts process 0's networks and optimizer state, so
no process depends on seeding or restoring the same state as the others.

Width sharding (the counterpart of ``make_mesh_2d``/``_spec_for`` and the
train CLI's ``--spatial-shards S``): :func:`init_distributed` with
``spatial_shards=S`` splits the world as ``make_mesh_2d`` reshapes its
devices, ``(world // S, S)``: rank ``r`` has data index ``r // S`` and
spatial index ``r % S``, and the S adjacent ranks of a data group share its
rows, each holding one equal column slice of every image. The rows of the
global batch go by data index (:func:`local_rows`, :func:`global_rows`,
the loader), the columns by spatial index (:func:`local_columns`; the
steps cut their input frames in one place, :func:`local_frames`), and the
collectives that GSPMD inserts become autograd Functions within the data
group's spatial group: :func:`halo` (edge columns of the neighbours),
:func:`gather_width` (the whole width) and :func:`spatial_sum`
(``parallel/spatial.py`` builds the halo-aware convolutions, pads and
pools on them). They are all-gathers and all-reduces, never point-to-point
sends, which gloo refuses on CUDA tensors. With S = 1 each is the
identity, and the data index and count are the process's.
"""

from __future__ import annotations

import gc
import os
import socket
import tempfile
import time
from typing import Callable, Dict, Iterable, List

import torch
import torch.distributed as dist

# What torchrun sets for each process it starts.
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def is_distributed() -> bool:
    """Whether a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if is_distributed() else 1


# The spatial split of the world (init_distributed's spatial_shards): the
# number of column slices per image and this process's spatial group.
_SPATIAL = {"count": 1, "group": None}


def spatial_count() -> int:
    """Column slices per image: the processes that share each row (1
    without width sharding)."""
    return _SPATIAL["count"]


def spatial_index() -> int:
    """This process's column slice, ``0 ... spatial_count() - 1``."""
    return process_index() % spatial_count()


def data_count() -> int:
    """The data groups: processes that hold distinct rows."""
    return process_count() // spatial_count()


def data_index() -> int:
    """This process's data group: which rows of the global batch it holds."""
    return process_index() // spatial_count()


def _split_spatial(spatial_shards: int) -> None:
    """Spatial groups of ``spatial_shards`` adjacent ranks (every rank
    creates every group, as ``new_group`` needs); the world's own group
    where it is one."""
    world, rank = process_count(), process_index()
    if spatial_shards < 1 or world % spatial_shards:
        raise ValueError(f"--spatial-shards {spatial_shards} must divide the world size "
                         f"{world}")
    group = None
    if 1 < spatial_shards < world:
        for first in range(0, world, spatial_shards):
            g = dist.new_group(list(range(first, first + spatial_shards)))
            if first <= rank < first + spatial_shards:
                group = g
    _SPATIAL.update(count=spatial_shards, group=group)


def backend_for(device) -> str:
    """The process group's backend for ranks on ``device``: NCCL on CUDA,
    unless this host's ranks (``LOCAL_WORLD_SIZE``, else ``WORLD_SIZE``)
    outnumber its cards, which NCCL refuses: then gloo on CUDA tensors,
    staged through the host, with ranks sharing cards. Gloo on the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo"
    ranks = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "gloo" if ranks > torch.cuda.device_count() else "nccl"


def init_distributed(device="cuda", spatial_shards: int = 1) -> torch.device:
    """Join the process group of torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return this process's device; with ``spatial_shards`` S > 1, split it
    into data groups of S adjacent ranks that share their rows (S must
    divide the world size: a ValueError, after which the group is left).

    On CUDA the process binds ``cuda:LOCAL_RANK`` before it joins (and
    before anything else of the process should touch the card). The
    backend is :func:`backend_for`'s. Raises when the environment is
    incomplete or the card is missing: nothing falls back to one process."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs torchrun's environment, but {', '.join(missing)} "
            f"{'is' if len(missing) == 1 else 'are'} unset: launch with "
            "`torchrun --nproc_per_node=N -m sc_sfmlearner_release_tpu_torch.train ... "
            "--distributed`")
    if is_distributed():
        raise RuntimeError("a process group is already initialised")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    device = torch.device(device)
    if device.type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local}, but {torch.cuda.device_count()} "
                               "CUDA device(s) are visible")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend_for(device),
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world)
    try:
        _split_spatial(spatial_shards)
    except ValueError:
        leave()
        raise
    return device


def leave() -> None:
    """Leave the process group, if one is initialised. NCCL's communicator
    is destroyed only once no CUDA graph holds its collectives (until then
    the destruction waits): the graphs the caller dropped are collected
    first."""
    _SPATIAL.update(count=1, group=None)
    if is_distributed():
        gc.collect()
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every process (nothing without a process group)."""
    if is_distributed():
        dist.barrier()


def local_rows(global_batch: int) -> slice:
    """This process's contiguous slice of a global batch: rows
    ``d * b ... (d + 1) * b - 1`` of data group ``d`` (the process itself
    without width sharding), ``b`` the local batch."""
    count = data_count()
    if global_batch % count:
        raise ValueError(f"global batch {global_batch} not divisible by {count} data groups")
    b = global_batch // count
    return slice(data_index() * b, (data_index() + 1) * b)


def global_rows(local_batch: int, device=None) -> torch.Tensor:
    """The global row numbers of this process's ``local_batch`` rows."""
    return data_index() * local_batch + torch.arange(local_batch, device=device)


def local_columns(width: int) -> slice:
    """This process's column slice of an image ``width`` wide: the
    ``width / S`` columns of spatial index ``s``."""
    count = spatial_count()
    if width % count:
        raise ValueError(f"width {width} not divisible by {count} spatial shards")
    w = width // count
    return slice(spatial_index() * w, (spatial_index() + 1) * w)


# The entries of a batch that width sharding cuts, ``[..., H, W, C]``: the
# frames, not the intrinsics or the ground-truth depth.
FRAME_KEYS = ("tgt", "refs", "img")


def local_frames(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``batch`` (the data group's rows at full width) with its frames cut
    to this process's columns, every other entry as it is: where the train
    and eval steps cut their inputs, after the device augmentation. The
    batch itself without width sharding."""
    if spatial_count() == 1:
        return batch
    return {k: v[..., local_columns(v.shape[-2]), :].contiguous() if k in FRAME_KEYS else v
            for k, v in batch.items()}


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over processes, without gradient (masks, counts and
    statistics). Sums in place: pass a tensor of your own, such as the
    result of a reduction. ``x`` itself without a process group."""
    if not is_distributed():
        return x
    x = x.detach()
    dist.all_reduce(x)
    return x


# Collectives the width-sharding helpers have called in the spatial group
# (all-gathers and all-reduces, forward and backward), counted on the host:
# a CUDA graph's replays call none.
spatial_collectives = {"all_gather": 0, "all_reduce": 0}


def _gather(x: torch.Tensor) -> List[torch.Tensor]:
    """Every spatial shard's ``x`` (the same shape on each), in spatial order."""
    spatial_collectives["all_gather"] += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(spatial_count())]
    dist.all_gather(parts, x, group=_SPATIAL["group"])
    return parts


def _spatial_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the spatial group, into a copy."""
    spatial_collectives["all_reduce"] += 1
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=_SPATIAL["group"])
    return x


class _Halo(torch.autograd.Function):
    """``x``'s columns along ``dim`` widened by the last ``left`` columns
    of the left neighbour and the first ``right`` of the right one, where
    those neighbours exist (not at the image's edges). One all-gather of
    every shard's edge strips; the backward sends the halo's gradient back
    by another and adds it into the edges it came from."""

    @staticmethod
    def forward(ctx, x, left, right, dim):
        w, i, s = x.shape[dim], spatial_index(), spatial_count()
        if left > w or right > w:
            raise ValueError(f"a halo of {left} and {right} columns from a shard of {w}")
        parts = _gather(torch.cat([x.narrow(dim, 0, right), x.narrow(dim, w - left, left)],
                                  dim))
        lo, hi = (left if i > 0 else 0), (right if i < s - 1 else 0)
        ctx.shape = (w, left, right, lo, hi, dim)
        pieces = ([parts[i - 1].narrow(dim, right, lo)] if lo else []) + [x] + (
            [parts[i + 1].narrow(dim, 0, hi)] if hi else [])
        return torch.cat(pieces, dim)

    @staticmethod
    def backward(ctx, g):
        w, left, right, lo, hi, dim = ctx.shape
        i = spatial_index()

        def strip(start, length, full):
            if length:
                return g.narrow(dim, start, length)
            shape = list(g.shape)
            shape[dim] = full
            return g.new_zeros(shape)

        parts = _gather(torch.cat([strip(0, lo, left), strip(lo + w, hi, right)], dim))
        dx = g.narrow(dim, lo, w).clone(memory_format=torch.contiguous_format)
        if i < spatial_count() - 1 and left:  # the right neighbour's left halo
            dx.narrow(dim, w - left, left).add_(parts[i + 1].narrow(dim, 0, left))
        if i > 0 and right:  # the left neighbour's right halo
            dx.narrow(dim, 0, right).add_(parts[i - 1].narrow(dim, left, right))
        return dx, None, None, None


class _GatherWidth(torch.autograd.Function):
    """Every shard's ``x`` concatenated along ``dim`` in spatial order (the
    whole width); the backward sums the gradient over the spatial group and
    keeps this shard's columns."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.width = dim, x.shape[dim]
        return torch.cat(_gather(x), dim)

    @staticmethod
    def backward(ctx, g):
        return _spatial_all_reduce(g).narrow(
            ctx.dim, spatial_index() * ctx.width, ctx.width), None


class _SpatialSum(torch.autograd.Function):
    """``x`` summed over the spatial group; every shard's result depends on
    every shard's ``x``, so the backward sums the gradient the same way."""

    @staticmethod
    def forward(ctx, x):
        return _spatial_all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return _spatial_all_reduce(g)


def halo(x: torch.Tensor, left: int, right: int, dim: int = -1) -> torch.Tensor:
    """``x`` widened along ``dim`` by the neighbouring shards' ``left`` and
    ``right`` edge columns (none beyond the image's edges: the caller pads
    those); differentiable. ``x`` itself without width sharding."""
    if spatial_count() == 1 or not (left or right):
        return x
    return _Halo.apply(x, left, right, dim % x.dim())


def gather_width(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole width of a width-sharded ``x`` along ``dim`` on every shard
    of the data group; differentiable. ``x`` without width sharding."""
    if spatial_count() == 1:
        return x
    return _GatherWidth.apply(x, dim % x.dim())


def spatial_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the shards of the data group; differentiable. ``x``
    without width sharding."""
    if spatial_count() == 1:
        return x
    return _SpatialSum.apply(x)


def _copy_back(flat: torch.Tensor, tensors: List[torch.Tensor]) -> None:
    """Inverse of ``torch.cat([t.reshape(-1) for t in tensors])``, in place."""
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [p.view_as(t) for p, t in zip(parts, tensors)])


def sum_grads_and_metrics(parameters: Iterable[torch.Tensor],
                          metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """After the backward: every parameter's gradient and each 0-d metric
    summed over processes in one collective; returns the summed metrics.
    Each process's loss is its share of the global loss, so the sums are
    the global loss's gradient and the global metrics. Parameters without
    a gradient (the same on every process) are left out. Without a process
    group, ``metrics`` as they are.

    One flat buffer, not DDP: a single collective a step, which a CUDA
    graph of the step captures as it is, and a sum, where DDP's buckets
    average and hook into the backward (26.8 M fp32 gradients, 107 MB,
    take 0.5 ms on one H100 and 0.9 ms between two over NVLink)."""
    if not is_distributed():
        return metrics
    values = torch.stack([v.detach().float() for v in metrics.values()])
    tensors = [p.grad for p in parameters if p.grad is not None] + [values]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    _copy_back(flat, tensors)
    return dict(zip(metrics, values.unbind()))


def sum_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """0-d metric shares summed over processes in one collective."""
    if not is_distributed():
        return metrics
    values = global_sum(torch.stack([v.detach().float() for v in metrics.values()]))
    return dict(zip(metrics, values.unbind()))


def replicate(*modules_or_optimizers) -> None:
    """Broadcast process 0's parameters, buffers (BatchNorm statistics) and
    optimizer state (Adam's moments and steps) to every process, in place,
    one collective per dtype. Every process must hold the same structure:
    the same networks, and optimizer state on all or none of them (a
    resume loads it on every process). Nothing without a process group."""
    if not is_distributed():
        return
    tensors = []
    for obj in modules_or_optimizers:
        if isinstance(obj, torch.optim.Optimizer):
            for group in obj.param_groups:
                for p in group["params"]:
                    state = obj.state.get(p, {})
                    tensors += [state[k] for k in sorted(state) if torch.is_tensor(state[k])]
        else:
            tensors += list(obj.parameters()) + list(obj.buffers())
    # NCCL moves only CUDA tensors: a plain Adam's step counts on the CPU
    # travel through the card.
    nccl = dist.get_backend() == "nccl"
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for (_, device), group in groups.items():
            flat = torch.cat([t.reshape(-1) for t in group])
            if nccl and device.type != "cuda":
                flat = flat.to(torch.cuda.current_device())
            dist.broadcast(flat, 0)
            _copy_back(flat.to(device), group)


def free_port() -> int:
    """A free TCP port on localhost, for ``MASTER_PORT``."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_processes(fn: Callable, n: int, device="cuda", args: tuple = (),
                  timeout: float = 600.0, spatial_shards: int = 1,
                  join: bool = True) -> list:
    """``fn(device, *args)`` in ``n`` new processes, ranks ``0 ... n-1`` of
    one process group on this host (split into data groups of
    ``spatial_shards`` ranks); returns each rank's return value, in rank
    order. With ``join=False`` each process gets torchrun's environment
    but joins no group: ``fn`` joins it, as the train CLI's ``--distributed``
    does, and ``device`` is only the device type.

    On CUDA rank ``r`` runs on card ``r % cards``: over NCCL where there
    are ``n`` cards or more, else over gloo with ranks sharing cards
    (:func:`backend_for`). On the CPU over gloo, the host's threads split
    between the ranks. ``fn`` must be a module's top-level function and its
    value something ``torch.save`` writes. Raises when CUDA is asked for
    and absent, when a rank fails, and when the ranks are not done within
    ``timeout`` seconds (then every rank is ended)."""
    import torch.multiprocessing as mp

    from .. import resolve_device

    device = resolve_device(device)
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="ranks") as out:
        ctx = mp.start_processes(_run_rank,
                                 args=(fn, n, device.type, port, out, args, spatial_shards,
                                       join),
                                 nprocs=n, start_method="spawn", join=False)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{n} ranks still running after {timeout:.0f} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join()
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]


def _run_rank(rank: int, fn: Callable, n: int, device_type: str, port: int, out: str,
              args: tuple, spatial_shards: int, join: bool) -> None:
    """One rank of :func:`run_processes`: torchrun's environment, the group,
    ``fn``, and its value saved into ``out``."""
    local = rank % torch.cuda.device_count() if device_type == "cuda" else rank
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(n), "LOCAL_RANK": str(local),
                       "LOCAL_WORLD_SIZE": str(n), "MASTER_ADDR": "localhost",
                       "MASTER_PORT": str(port)})
    if device_type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    device = init_distributed(device_type, spatial_shards) if join else torch.device(
        device_type)
    try:
        torch.save(fn(device, *args), os.path.join(out, f"rank{rank}.pt"))
        barrier()
    finally:
        leave()
