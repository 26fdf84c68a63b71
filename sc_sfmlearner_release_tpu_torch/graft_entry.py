"""Entry points: the flagship forward, and a multi-device dry run.

The port's counterpart of the repository's ``__graft_entry__.py``:

  * :func:`entry` returns the DispNet-18 forward at the canonical KITTI
    resolution (4x256x832) on the card, with its example input;
  * :func:`dryrun_multigpu` runs ONE full train step (both networks, the
    3-term loss, Adam, the device augmentation) data-parallel over ``n``
    processes at the JAX dry run's shapes (batch ``n``, N=2, 32x64), on the
    card unless the CPU is asked for: over NCCL with one card per process
    when the machine has ``n`` cards, otherwise over gloo with processes
    sharing cards; with ``device="cpu"`` over gloo on the CPU (the
    counterpart of the JAX dry run's re-exec onto an ``n``-device virtual
    CPU mesh). It prints which ran. It is :func:`dryrun_data_parallel`,
    then, with ``n`` even, the step again over a data x spatial-2 split
    (:func:`dryrun_data_spatial`: the JAX dry run's ``make_mesh_2d(2)``
    mesh, ``--spatial-shards 2``).

    python -m sc_sfmlearner_release_tpu_torch.graft_entry [N] [--device cpu]
"""

from __future__ import annotations

import math

import numpy as np
import torch


def entry():
    """``(fn, (net, img))``: ``fn(net, img)`` is DispNet-18's scale-0
    disparity of ``img`` ``[4, 256, 832, 3]`` in eval mode, on the card."""
    from . import resolve_device
    from .models import DispNet

    device = resolve_device(None)
    net = DispNet(18).to(device).eval()
    img = torch.zeros((4, 256, 832, 3), device=device)

    def fn(net, img):
        with torch.no_grad():
            return net(img)[0]

    return fn, (net, img)


def dryrun_multigpu(n_devices: int, device="cuda") -> float:
    """One full train step over ``n_devices`` processes; returns its loss.
    With ``n_devices`` even, then :func:`dryrun_data_spatial`.

    On CUDA (the default) over NCCL with one card per process where there
    are ``n_devices`` cards, else over gloo with processes sharing cards;
    on the CPU (``device="cpu"``) over gloo. Raises when CUDA is asked for
    and absent, when a process fails, or when the loss is not finite."""
    loss = dryrun_data_parallel(n_devices, device)
    if n_devices % 2 == 0:
        dryrun_data_spatial(n_devices, device)
    return loss


def dryrun_data_parallel(n_devices: int, device="cuda") -> float:
    """The dry run's step over ``n_devices`` data-parallel processes;
    returns its loss."""
    return _dryrun(n_devices, device, 1)


def dryrun_data_spatial(n_devices: int, device="cuda") -> float:
    """The dry run's step over ``n_devices / 2`` data groups of 2 width
    shards each; returns its loss."""
    return _dryrun(n_devices, device, 2)


def _dryrun(n_devices: int, device, spatial_shards: int) -> float:
    from .parallel import distributed

    loss, backend = distributed.run_processes(_dryrun_rank, n_devices, device,
                                              args=(n_devices,),
                                              spatial_shards=spatial_shards)[0]
    where = f"{n_devices} CPU processes" if torch.device(device).type == "cpu" else (
        f"{n_devices} processes on {torch.cuda.device_count()} card(s)")
    split = (f", data{n_devices // spatial_shards} x spatial{spatial_shards}"
             if spatial_shards > 1 else "")
    print(f"dryrun_multigpu(n={n_devices}{split}, {backend} over {where}): OK, "
          f"loss={loss:.4f}", flush=True)
    return loss


def _dryrun_rank(dev: torch.device, n_devices: int):
    """One rank of the dry run: ``(loss, backend)``. It takes its data
    group's rows at full width; the step cuts its columns."""
    from torch import distributed as dist

    from .data.device_augment import AugmentConfig, make_device_augment
    from .models import DispNet, PoseNet
    from .parallel import distributed
    from .training import LossConfig, make_optimizer, make_train_step

    b, n_refs, h, w = n_devices, 2, 32, 64
    rng = np.random.RandomState(0)
    k = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]], np.float32)
    rows = distributed.local_rows(b)
    batch = {"tgt": rng.rand(b, h, w, 3).astype(np.float32)[rows],
             "refs": rng.rand(b, n_refs, h, w, 3).astype(np.float32)[rows],
             "intrinsics": np.broadcast_to(k, (b, 3, 3))[rows].copy()}
    g = torch.Generator().manual_seed(0)
    disp, pose = DispNet(18, generator=g), PoseNet(18, generator=g)
    disp.to(dev)
    pose.to(dev)
    optimizer = make_optimizer(disp, pose, lr=1e-4)
    distributed.replicate(disp, pose, optimizer)
    # bf16 convolutions on the card, as the trainer's default; fp32 on the
    # CPU, whose bf16 convolutions are slow.
    step = make_train_step(disp, pose, optimizer, LossConfig(), device=dev,
                           precision="bf16" if dev.type == "cuda" else "fp32",
                           augment_fn=make_device_augment(AugmentConfig()))
    loss = float(step(batch)["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss in the multi-device dry run: {loss}")
    return loss, dist.get_backend()


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="One train step over N processes.")
    p.add_argument("n", type=int, nargs="?", default=2, help="processes (default 2)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; NCCL with a card per process, else gloo on shared "
                        "cards) or cpu (gloo)")
    a = p.parse_args()
    # The ranks import the function from the package, not from __main__.
    from sc_sfmlearner_release_tpu_torch import graft_entry

    graft_entry.dryrun_multigpu(a.n, a.device)
