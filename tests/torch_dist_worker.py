"""One rank of the port's 2-process CPU runs (gloo), for
``tests/test_torch_distributed.py``.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_dist_worker.py {checks|cli} DIR

``checks`` reads ``DIR/inputs.pt`` (the test's global arrays and network
weights), runs every check's computation on this rank's slice and writes
``DIR/rank<r>.pt``. ``cli`` runs the train CLI with ``--distributed`` from
its own directory ``DIR/rank<r>`` and writes the SHA-256 of every tensor of
its networks, as they are in memory at the end, to ``DIR/nets<r>.json``.

``spatial_checks`` and ``spatial_step`` are the width-sharded ranks of
``tests/test_torch_spatial.py``, which starts them through
``distributed.run_processes``.
"""

import copy
import hashlib
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from sc_sfmlearner_release_tpu_torch.data import BatchLoader  # noqa: E402
from sc_sfmlearner_release_tpu_torch.data.device_augment import (  # noqa: E402
    AugmentConfig, make_device_augment,
)
from sc_sfmlearner_release_tpu_torch.models import DispNet, PoseNet  # noqa: E402
from sc_sfmlearner_release_tpu_torch.models.convert import gradient_state_dict  # noqa: E402
from sc_sfmlearner_release_tpu_torch.models.resnet import BatchNorm2d  # noqa: E402
from sc_sfmlearner_release_tpu_torch.ops import losses  # noqa: E402
from sc_sfmlearner_release_tpu_torch.parallel import distributed  # noqa: E402
from sc_sfmlearner_release_tpu_torch.training import (  # noqa: E402
    LossConfig, create_train_state, make_eval_depth_step, make_eval_step, make_optimizer,
    make_train_step,
)
from sc_sfmlearner_release_tpu_torch.training.checkpoint import CheckpointManager  # noqa: E402

LOADER_BATCH = 4


class CountingSet:
    """A dataset whose samples hold their index and a draw of their rng,
    so a batch shows which samples it holds and with which streams."""

    def __init__(self, n: int = 10):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def load(self, i, rng):
        return {"tgt": np.full((2, 3), i, np.float32) + rng.random((2, 3), np.float32),
                "index": np.asarray(i, np.int64)}


def seeded_nets(seed: int):
    g = torch.Generator().manual_seed(seed)
    return DispNet(18, generator=g), PoseNet(18, generator=g)


def nets_from(weights):
    disp, pose = DispNet(18), PoseNet(18)
    disp.load_state_dict(weights["disp"])
    pose.load_state_dict(weights["pose"])
    return disp, pose


def grads(*nets):
    return {f"{i}.{n}": p.grad.clone() for i, net in enumerate(nets)
            for n, p in net.named_parameters() if p.grad is not None}


def states(*nets):
    return [{k: v.clone() for k, v in net.state_dict().items()} for net in nets]


def step_run(nets, batch, **kw):
    """One fp32 train step of ``nets`` on this rank's ``batch``: metrics,
    the gradients before Adam (summed over ranks) by name and as state
    dicts (:func:`gradient_state_dict`), and the networks after."""
    optimizer = make_optimizer(*nets)
    distributed.replicate(*nets, optimizer)
    step = make_train_step(*nets, optimizer, LossConfig(), device="cpu", precision="fp32",
                           **kw)
    metrics = {k: float(v) for k, v in step(batch).items()}
    return {"metrics": metrics, "grads": grads(*nets), "nets": states(*nets),
            "grad_sds": [{k: v.clone() for k, v in gradient_state_dict(net).items()}
                         for net in nets]}


def checks(out_dir: str) -> dict:
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    rank = distributed.process_index()
    local = lambda a: a[distributed.local_rows(a.shape[0])]
    result = {}

    # (a) the loader's slice of every global batch.
    loader = BatchLoader(CountingSet(), LOADER_BATCH, shuffle=True, num_workers=2,
                         drop_last=False, seed=3, process_index=rank,
                         process_count=distributed.process_count())
    result["loader"] = list(loader)

    # (b) the masked means: each rank's share of the global mean.
    b = {k: torch.from_numpy(v) for k, v in inputs["losses"].items()}
    rows = distributed.local_rows(b["diff"].shape[0])  # the batch axis; [G, B, ...] grouped
    result["mean_on_mask"] = float(losses.mean_on_mask(b["diff"][rows], b["mask"][rows]))
    result["grouped"] = losses._grouped_mean_on_mask(b["gdiff"][:, rows],
                                                     b["gmask"][:, rows]).numpy()
    result["sample_mean"] = float(losses._sample_mean(b["x"][rows], None))
    result["sample_mean_masked"] = float(losses._sample_mean(b["x"][rows],
                                                             b["sample_mask"][rows]))

    # (c) BatchNorm in train mode on this rank's rows.
    bn_in = inputs["bn"]
    bn = BatchNorm2d(bn_in["x"].shape[1])
    bn.load_state_dict(bn_in["state"])
    x = torch.from_numpy(local(bn_in["x"])).requires_grad_()
    out = bn(x)
    (out * torch.from_numpy(local(bn_in["cotangent"]))).sum().backward()
    result["bn"] = {"out": out.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
                    "bias_grad": bn.bias.grad, "state": bn.state_dict()}

    # (d) a train step with the device augmentation, from seeded nets.
    aug = {k: torch.from_numpy(local(v)) for k, v in inputs["aug_batch"].items()}
    result["aug_step"] = step_run(seeded_nets(inputs["aug_seed"]), aug,
                                  augment_fn=make_device_augment(AugmentConfig()), aug_seed=5)

    # remat: the recomputation runs BatchNorm's all-reduces again, in order.
    result["remat_step"] = step_run(seeded_nets(inputs["aug_seed"]), aug,
                                    augment_fn=make_device_augment(AugmentConfig()), aug_seed=5,
                                    remat=True)

    # replicate: every rank starts from rank 0's networks and Adam state.
    torch.manual_seed(100 + rank)
    tiny = (torch.nn.Linear(3, 2), torch.nn.Linear(2, 1))
    adam = make_optimizer(*tiny)
    for p in adam.param_groups[0]["params"]:
        p.grad = torch.full_like(p, rank + 1.0)
    adam.step()
    distributed.replicate(*tiny, adam)
    result["replicated"] = {"nets": states(*tiny), "adam": copy.deepcopy(adam.state_dict())}

    # (e) a train step from the JAX-initialised nets, against JAX's mesh step.
    jax_batch = {k: local(v) for k, v in inputs["jax_batch"].items()}
    result["jax_step"] = step_run(nets_from(inputs["weights"]), jax_batch)

    # (f) the eval steps on a padded trailing batch: n_valid counts the
    # global batch.
    disp, pose = nets_from(inputs["weights"])
    ev = {k: local(v) for k, v in inputs["eval_batch"].items()}
    n_valid = inputs["n_valid"]
    result["eval"] = {k: float(v) for k, v in make_eval_step(
        disp, pose, LossConfig(), device="cpu", precision="fp32")(
        {**{k: ev[k] for k in ("tgt", "refs", "intrinsics")}, "n_valid": n_valid}).items()}
    result["eval_depth"] = {k: float(v) for k, v in make_eval_depth_step(
        disp, device="cpu", precision="fp32")(
        {"img": ev["tgt"], "depth": ev["depth"], "n_valid": n_valid}).items()}

    # (g) --fused-steps 2 against two unfused steps, from the same nets.
    nets = seeded_nets(inputs["aug_seed"] + 1)
    twins = copy.deepcopy(nets)
    stacked = {k: torch.from_numpy(np.stack([local(v), local(v[::-1].copy())]))
               for k, v in inputs["aug_batch"].items()}
    fused = make_train_step(*nets, make_optimizer(*nets), device="cpu", precision="fp32",
                            augment_fn=make_device_augment(AugmentConfig()), fused_steps=2)
    result["fused"] = {"metrics": {k: v.clone() for k, v in fused(stacked).items()},
                       "nets": states(*nets)}
    unfused = make_train_step(*twins, make_optimizer(*twins), device="cpu",
                              precision="fp32", augment_fn=make_device_augment(AugmentConfig()))
    per_step = [unfused({k: v[i] for k, v in stacked.items()}) for i in range(2)]
    result["unfused"] = {"metrics": {k: torch.stack([m[k] for m in per_step])
                                     for k in per_step[0]}, "nets": states(*twins)}

    # The checkpoint manager: process 0 writes, every process restores.
    tiny = (torch.nn.Linear(3, 2), torch.nn.Linear(2, 1))
    state = create_train_state(*tiny, make_optimizer(*tiny))
    distributed.replicate(*tiny, state.optimizer)
    mgr = CheckpointManager(os.path.join(out_dir, "manager"), max_to_keep=2)
    saved = {}
    for step in range(1, 4):
        for p in state.optimizer.param_groups[0]["params"]:
            p.grad = torch.ones_like(p)
        state.optimizer.step()
        mgr.save(state.step, state)
        saved[state.step] = states(*tiny)
    fresh = (torch.nn.Linear(3, 2), torch.nn.Linear(2, 1))
    restored = create_train_state(*fresh, make_optimizer(*fresh))
    mgr.restore(restored, step=2)
    result["manager"] = {"steps": mgr.all_steps(), "latest": mgr.latest_step(),
                         "restored_step": restored.step, "saved": saved[2],
                         "restored": states(*fresh)}
    return result


def run_cli(out_dir: str, argv) -> None:
    from sc_sfmlearner_release_tpu_torch import train as cli

    nets = {}
    make_train_step_ = cli.make_train_step

    def keep_nets(disp, pose, *args, **kwargs):
        nets.update(disp=disp, pose=pose)
        return make_train_step_(disp, pose, *args, **kwargs)

    cli.make_train_step = keep_nets
    rank = int(os.environ["RANK"])
    work = os.path.join(out_dir, f"rank{rank}")
    os.makedirs(work)
    os.chdir(work)
    if cli.main(argv) != 0:
        raise SystemExit(f"rank {rank}: the train CLI failed")
    digests = {f"{name}.{k}": hashlib.sha256(v.detach().contiguous().numpy().tobytes()).hexdigest()
               for name, net in nets.items() for k, v in net.state_dict().items()}
    with open(os.path.join(out_dir, f"nets{rank}.json"), "w") as f:
        json.dump(digests, f)


def main() -> None:
    torch.set_num_threads(2)
    mode, out_dir = sys.argv[1], sys.argv[2]
    if mode == "cli":
        run_cli(out_dir, sys.argv[3:])
        return
    distributed.init_distributed("cpu")
    try:
        result = checks(out_dir)
        torch.save(result, os.path.join(out_dir, f"rank{distributed.process_index()}.pt"))
        distributed.barrier()
    finally:
        distributed.leave()


if __name__ == "__main__":
    main()


# Width sharding (``--spatial-shards``): ranks started by
# ``distributed.run_processes(..., spatial_shards=S)`` for
# ``tests/test_torch_spatial.py``, each reading the test's ``inputs.pt``.

def _columns(a, axis):
    """This rank's column slice of ``a`` along ``axis``."""
    index = [slice(None)] * a.ndim
    index[axis] = distributed.local_columns(a.shape[axis])
    return a[tuple(index)]


def _spatial_ops(inputs) -> dict:
    """The collectives and the halo-aware ops on this rank's columns, in
    float64: outputs and input gradients for the test's cotangents."""
    import torch.nn as nn

    from sc_sfmlearner_release_tpu_torch.parallel import spatial

    out = {}
    for name, case in inputs["ops"].items():
        x = _columns(case["x"], -1).clone().requires_grad_()
        if name.startswith("conv"):
            k, s, p = case["conv"]
            conv = nn.Conv2d(x.shape[1], case["weight"].shape[0], k, s, p).double()
            with torch.no_grad():
                conv.weight.copy_(case["weight"])
                conv.bias.copy_(case["bias"])
            y = spatial.conv2d(x, conv)
        elif name == "max_pool":
            y = spatial.max_pool2d(x, nn.MaxPool2d(3, 2, 1))
        elif name.startswith("reflect"):
            y = spatial.reflect_pad1(x)
        elif name == "halo":
            y = distributed.halo(x, 3, 2)
        elif name == "gather":
            y = distributed.gather_width(x, -1)
        else:  # spatial_sum
            y = distributed.spatial_sum(x.sum(-1))
        ct = case["cotangents"][distributed.spatial_index()]
        (y * ct).sum().backward()
        out[name] = {"y": y.detach(), "grad": x.grad}
    return out


def spatial_step(device, path: str) -> dict:
    """The fp32 step with the device augmentation on this rank's data
    group's rows, from seeded nets, and both networks' buffers after it."""
    inputs = torch.load(path, weights_only=False)
    batch = {k: torch.from_numpy(v[distributed.local_rows(v.shape[0])])
             for k, v in inputs["aug_batch"].items()}
    nets = seeded_nets(inputs["aug_seed"])
    result = step_run(nets, batch, augment_fn=make_device_augment(AugmentConfig()),
                      aug_seed=5)
    result["buffers"] = {f"{i}.{k}": v.clone() for i, net in enumerate(nets)
                         for k, v in net.named_buffers()}
    return result


def spatial_checks(device, path: str) -> dict:
    """Every width-sharding check's result on this rank (2 ranks, S = 2)."""
    inputs = torch.load(path, weights_only=False)
    result = {"ops": _spatial_ops(inputs), "aug_step": spatial_step(device, path)}

    # The step from the JAX-initialised nets on the whole batch: it cuts
    # this rank's columns itself.
    result["jax_step"] = step_run(nets_from(inputs["weights"]), inputs["jax_batch"])

    # The loader (the data group's rows at full width), and this rank's
    # columns of the augmented batch.
    from sc_sfmlearner_release_tpu_torch.data.device_augment import step_generator

    loader = BatchLoader(ImageSet(), 2, shuffle=True, num_workers=2,
                         drop_last=False, seed=3, process_index=distributed.data_index(),
                         process_count=distributed.data_count())
    result["loader"] = list(loader)
    aug = {k: torch.from_numpy(v) for k, v in inputs["aug_batch"].items()}
    result["augmented"] = distributed.local_frames(
        make_device_augment(AugmentConfig())(step_generator(5, 0), aug))

    # The eval steps on a padded batch (n_valid counts the global batch).
    disp, pose = nets_from(inputs["weights"])
    ev = inputs["eval_batch"]
    snippet = {"tgt": ev["tgt"], "refs": ev["refs"], "intrinsics": ev["intrinsics"],
               "n_valid": inputs["n_valid"]}
    result["eval"] = {k: float(v) for k, v in make_eval_step(
        disp, pose, LossConfig(), device="cpu", precision="fp32")(snippet).items()}
    result["eval_depth"] = {k: float(v) for k, v in make_eval_depth_step(
        disp, device="cpu", precision="fp32")(
        {"img": ev["tgt"], "depth": ev["depth"], "n_valid": inputs["n_valid"]}).items()}
    return result


class ImageSet:
    """Frames, intrinsics and ground truth whose values tell their sample,
    row and column apart."""

    def __init__(self, n: int = 5, h: int = 4, w: int = 8):
        self.n, self.h, self.w = n, h, w

    def __len__(self) -> int:
        return self.n

    def load(self, i, rng):
        frame = (np.arange(self.h * self.w * 3, dtype=np.float32).reshape(self.h, self.w, 3)
                 + 1000 * i + rng.random((self.h, self.w, 3), np.float32))
        return {"tgt": frame, "refs": np.stack([frame + 0.25, frame - 0.25]),
                "intrinsics": np.eye(3, dtype=np.float32) * i,
                "depth": frame[..., 0] * 2, "index": np.asarray(i, np.int64)}
