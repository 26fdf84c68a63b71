"""Training, validation and inference steps.

The counterpart of the JAX package's ``training/step.py``: depth for all
snippet frames in one batched DispNet call, all 2N directed poses in one
batched PoseNet call (frame-major folding, so BatchNorm sees the same
batches as in JAX), then the 3-term loss; the train step adds the backward
pass (through the warp and SSIM backward kernels on the card) and the Adam
update.

Batch layout (numpy arrays or tensors):
  batch = {
    "tgt":        [B, H, W, 3]     target frames
    "refs":       [B, N, H, W, 3]  reference frames
    "intrinsics": [B, 3, 3]
    "n_valid":    optional int, samples past it are loader padding
  }

Precision: ``"bf16"`` (the default, as the JAX trainer's ``--precision``)
runs the convolutions under bf16 autocast; BatchNorm, the heads, geometry
and losses stay fp32. ``"fp32"`` runs everything in fp32. The entry points
turn TF32 off for matmuls and cuDNN.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import disable_tf32, resolve_device
from ..data.device_augment import step_generator
from ..ops import KERNEL_WRAPPERS
from ..ops.losses import photo_and_geometry_loss, resize_nearest, smooth_loss
from ..ops.metrics import compute_depth_errors
from .state import optimizer_step

PRECISIONS = ("bf16", "fp32")
METRIC_KEYS = ("loss", "photo_loss", "smooth_loss", "geometry_loss")
SNIPPET_KEYS = ("tgt", "refs", "intrinsics")
Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Static loss configuration (the reference's loss flags)."""

    photo_weight: float = 1.0
    smooth_weight: float = 0.1
    geometry_weight: float = 0.5
    num_scales: int = 1
    with_ssim: bool = True
    with_mask: bool = True
    with_auto_mask: bool = False
    padding_mode: str = "zeros"


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}: expected one of {PRECISIONS}")


def conv_autocast(device: torch.device, precision: str):
    """bf16 autocast for the convolutions, or nothing for ``"fp32"``."""
    _check_precision(precision)
    if precision == "fp32":
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=torch.bfloat16)


def _frames_to_batch(tgt: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 3]`` + ``[B, N, H, W, 3]`` -> frame-major ``[(1+N)*B, H, W, 3]``."""
    all_f = torch.cat([tgt[:, None], refs], dim=1)
    return all_f.transpose(0, 1).reshape((-1,) + tgt.shape[1:])


def _split_frames(x: torch.Tensor, b: int, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`_frames_to_batch` for per-frame outputs."""
    return x[:b], x[b:].reshape((n, b) + x.shape[1:]).transpose(0, 1)


def compute_depth(
    disp_net, tgt: torch.Tensor, refs: torch.Tensor
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """All-frames depth in one batched DispNet call: per-scale lists
    ``tgt_depth[s]`` ``[B, h, w, 1]`` and ``ref_depths[s]`` ``[B, N, h, w, 1]``."""
    b, n = tgt.shape[0], refs.shape[1]
    tgt_depth, ref_depths = [], []
    for disp in disp_net(_frames_to_batch(tgt, refs)):
        t, r = _split_frames(1.0 / disp, b, n)
        tgt_depth.append(t)
        ref_depths.append(r)
    return tgt_depth, ref_depths


def compute_pose_with_inv(
    pose_net, tgt: torch.Tensor, refs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All 2N directed poses in one batched PoseNet call: (poses ``[B, N, 6]``
    target -> ref, poses_inv ``[B, N, 6]`` ref -> target)."""
    b, n = tgt.shape[0], refs.shape[1]
    flat = lambda a: a.transpose(0, 1).reshape((-1,) + a.shape[2:])
    tgt_rep = flat(tgt[:, None].expand(refs.shape))
    ref_f = flat(refs)
    out = pose_net(torch.cat([tgt_rep, ref_f]), torch.cat([ref_f, tgt_rep]))
    poses = out[: n * b].reshape(n, b, 6).transpose(0, 1)
    poses_inv = out[n * b:].reshape(n, b, 6).transpose(0, 1)
    return poses, poses_inv


def _loss_terms(tgt, refs, intrinsics, tgt_depth, ref_depths, poses, poses_inv,
                cfg: LossConfig, sample_mask):
    photo, geom = photo_and_geometry_loss(
        tgt, refs, intrinsics, tgt_depth, ref_depths, poses, poses_inv,
        num_scales=cfg.num_scales, with_ssim=cfg.with_ssim,
        with_mask=cfg.with_mask, with_auto_mask=cfg.with_auto_mask,
        padding_mode=cfg.padding_mode, sample_mask=sample_mask,
    )
    return photo, geom, smooth_loss(tgt_depth, tgt, ref_depths, refs, sample_mask)


def _call(fn, *args):
    return fn(*args)


def _remat(fn, *args):
    # The step draws no random numbers on the device, so there is no RNG
    # state to restore for the recomputation (saving it is refused while a
    # CUDA graph is being captured).
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def total_loss(
    disp_net, pose_net, batch: Batch, cfg: LossConfig,
    sample_mask: Optional[torch.Tensor] = None, precision: str = "bf16",
    train: bool = False, remat: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted 3-term loss of a batch: (total, metrics). Puts both
    networks in train mode (BatchNorm on batch statistics, running
    statistics updated) if ``train``, else in eval mode. ``remat`` keeps
    only the inputs of depth, pose and the loss terms for the backward,
    which recomputes the rest (``torch.utils.checkpoint``), as the JAX
    step's ``jax.checkpoint``s. The recomputation runs the networks'
    forwards again, and with them BatchNorm's running statistics: the train
    step undoes that second move."""
    disp_net.train(train)
    pose_net.train(train)
    tgt, refs, intrinsics = batch["tgt"], batch["refs"], batch["intrinsics"]
    run = _remat if remat else _call
    with conv_autocast(tgt.device, precision):
        tgt_depth, ref_depths = run(compute_depth, disp_net, tgt, refs)
        poses, poses_inv = run(compute_pose_with_inv, pose_net, tgt, refs)
    photo, geom, smooth = run(_loss_terms, tgt, refs, intrinsics, tgt_depth, ref_depths,
                              poses, poses_inv, cfg, sample_mask)
    total = cfg.photo_weight * photo + cfg.smooth_weight * smooth + cfg.geometry_weight * geom
    metrics = {"loss": total, "photo_loss": photo, "smooth_loss": smooth, "geometry_loss": geom}
    return total, metrics


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return torch.as_tensor(x, device=device)


def _snippet(batch, device: torch.device) -> Batch:
    return {k: _to_device(batch[k], device).float() for k in SNIPPET_KEYS}


def make_train_step(
    disp_net, pose_net, optimizer: torch.optim.Optimizer, cfg: LossConfig = LossConfig(),
    device=None, precision: str = "bf16", remat: bool = False,
    augment_fn: Optional[Callable[[torch.Generator, Batch], Batch]] = None,
    aug_seed: int = 0, fused_steps: int = 1,
) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """One optimizer step per call, in the JAX step's order: the forward in
    train mode (BatchNorm on batch statistics), the 3-term loss, the
    backward (on the card through the warp and SSIM backward kernels), the
    update of ``optimizer`` (:func:`~.state.make_optimizer`'s Adam over both
    networks). BatchNorm moves its running statistics during the forward;
    nothing in the step reads them, so the result is the JAX step's, which
    returns them after the update.

    ``remat`` recomputes the activations of depth, pose and the loss in the
    backward (:func:`total_loss`); the running statistics still move once
    per step. ``augment_fn`` (``data.device_augment.make_device_augment``)
    takes the raw batch in its own dtype (uint8 from a packed loader) on
    the device, with the CPU generator of (``aug_seed``, step), the step
    being the optimizer's count before the update: it is read from the
    optimizer at the first call, and again whenever the optimizer's state
    has been replaced (``load_state_dict``, as a restore does), and counted
    on the host in between, so no step waits for the card.

    ``fused_steps=K > 1`` returns a step that takes K batches stacked on a
    new leading axis (``tgt [K, B, H, W, 3]``, ``refs [K, B, N, H, W, 3]``,
    ``intrinsics [K, B, 3, 3]``) and runs K optimizer steps per call, the
    same steps as K calls of the unfused step (step ``s + k`` draws its
    augmentation from the generator of (``aug_seed``, ``s + k``)); its
    metrics have a leading ``[K]`` axis. On the CPU it runs them eagerly.
    On CUDA the K steps are one CUDA graph (:class:`_GraphedSteps`), which
    needs ``make_optimizer(..., capturable=True)`` and, with
    ``augment_fn``, a :class:`~..data.device_augment.DeviceAugment`.

    Moves both networks to ``device``. Returns ``train_step(batch) ->
    metrics`` (detached 0-d tensors: ``loss``, ``photo_loss``,
    ``smooth_loss``, ``geometry_loss``).
    """
    if fused_steps < 1:
        raise ValueError(f"fused_steps must be >= 1, got {fused_steps}")
    device = resolve_device(device)
    _check_precision(precision)
    fused_on_card = fused_steps > 1 and device.type == "cuda"
    if fused_on_card:
        if not all(g.get("capturable") for g in optimizer.param_groups):
            raise ValueError("fused_steps > 1 on CUDA captures the optimizer's update in a "
                             "CUDA graph: build it with make_optimizer(..., capturable=True)")
        if augment_fn is not None and not hasattr(augment_fn, "host_map"):
            raise TypeError("fused_steps > 1 on CUDA needs an augment_fn with host_map and "
                            "apply_map (data.device_augment.make_device_augment)")
    disable_tf32()
    disp_net.to(device)
    pose_net.to(device)

    def update(snippet: Batch) -> Dict[str, torch.Tensor]:
        """One optimizer step on a snippet on the device."""
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = total_loss(disp_net, pose_net, snippet, cfg, precision=precision,
                                   train=True, remat=remat)
        if remat:
            bn_buffers = [b for net in (disp_net, pose_net) for b in net.buffers()]
            moved_once = [b.clone() for b in bn_buffers]
        loss.backward()
        if remat:
            with torch.no_grad():
                for b, saved in zip(bn_buffers, moved_once):
                    b.copy_(saved)
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    if fused_on_card:
        return _GraphedSteps(fused_steps, device, optimizer, update, augment_fn, aug_seed)

    step, counted_state = None, None

    def train_step(batch) -> Dict[str, torch.Tensor]:
        nonlocal step, counted_state
        # Optimizer.load_state_dict installs a new ``state`` mapping.
        if optimizer.state is not counted_state:
            step, counted_state = optimizer_step(optimizer), optimizer.state
        if augment_fn is None:
            snippet = _snippet(batch, device)
        else:
            raw = {k: _to_device(batch[k], device) for k in SNIPPET_KEYS}
            snippet = augment_fn(step_generator(aug_seed, step), raw)
        metrics = update(snippet)
        step += 1
        return metrics

    if fused_steps == 1:
        return train_step

    def fused_step(batches) -> Dict[str, torch.Tensor]:
        _check_stacked(batches, fused_steps)
        per_step = [train_step({k: batches[k][i] for k in SNIPPET_KEYS})
                    for i in range(fused_steps)]
        return {k: torch.stack([m[k] for m in per_step]) for k in METRIC_KEYS}

    return fused_step


def _check_stacked(batches, k: int) -> None:
    for key in SNIPPET_KEYS:
        if batches[key].shape[0] != k:
            raise ValueError(f"fused_steps={k}: {key} has shape {tuple(batches[key].shape)}, "
                             f"expected {k} batches stacked on a leading axis")


class _GraphedSteps:
    """K train steps per call on CUDA, as one CUDA-graph replay.

    The first call runs its K steps eagerly on a side stream (they are real
    steps, with their own batches and draws): that initializes Adam's state,
    cuDNN's plans and the allocator's pools outside any capture. The second
    call captures the K steps into one graph, then replays it; later calls
    only replay. The graph reads static device inputs (the stacked batch
    and, with ``augment_fn``, the K steps' affine maps) and writes a static
    ``[K, 4]`` metrics buffer; each call copies its batch into the inputs
    on the current stream, replays, and returns a clone of the metrics.

    The maps are made on the host (``augment_fn.host_map``: the draws and
    positions stay on the CPU, which keeps them bit-equal across devices),
    written into one of two pinned buffers and copied to the device on the
    current stream just before the replay; the graph applies them
    (``augment_fn.apply_map``). Before a call writes a pinned buffer it
    waits for the replay that last read it, two calls back: that also keeps
    the host at most two calls ahead of the card.

    A capture counts each kernel wrapper's launches once although it
    launches nothing: the counts are put back after the capture, and each
    replay adds the capture's increase. When the optimizer's state has
    been replaced (``load_state_dict`` installs new moment tensors, which
    the old graph would not update), the step count is read again, the
    graph is dropped, and the next two calls warm up and capture anew. A
    failed capture or replay raises; nothing falls back to the eager step.
    """

    def __init__(self, k: int, device: torch.device, optimizer: torch.optim.Optimizer,
                 update: Callable[[Batch], Dict[str, torch.Tensor]], augment_fn, aug_seed: int):
        self.k, self.device, self.optimizer = k, device, optimizer
        self.update, self.augment_fn, self.aug_seed = update, augment_fn, aug_seed
        self.step = self.counted_state = None
        self.graph, self.warm = None, False
        self.inputs = self.maps = self.metrics = None
        self.pinned, self.done, self.turn = [], [None, None], 0
        self.launches = None

    def __call__(self, batches) -> Dict[str, torch.Tensor]:
        if self.optimizer.state is not self.counted_state:
            self.step, self.counted_state = optimizer_step(self.optimizer), self.optimizer.state
            self.graph, self.warm = None, False
        _check_stacked(batches, self.k)
        if self.done[self.turn] is not None:
            self.done[self.turn].synchronize()
        self._stage(batches)
        stream = torch.cuda.current_stream(self.device)
        if not self.warm:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                self._steps()
            stream.wait_stream(side)
            self.warm = True
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            for fn, n in zip(KERNEL_WRAPPERS, self.launches):
                fn.launches += n
        done = torch.cuda.Event()
        done.record(stream)
        self.done[self.turn] = done
        self.turn ^= 1
        self.step += self.k
        metrics = self.metrics.clone()
        return {key: metrics[:, i] for i, key in enumerate(METRIC_KEYS)}

    def _stage(self, batches) -> None:
        """The batch into the static inputs and, with ``augment_fn``, the K
        steps' maps into the static map buffer, on the current stream."""
        raw = {k: _to_device(batches[k], self.device) for k in SNIPPET_KEYS}
        if self.inputs is None:
            self.inputs = {k: torch.empty_like(v) for k, v in raw.items()}
            self.metrics = torch.zeros((self.k, len(METRIC_KEYS)), device=self.device)
            if self.augment_fn is not None:
                _, b, h, w, _ = raw["tgt"].shape
                self.maps = torch.empty((self.k, b, w + h + 5), device=self.device)
                self.pinned = [torch.empty(self.maps.shape, pin_memory=True) for _ in range(2)]
        for k, v in raw.items():
            if v.shape != self.inputs[k].shape:
                raise ValueError(f"{k}: shape {tuple(v.shape)}, but the graph was made for "
                                 f"{tuple(self.inputs[k].shape)}")
            self.inputs[k].copy_(v)
        if self.augment_fn is not None:
            pinned = self.pinned[self.turn]
            _, b, h, w, _ = raw["tgt"].shape
            for i in range(self.k):
                pinned[i] = self.augment_fn.host_map(
                    step_generator(self.aug_seed, self.step + i), b, h, w)
            self.maps.copy_(pinned, non_blocking=True)

    def _steps(self) -> None:
        """The K steps on the static buffers: what the graph captures."""
        for i in range(self.k):
            raw = {k: v[i] for k, v in self.inputs.items()}
            if self.augment_fn is None:
                snippet = {k: v.float() for k, v in raw.items()}
            else:
                snippet = self.augment_fn.apply_map(raw, self.maps[i])
            metrics = self.update(snippet)
            self.metrics[i].copy_(torch.stack([metrics[k] for k in METRIC_KEYS]))

    def _capture(self) -> None:
        before = [fn.launches for fn in KERNEL_WRAPPERS]
        graph = torch.cuda.CUDAGraph()
        # Thread-local: the loader's threads pin host memory meanwhile.
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._steps()
        self.launches = [fn.launches - n for fn, n in zip(KERNEL_WRAPPERS, before)]
        for fn, n in zip(KERNEL_WRAPPERS, before):
            fn.launches = n
        self.graph = graph


def make_eval_step(
    disp_net, pose_net, cfg: LossConfig = LossConfig(), device=None,
    precision: str = "bf16",
) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Photometric validation without ground truth: the same losses with
    both networks in eval mode, auto-mask off and scale 0 only. If the batch
    carries ``"n_valid"``, the padded samples past it are masked out of
    every mean. Moves both networks to ``device``; each call puts them in
    eval mode. Returns ``eval_step(batch) -> metrics`` (0-d tensors)."""
    device = resolve_device(device)
    _check_precision(precision)
    disable_tf32()
    disp_net.to(device)
    pose_net.to(device)
    eval_cfg = dataclasses.replace(cfg, with_auto_mask=False, num_scales=1)

    def eval_step(batch) -> Dict[str, torch.Tensor]:
        b = _snippet(batch, device)
        sample_mask = None
        if "n_valid" in batch:
            sample_mask = (
                torch.arange(b["tgt"].shape[0], device=device) < int(batch["n_valid"])
            ).float()
        with torch.no_grad():
            _, metrics = total_loss(disp_net, pose_net, b, eval_cfg, sample_mask, precision)
        return metrics

    return eval_step


def make_inference_fn(
    disp_net, device=None, precision: str = "bf16"
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Single-image depth inference: ``infer(img [B, H, W, 3])`` returns
    (disp, depth), both ``[B, H, W, 1]`` at scale 0, with DispNet in eval
    mode."""
    device = resolve_device(device)
    _check_precision(precision)
    disable_tf32()
    disp_net.to(device)

    def infer(img) -> Tuple[torch.Tensor, torch.Tensor]:
        x = _to_device(img, device).float()
        disp_net.eval()
        with torch.no_grad(), conv_autocast(device, precision):
            disp = disp_net(x)[0]
        return disp, 1.0 / disp

    return infer


def make_eval_depth_step(
    disp_net, dataset: str = "kitti", device=None, precision: str = "bf16"
) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Validation against ground-truth depth: scale-0 disparity -> depth,
    resized (nearest, as the reference's ``F.interpolate`` default) to the
    ground truth's size if it differs, then the masked, median-scaled error
    metrics (:func:`~..ops.metrics.compute_depth_errors`). ``batch`` holds
    ``"img"`` ``[B, H, W, 3]``, ``"depth"`` ``[B, Hg, Wg]`` and optionally
    ``"n_valid"``: only the first ``n_valid`` images enter the means.
    Returns ``eval_depth_step(batch) -> metrics`` (0-d tensors)."""
    infer = make_inference_fn(disp_net, device, precision)
    device = resolve_device(device)

    def eval_depth_step(batch) -> Dict[str, torch.Tensor]:
        _, depth = infer(batch["img"])
        gt = _to_device(batch["depth"], device).float()
        if gt.shape[1:] != depth.shape[1:3]:
            depth = resize_nearest(depth, gt.shape[1], gt.shape[2])
        return compute_depth_errors(gt, depth[..., 0], dataset, n_valid=batch.get("n_valid"))

    return eval_depth_step
