"""The reference's run of a training cell's first steps.

It rebuilds what the program's first steps trained on from the seed alone:
the dataset's snippets (``dataset.samples``), the loader's order (the
port's documented rule: epoch ``e`` shuffles the snippet indices with
``numpy.random.default_rng(seed + e)``, and batch ``s`` takes the next
``B`` of them; every sample's host draws come from
``SeedSequence([seed + e, index])``), the frames decoded by PIL from the
pool's JPEGs, the host transforms (flip, scale-crop through PIL's resize,
normalize) or the device augmentation (one draw per sample from the CPU
generator of ``SeedSequence([seed, step])``, resolved into a separable
affine map and resampled bilinearly), and then trains ``steps`` steps of
the configuration's family's reference (``families/<family>/reference.py``'s
``Step``: its networks seeded from the seed, Adam, a batch's loss). It
returns each step's loss, every leaf's gradient norm at the first step, and
every leaf's change after the last.

``follow_from`` checks the program's first CUDA-graph replay: it starts
from the program's own state before that dispatch (parameters, Adam's
moments and step counts; the steps before it are held to ``follow``'s
from the seed) and trains the dispatch's steps on their rebuilt batches.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import dataset, spec

MEAN, STD = 0.45, 0.225


class Frames:
    """Pool frames decoded by PIL (libjpeg), uint8 ``[H, W, 3]``, once each."""

    def __init__(self, files: List[str]):
        self.files, self.cache = files, {}

    def __getitem__(self, i: int) -> np.ndarray:
        if i not in self.cache:
            from PIL import Image

            with Image.open(self.files[i]) as im:
                self.cache[i] = np.asarray(im.convert("RGB"))
        return self.cache[i]


def host_transform(images: List[np.ndarray], k: np.ndarray, rng: np.random.Generator,
                   max_scale: float = 1.15):
    """Flip, scale-crop and normalize one snippet as the published scripts'
    host transforms draw and apply them (float32 [0, 255] frames in)."""
    from PIL import Image

    k = k.copy()
    h, w = images[0].shape[:2]
    if rng.random() < 0.5:
        images = [np.ascontiguousarray(im[:, ::-1]) for im in images]
        k[0, 2] = w - k[0, 2]
    sx, sy = rng.uniform(1.0, max_scale, 2)
    sh, sw = int(h * sy), int(w * sx)
    k[0] *= sx
    k[1] *= sy
    scaled = [np.asarray(Image.fromarray(im.astype(np.uint8)).resize((sw, sh)))
              .astype(np.float32) for im in images]
    oy, ox = int(rng.integers(sh - h + 1)), int(rng.integers(sw - w + 1))
    images = [im[oy:oy + h, ox:ox + w] for im in scaled]
    k[0, 2] -= ox
    k[1, 2] -= oy
    mean, std = np.float32(MEAN), np.float32(STD)
    return [(np.asarray(im, np.float32) / 255.0 - mean) / std for im in images], k


def step_draws(seed: int, step: int, batch: int, max_scale: float = 1.15):
    """The device augmentation's draws of one step for ``batch`` samples."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    g = torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))
    flip = torch.rand(batch, generator=g) < 0.5
    scales = 1.0 + torch.rand(batch, 2, generator=g) * (max_scale - 1.0)
    offsets = torch.rand(batch, 2, generator=g)
    return flip, scales, offsets


def _resample(frames: torch.Tensor, pos: torch.Tensor, dim: int) -> torch.Tensor:
    size = frames.shape[dim]
    pos = pos.clamp(0.0, size - 1.0)
    p0 = torch.floor(pos)
    frac = pos - p0
    i0 = p0.long()
    i1 = (i0 + 1).clamp(max=size - 1)
    view = [1] * frames.dim()
    view[0], view[dim] = pos.shape
    shape = list(frames.shape)
    shape[dim] = pos.shape[1]
    a = frames.gather(dim, i0.view(view).expand(shape))
    b = frames.gather(dim, i1.view(view).expand(shape))
    return (1.0 - frac).view(view) * a + frac.view(view) * b


def device_augment(frames: torch.Tensor, k: torch.Tensor, draws):
    """Zoom by ``floor(size * s) / size``, crop at the integer offset, flip,
    bilinear with clamped taps, then normalize: ``frames`` ``[B, 1+N, H, W,
    3]`` in [0, 1] on the device, ``k`` ``[B, 3, 3]`` there."""
    flip, scales, offsets = draws
    _, _, h, w, _ = frames.shape
    sw, sh = torch.floor(w * scales[:, 0]), torch.floor(h * scales[:, 1])
    sx, sy = sw / w, sh / h
    ox = torch.floor(offsets[:, 0] * (sw - w + 1.0))
    oy = torch.floor(offsets[:, 1] * (sh - h + 1.0))
    in_x = (torch.arange(w, dtype=torch.float32)[None] + ox[:, None] + 0.5) / sx[:, None] - 0.5
    in_y = (torch.arange(h, dtype=torch.float32)[None] + oy[:, None] + 0.5) / sy[:, None] - 0.5
    in_x = torch.where(flip[:, None], (w - 1.0) - in_x, in_x)
    dev = frames.device
    out = _resample(_resample(frames, in_y.to(dev), 2), in_x.to(dev), 3)
    mean = torch.full((3,), MEAN, dtype=torch.float32, device=dev)
    std = torch.full((3,), STD, dtype=torch.float32, device=dev)
    out = (out - mean) / std
    sx, sy, ox, oy, flip = (t.to(dev) for t in (sx, sy, ox, oy, flip))
    cx = torch.where(flip, w - k[:, 0, 2], k[:, 0, 2])
    k2 = k.clone()
    k2[:, 0, 0] = k[:, 0, 0] * sx
    k2[:, 0, 2] = cx * sx - ox
    k2[:, 1, 1] = k[:, 1, 1] * sy
    k2[:, 1, 2] = k[:, 1, 2] * sy - oy
    k2[:, 0, 1] = 0.0
    k2[:, 1, 0] = 0.0
    return out, k2


class Batches:
    """The batches of the program's first steps, as the reference rebuilds
    them: ``batch(step)`` -> (tgt ``[B, 3, H, W]``, refs ``[B, N, 3, H,
    W]``, k ``[B, 3, 3]``) on ``device``, normalized, for the global batch.
    An epoch trains on its first whole groups of ``fused_steps`` batches
    (the train CLI drops a trailing partial group)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, files: List[str]):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        scenes = dataset.layout(seed, traffic["scenes"], traffic["frames_per_scene"], len(files))
        self.samples = dataset.samples(scenes, cfg["sequence_length"])
        self.batch = cfg["batch_size"] * traffic.get("world_size", 1)
        k = cfg["fused_steps"]
        self.per_epoch = len(self.samples) // self.batch // k * k
        if not self.per_epoch:
            raise ValueError("the dataset holds no whole group of batches")
        self.frames = Frames(files)

    def indices(self, step: int):
        """(epoch, the snippet indices of the step's global batch)."""
        epoch, b = divmod(step, self.per_epoch)
        order = np.arange(len(self.samples))
        np.random.default_rng(self.seed + epoch).shuffle(order)
        return epoch, order[b * self.batch:(b + 1) * self.batch]

    def __call__(self, step: int):
        epoch, idx = self.indices(step)
        snippets = [self.samples[i] for i in idx]
        if self.traffic["device_augment"]:
            raw = np.stack([np.stack([self.frames[t]] + [self.frames[r] for r in refs])
                            for t, refs, _ in snippets])
            frames = torch.from_numpy(raw).to(self.device).float() / 255.0
            k = torch.from_numpy(np.stack([s[2] for s in snippets])).to(self.device)
            frames, k = device_augment(frames, k, step_draws(self.seed, step, self.batch))
        else:
            out, ks = [], []
            for i, (t, refs, k) in zip(idx, snippets):
                rng = np.random.default_rng(np.random.SeedSequence([self.seed + epoch, int(i)]))
                images = [self.frames[j].astype(np.float32) for j in [t] + refs]
                images, k = host_transform(images, k, rng)
                out.append(np.stack(images))
                ks.append(k)
            frames = torch.from_numpy(np.stack(out)).to(self.device)
            k = torch.from_numpy(np.stack(ks)).to(self.device)
        frames = frames.permute(0, 1, 4, 2, 3).contiguous()  # [B, 1+N, 3, H, W]
        return frames[:, 0], frames[:, 1:], k


def _train(cfg: dict, side, batches, steps, drop_half: bool, no_exchange: bool,
           on_first=None) -> List[float]:
    """Train the reference ``side`` on ``batches(s)`` for each ``s`` of
    ``steps``; each step's loss. ``on_first`` sees the first step's
    gradients before the optimizer's update."""
    params = [p for _, p in side.named]
    losses = []
    for i, s in enumerate(steps):
        batch = batches(s)
        if drop_half:
            batch = tuple(x[:x.shape[0] // 2] for x in batch)
        share = None
        if no_exchange:
            share = torch.zeros(batch[0].shape[0], device=batch[0].device)
            share[:cfg["batch_size"]] = 1.0
        for p in params:
            p.grad = None
        total = side.loss(batch, share)
        total.backward()
        losses.append(float(total.detach()))
        if i == 0 and on_first is not None:
            on_first()
        side.optimizer.step()
    return losses


def _changes(named, start) -> Dict[str, float]:
    return {n: float((p.detach() - p0).norm()) for (n, p), p0 in zip(named, start)}


def follow(cfg: dict, traffic: dict, seed: int, steps: int = 3, device="cuda",
           precision: str = "fp32", drop_half: bool = False,
           no_exchange: bool = False) -> Dict:
    """``steps`` reference train steps from the seed: ``{"losses": [...],
    "grad1": {leaf: norm}, "update": {leaf: norm}}`` (leaves named as the
    family's reference names them, as its program does). Planted faults:
    ``drop_half`` trains on the first half of each batch only;
    ``no_exchange`` trains and reports rank 0's share of the global loss
    alone, as a rank whose gradients and metrics are never summed over the
    ranks would."""
    batches = Batches(cfg, traffic, seed, device, dataset.pool_files(traffic))
    side = spec.family(cfg["family"], "reference").Step(cfg, device, precision, seed)
    start = [p.detach().clone() for _, p in side.named]
    grad1 = {}

    def read_grads():
        grad1.update({n: float(p.grad.norm()) if p.grad is not None else 0.0
                      for n, p in side.named})

    losses = _train(cfg, side, batches, range(steps), drop_half, no_exchange, read_grads)
    return {"losses": losses, "grad1": grad1, "update": _changes(side.named, start)}


def follow_from(cfg: dict, traffic: dict, seed: int, replay: Dict, device="cuda",
                precision: str = "fp32", drop_half: bool = False, no_exchange: bool = False,
                stale: bool = False) -> Dict:
    """The program's second dispatch (its first CUDA-graph replay) followed
    from the program's own state before it: ``replay`` holds, per leaf, the
    parameter, Adam's moments and step count after ``replay["first"]``
    steps (``cell.Program.first_steps``). Trains as many steps as the
    dispatch did, on the batches rebuilt from the seed: ``{"losses": [...],
    "update": {leaf: norm of its change}}``. ``stale`` plants the fault of
    a replay whose static inputs were never refilled: it trains on the
    previous dispatch's batches again. ``drop_half`` and ``no_exchange`` as
    in ``follow``."""
    batches = Batches(cfg, traffic, seed, device, dataset.pool_files(traffic))
    side = spec.family(cfg["family"], "reference").Step(cfg, device, precision)
    named, state = side.named, replay["state"]
    with torch.no_grad():
        for n, p in named:
            p.copy_(state[n]["param"].to(device))
    side.optimizer.load([state[n]["exp_avg"] for n, _ in named],
                        [state[n]["exp_avg_sq"] for n, _ in named],
                        [state[n]["step"] for n, _ in named])
    start = [p.detach().clone() for _, p in named]
    first, k = replay["first"], len(replay["losses"])
    steps = range(first - k, first) if stale else range(first, first + k)
    losses = _train(cfg, side, batches, steps, drop_half, no_exchange)
    return {"losses": losses, "update": _changes(named, start)}
