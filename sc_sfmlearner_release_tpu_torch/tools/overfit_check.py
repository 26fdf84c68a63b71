"""End-to-end learning check on synthetic geometry.

The counterpart of the repository's ``tools/overfit_check.py``: a textured
scene (a frontal wall above a slanted ground plane, 128x256) whose two
reference frames are rendered from the target frame with known depth and
pose (+-0.3 m in x) by the port's own ``inverse_warp2`` (border padding).
The whole pipeline trains on it (B=4, ResNet-18 DispNet and PoseNet, SSIM
and the mask on, auto-mask off, border padding, bf16 convolutions, Adam),
and the check passes when the photometric loss ends under half its first
value and the predicted depth correlates with the true depth (> 0.3).
That holds the whole gradient path (networks, warp and SSIM kernels and
their backward kernels, losses, Adam) as a learning system, not only as
code that computes what JAX computes. The exit code follows the verdict.

The texture is the JAX tool's: uniform noise at a quarter of the size,
enlarged by ``cv2.resize(..., INTER_CUBIC)``, here OpenCV's float32
bicubic in numpy (:func:`resize_cubic`), since the card's machine has no
``cv2``.

    python -m sc_sfmlearner_release_tpu_torch.tools.overfit_check [--steps 300] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import cli_device
from ..inference import add_device_flags
from ..models import DispNet, PoseNet
from ..ops.geometry import inverse_warp2
from ..training import LossConfig, create_train_state, make_optimizer, make_train_step

H, W = 128, 256
B = 4
SHIFT = 0.3             # m, the reference cameras' offsets in x
FOCAL = 120.0
LOSS_RATIO_MAX = 0.5    # final photometric loss over the first
CORRELATION_MIN = 0.3   # predicted against true depth
CUBIC_A = np.float32(-0.75)


def _cubic_taps(n_out: int, n_in: int):
    """OpenCV's ``resize`` taps for INTER_CUBIC along one axis: source
    indices ``[n_out, 4]`` (clamped to the edge, as ``resize`` does) and
    float32 weights ``[n_out, 4]`` from ``interpolateCubic``."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    x = f - s.astype(np.float32)
    a, one = CUBIC_A, np.float32(1)
    c0 = ((a * (x + one) - 5 * a) * (x + one) + 8 * a) * (x + one) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    c2 = ((a + 2) * (one - x) - (a + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(s[:, None] + np.arange(-1, 3), 0, n_in - 1)
    return idx, np.stack([c0, c1, c2, c3], axis=1).astype(np.float32)


def resize_cubic(src: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(src, (width, height), interpolation=cv2.INTER_CUBIC)``
    for float32 ``[h, w]`` or ``[h, w, C]``: OpenCV's taps and float32
    weights, rows first (each output the left-to-right float32 sum of its 4
    products, as OpenCV's row pass sums them), then columns. OpenCV's
    vectorized column pass rounds in an order this does not reproduce: on
    the JAX tool's texture (32x64 to 128x256) the result is within 2.4e-7
    (2 ulps) of ``cv2.resize``'s."""
    src = np.asarray(src, np.float32)
    xi, xw = _cubic_taps(width, src.shape[1])
    yi, yw = _cubic_taps(height, src.shape[0])
    shape = (-1,) + (1,) * (src.ndim - 2)
    rows = src[:, xi[:, 0]] * xw[:, 0].reshape(shape)
    for k in range(1, 4):
        rows = rows + src[:, xi[:, k]] * xw[:, k].reshape(shape)
    shape = (-1, 1) + (1,) * (src.ndim - 2)
    out = rows[yi[:, 0]] * yw[:, 0].reshape(shape)
    for k in range(1, 4):
        out = out + rows[yi[:, k]] * yw[:, k].reshape(shape)
    return out


def make_scene(h: int = H, w: int = W, seed: int = 0):
    """(texture ``[h, w, 3]`` in [0, 1], depth ``[h, w]``): a wall at 10 m on
    the top half, a ground plane sloping from 10 m to 2 m below."""
    rng = np.random.RandomState(seed)
    ys = np.linspace(0, 1, h)[:, None]
    depth = np.where(ys < 0.5, 10.0, 10.0 - 16.0 * (ys - 0.5))
    depth = np.clip(np.broadcast_to(depth, (h, w)).astype(np.float32), 2.0, 10.0)
    tex = rng.rand(h // 4, w // 4, 3).astype(np.float32)
    return np.clip(resize_cubic(tex, h, w), 0, 1), depth


def intrinsics(h: int = H, w: int = W) -> np.ndarray:
    return np.array([[FOCAL, 0, w / 2], [0, FOCAL, h / 2], [0, 0, 1]], np.float32)


def render_refs(img: np.ndarray, depth: np.ndarray, poses, k: np.ndarray,
                device="cpu") -> np.ndarray:
    """Reference views ``[len(poses), H, W, 3]``: the target warped with its
    true depth by each 6-DoF pose (border padding)."""
    b = len(poses)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    imgs = t(np.broadcast_to(img, (b,) + img.shape))
    depths = t(np.broadcast_to(depth[..., None], (b,) + depth.shape + (1,)))
    warped, _, _, _ = inverse_warp2(imgs, depths, depths, t(np.asarray(poses)),
                                    t(np.broadcast_to(k, (b, 3, 3))), padding_mode="border")
    return warped.cpu().numpy()


def make_batch(device="cpu"):
    """The training batch (B copies of the target and its two references)
    on ``device``, and the true depth."""
    img, depth = make_scene()
    k = intrinsics()
    pose_fwd = np.array([SHIFT, 0, 0, 0, 0, 0], np.float32)
    refs = render_refs(img, depth, [pose_fwd, -pose_fwd], k, device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    batch = {"tgt": t(np.broadcast_to(img, (B, H, W, 3))),
             "refs": t(np.broadcast_to(refs[None], (B, 2, H, W, 3))),
             "intrinsics": t(np.broadcast_to(k, (B, 3, 3)))}
    return batch, depth


def run(steps: int, lr: float, device, precision: str = "bf16", seed: int = 0) -> dict:
    """Train ``steps`` steps on the scene: the first and final photometric
    losses, their ratio, the depth correlation, ms per step after the
    first (host clock, ending in a synchronize), and the verdict."""
    device = torch.device(device)
    batch, depth = make_batch(device)
    disp_net = DispNet(18, generator=torch.Generator().manual_seed(seed))
    pose_net = PoseNet(18, generator=torch.Generator().manual_seed(seed + 1))
    state = create_train_state(disp_net, pose_net, make_optimizer(disp_net, pose_net, lr=lr))
    step = make_train_step(disp_net, pose_net, state.optimizer,
                           LossConfig(with_ssim=True, with_mask=True, with_auto_mask=False,
                                      padding_mode="border"),
                           device=device, precision=precision)
    first = t0 = None
    for i in range(steps):
        metrics = step(batch)
        if i == 0:
            first = float(metrics["photo_loss"])
            t0 = time.perf_counter()
        if i % 50 == 0 or i == steps - 1:
            print(f"step {i:4d} loss={float(metrics['loss']):.4f} "
                f"photo={float(metrics['photo_loss']):.4f} "
                f"geom={float(metrics['geometry_loss']):.4f} "
                f"smooth={float(metrics['smooth_loss']):.4f}", flush=True)
    final = float(metrics["photo_loss"])
    ms = (time.perf_counter() - t0) * 1e3 / (steps - 1) if steps > 1 else float("nan")

    disp_net.eval()
    with torch.no_grad():
        pred = 1.0 / disp_net(batch["tgt"])[0][0, ..., 0].float()
    corr = float(np.corrcoef(pred.cpu().numpy().reshape(-1), depth.reshape(-1))[0, 1])
    ratio = final / max(first, 1e-9)
    return {"first_photo": first, "final_photo": final, "ratio": ratio, "correlation": corr,
            "ms_per_step": ms, "ok": ratio < LOSS_RATIO_MAX and corr > CORRELATION_MIN}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--lr", type=float, default=2e-4)
    add_device_flags(p)
    args = p.parse_args(argv)
    device = cli_device(args.device)
    r = run(args.steps, args.lr, device, args.precision)
    print(f"photo loss: {r['first_photo']:.4f} -> {r['final_photo']:.4f} ({r['ratio']:.2%})")
    print(f"depth correlation (pred vs true): {r['correlation']:.3f}")
    print(f"ms per step after the first: {r['ms_per_step']:.3f} ({device})")
    print("OVERFIT CHECK:", "PASS" if r["ok"] else "FAIL")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
