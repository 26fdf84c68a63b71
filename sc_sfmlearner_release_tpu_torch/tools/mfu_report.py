"""Model FLOPs utilization of the graphed train step on a CUDA card.

The counterpart of the repository's ``tools/mfu_report.py``. FLOPs per
optimizer step come from :func:`flop_model`: the convolutions and matmuls
of the port's DispNet over the 1+N frames and PoseNet over the 2N pairs
of each snippet, counted by ``torch.utils.flop_counter.FlopCounterMode``
(on ``meta`` tensors, so any machine can count), times 3 for the forward
and the backward, plus the JAX tool's 8 FLOP per pixel and channel for the
bilinear warp of 5 channels. The port samples with a gather, so the FLOPs
it issues are the FLOPs the model needs (``issued == useful``); the JAX
tool's band-warp matmul term is 0 here. The elementwise work (BatchNorm,
losses, Adam) is not counted, as in the JAX tool's model.

The time is the device time per optimizer step of the JAX tool's step
(float noise frames, no augmentation, the auto-mask on) as
``make_train_step(fused_steps=K)``, one CUDA-graph replay of K steps, from
CUDA events around back-to-back replays after the warm-up and the capture
(``ablate_step``'s ``build`` and ``step_times``).
MFU is the FLOP rate over the card's bf16 dense peak from NVIDIA's data
sheets (:data:`PEAK_BF16_TFLOPS`); an unlisted card raises.

    python -m sc_sfmlearner_release_tpu_torch.tools.mfu_report [--batch 4] [--fused-steps 8]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import cli_device
from ..models import DispNet, PoseNet
from ..utils.profiling import card_line
from .ablate_step import build, step_times

# bf16 dense (no sparsity) tensor-core peaks, TFLOP/s, from NVIDIA's data
# sheets, by a substring of torch.cuda.get_device_name(): the H100 SXM5
# (which names itself "H100 80GB HBM3"), the H100 PCIe and the A100.
PEAK_BF16_TFLOPS = (
    ("H100 80GB HBM3", 989.4),
    ("H100 SXM", 989.4),
    ("H100 PCIe", 756.5),
    ("A100", 312.0),
)
WARP_FLOPS_PER_PX = 8 * 5   # the JAX tool's bilinear combine: 8 FLOP for each of 5 channels


def forward_flops(num_layers: int = 18, h: int = 256, w: int = 832) -> dict:
    """Forward FLOPs (convolutions and matmuls, ``FlopCounterMode``) of one
    DispNet frame and one PoseNet pair at ``h``x``w``, in eval mode, on
    ``meta`` tensors."""
    out = {}
    for name, net, n_inputs in (("disp", DispNet(num_layers), 1), ("pose", PoseNet(18), 2)):
        net = net.eval().to("meta")
        x = torch.empty((1, h, w, 3), device="meta")
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            net(*([x] * n_inputs))
        out[name] = float(counter.get_total_flops())
    return out


def flop_model(b: int, n: int = 2, h: int = 256, w: int = 832, num_layers: int = 18) -> dict:
    """FLOPs of one optimizer step at B=``b``, N=``n``: ``conv`` (the
    networks, x3 for the forward and the backward), ``warp`` (0: no band
    matmuls), ``issued`` (= conv) and ``useful`` (conv + the bilinear
    combine), with the per-frame and per-pair forwards."""
    frames, pairs = (1 + n) * b, 2 * n * b
    fwd = forward_flops(num_layers, h, w)
    conv = 3.0 * (fwd["disp"] * frames + fwd["pose"] * pairs)
    useful = conv + 2.0 * pairs * h * w * WARP_FLOPS_PER_PX
    return {"conv": conv, "warp": 0.0, "issued": conv, "useful": useful,
            "disp_forward_per_frame": fwd["disp"], "pose_forward_per_pair": fwd["pose"]}


def peak_tflops(name: str = None) -> float:
    """The bf16 dense peak of the card ``name`` (default: CUDA card 0)."""
    name = torch.cuda.get_device_name(0) if name is None else name
    for key, peak in PEAK_BF16_TFLOPS:
        if key in name:
            return peak
    raise ValueError(f"no bf16 peak is listed for {name!r}: add its data sheet's dense "
                     "bf16 rate to PEAK_BF16_TFLOPS")


def report(b: int = 4, k: int = 8, iters: int = 5, remat: bool = False) -> dict:
    """FLOPs per step, ms per step, TFLOP/s and MFU on CUDA card 0."""
    peak = peak_tflops()
    fm = flop_model(b)
    # The JAX tool's step: float noise frames, no augmentation.
    step, batch, k, _ = build({"augment": False, "batch": b, "remat": remat}, "cuda", k)
    ms = float(np.median(step_times(step, batch, k, iters, reps=1)))
    tflops = fm["useful"] / (ms * 1e-3) / 1e12
    return {"card": card_line(), "batch": b, "fused_steps": k, "remat": remat,
            "gflop_per_step": fm["useful"] / 1e9, "conv_gflop_per_step": fm["conv"] / 1e9,
            "ms_per_step": ms, "tflops": tflops, "peak_tflops": peak, "mfu": tflops / peak}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--fused-steps", type=int, default=8)
    p.add_argument("--iters", type=int, default=5, help="timed replays")
    p.add_argument("--remat", action="store_true")
    args = p.parse_args(argv)
    cli_device("cuda")
    r = report(args.batch, max(args.fused_steps, 1), args.iters, args.remat)
    print(f"device: {r['card']}  peak {r['peak_tflops']} bf16 TFLOP/s (dense)")
    print(f"config: b{r['batch']} remat={r['remat']} fused={r['fused_steps']}")
    print(f"flops/step: {r['gflop_per_step']:.1f} GFLOP ({r['conv_gflop_per_step']:.1f} "
          "conv/matmul, the rest the bilinear combine; issued = useful)")
    print(f"device time per step (graph replay, CUDA events): {r['ms_per_step']:.3f} ms")
    print(f"model FLOPs utilization: {r['tflops']:.2f} TFLOP/s -> {100 * r['mfu']:.2f}% MFU")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
