"""SC-Depth in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The counterpart of the JAX package ``sc_sfmlearner_release_tpu``, with the
same layout (``ops/``, ``models/``, ``training/``) and the same layouts at
its public functions (NHWC images, ``[B, H, W, 1]`` depths, ``[B, 3, 3]``
intrinsics). It imports neither JAX nor the JAX package.

The two TPU kernels of the main path are CUDA C++ kernels in ``csrc/``,
each with a hand-written backward kernel, built for ``sm_90a`` at first use
(``ops/_build.py``): the bilinear warp sampler (``ops/warp.py``,
``csrc/warp_sample.cu``) and the SSIM map (``ops/ssim.py``,
``csrc/ssim.cu`` and ``csrc/ssim_bwd.cu``). Each wrapper launches its
kernel on a CUDA tensor, through an autograd Function whose backward is
the backward kernel when a gradient is needed, and runs its plain PyTorch
version on a CPU tensor.

Entry points: the train CLI (``python -m sc_sfmlearner_release_tpu_torch.train``,
``train.py``) and, in ``training/``, ``make_train_step`` (forward in train
mode, 3-term loss, backward, Adam from ``make_optimizer``; ``remat``, a
device ``augment_fn``, and ``fused_steps``: K steps per call, one CUDA-graph
replay on the card), ``make_eval_step`` (photometric validation),
``make_eval_depth_step`` (ground-truth depth metrics), ``make_inference_fn``
and the checkpoints (``training/checkpoint.py``). Host data (``data/``: the
dataset crawlers, the packed uint8 format, the batch loader, the host
transforms, the device augmentation) reaches the card through
``parallel.device_prefetch``.

Entry points take ``device=None`` (the CLI ``--device cuda``), which means
CUDA, and raise when no card is present unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path"
        )
    return dev


def disable_tf32() -> None:
    """Full fp32 for matmuls and cuDNN convolutions.

    The geometry matmuls are precision-critical (the JAX package runs them at
    ``Precision.HIGHEST``). PyTorch keeps fp32 matmuls out of TF32 by default
    but lets cuDNN run fp32 convolutions in TF32, so both switches are set.
    bf16 convolutions (the default precision) are unaffected.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
