"""SC-Depth in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The counterpart of the JAX package ``sc_sfmlearner_release_tpu``, with the
same layout (``ops/``, ``models/``, ``training/``) and the same layouts at
its public functions (NHWC images, ``[B, H, W, 1]`` depths, ``[B, 3, 3]``
intrinsics). It imports neither JAX nor the JAX package.

The two TPU kernels of the forward path are CUDA C++ kernels in ``csrc/``,
built for ``sm_90a`` at first use (``ops/_build.py``): the bilinear warp
sampler (``ops/warp.py``) and the SSIM map (``ops/ssim.py``). Each wrapper
launches its kernel on a CUDA tensor and runs its plain PyTorch version on
a CPU tensor.

Entry points take ``device=None``, which means ``"cuda"``, and raise when no
card is present unless the caller asks for ``device="cpu"``.
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
