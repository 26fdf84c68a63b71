"""Converter between the reference's torch checkpoints and the JAX package's
flax ``.msgpack`` files, without JAX, flax or the ``msgpack`` package.

The counterpart of the repository's ``tools/convert_checkpoint.py``, with
its arguments::

  # reference -> JAX layout
  python -m sc_sfmlearner_release_tpu_torch.tools.convert_checkpoint --net disp \\
      --resnet-layers 18 dispnet_model_best.pth.tar dispnet_model_best.msgpack

  # JAX layout -> reference (the port reads either)
  python -m sc_sfmlearner_release_tpu_torch.tools.convert_checkpoint --net pose \\
      exp_pose_checkpoint.msgpack exp_pose_checkpoint.pth.tar
"""

from __future__ import annotations

import argparse
import sys

from ..inference import TORCH_SUFFIXES, restore_disp_state, restore_pose_state
from ..models.convert import (
    disp_to_jax, load_torch_state_dict, pose_to_jax, save_torch_checkpoint, write_jax_variables,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="input checkpoint (.pth[.tar] or .msgpack)")
    p.add_argument("dst", help="output checkpoint (.msgpack or .pth[.tar])")
    p.add_argument("--net", required=True, choices=["disp", "pose"])
    p.add_argument("--resnet-layers", type=int, default=18, choices=[18, 50])
    p.add_argument("--epoch", type=int, default=0,
                   help="epoch stamp for torch-format output")
    args = p.parse_args(argv)

    src_torch = args.src.endswith(TORCH_SUFFIXES)
    dst_torch = args.dst.endswith(TORCH_SUFFIXES)
    if src_torch and not dst_torch:
        to_jax = disp_to_jax if args.net == "disp" else pose_to_jax
        write_jax_variables(args.dst, to_jax(load_torch_state_dict(args.src),
                                             args.resnet_layers))
    elif not src_torch and dst_torch:
        restore = restore_disp_state if args.net == "disp" else restore_pose_state
        sd = restore(args.src, args.resnet_layers)
        save_torch_checkpoint(sd, args.dst, epoch=args.epoch)
    else:
        p.error("exactly one side must be a torch checkpoint")
    print(f"converted {args.src} -> {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
