#!/usr/bin/env bash
# NYUv2 rectified training (pair folders) @ 320x256, on the PyTorch port.
# DEVICE=cpu trains on the CPU.
set -euo pipefail
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
DEVICE=${DEVICE:-cuda}
TRAIN_SET=${TRAIN_SET:-/data/rectified_nyu/}
python -m sc_sfmlearner_release_tpu_torch.train $TRAIN_SET \
--folder-type pair \
--resnet-layers 18 \
--num-scales 1 \
-b16 -s0.1 -c0.5 --epoch-size 0 --epochs 50 \
--with-ssim 1 --with-mask 1 --with-auto-mask 1 --with-pretrain 1 ${IMAGENET_WEIGHTS_DIR:+--imagenet-weights-dir "$IMAGENET_WEIGHTS_DIR"} \
--log-output --with-gt \
--dataset nyu \
--device $DEVICE \
--name r18_rectified_nyu
