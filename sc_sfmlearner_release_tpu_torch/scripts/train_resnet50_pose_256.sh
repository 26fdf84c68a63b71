#!/usr/bin/env bash
# Pose training on KITTI odometry dumps (sequences 00-08) @ 832x256, on the
# PyTorch port. DEVICE=cpu trains on the CPU.
set -euo pipefail
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
DEVICE=${DEVICE:-cuda}
TRAIN_SET=${TRAIN_SET:-/data/kitti_vo_256/}
python -m sc_sfmlearner_release_tpu_torch.train $TRAIN_SET \
--resnet-layers 50 \
--num-scales 1 \
-b4 -s0.1 -c0.5 --epoch-size 1000 --sequence-length 3 \
--with-ssim 1 --with-mask 1 --with-auto-mask 1 --with-pretrain 1 ${IMAGENET_WEIGHTS_DIR:+--imagenet-weights-dir "$IMAGENET_WEIGHTS_DIR"} \
--log-output \
--device $DEVICE \
--name resnet50_pose_256
