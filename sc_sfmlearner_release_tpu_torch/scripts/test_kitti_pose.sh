#!/usr/bin/env bash
# 5-frame snippet pose evaluation on sequences 09/10, on the PyTorch port
# (DEVICE=cpu on the CPU).
set -euo pipefail
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
DEVICE=${DEVICE:-cuda}
POSE_NET=${POSE_NET:-checkpoints/resnet50_pose_256/exp_pose_model_best.pth.tar}
KITTI_VO=${KITTI_VO:-/data/kitti_odom_test/}

python -m sc_sfmlearner_release_tpu_torch.test_pose $POSE_NET \
--img-height 256 --img-width 832 \
--dataset-dir $KITTI_VO \
--sequences 09 --device $DEVICE

python -m sc_sfmlearner_release_tpu_torch.test_pose $POSE_NET \
--img-height 256 --img-width 832 \
--dataset-dir $KITTI_VO \
--sequences 10 --device $DEVICE
