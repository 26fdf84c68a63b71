#!/usr/bin/env bash
# Dump KITTI raw to the 832x256 training format with ground-truth depth, on
# the PyTorch port (frames resized on the card; DEVICE=cpu on the CPU).
set -euo pipefail
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
DEVICE=${DEVICE:-cuda}
DATASET=${DATASET:-/data/kitti_raw/}
TRAIN_SET=${TRAIN_SET:-/data/kitti_256/}
STATIC_FILES=${STATIC_FILES:-$REPO/data/static_frames.txt}   # ships with the KITTI tooling
TEST_SCENES=${TEST_SCENES:-$REPO/data/test_scenes.txt}
python -m sc_sfmlearner_release_tpu_torch.prepare_train_data $DATASET --dataset-format kitti_raw \
  --dump-root $TRAIN_SET --width 832 --height 256 --num-threads 8 \
  --static-frames $STATIC_FILES --test-scenes $TEST_SCENES --with-depth --device $DEVICE

# kitti odometry:
# python -m sc_sfmlearner_release_tpu_torch.prepare_train_data /data/kitti_odom \
#   --dataset-format kitti_odom --dump-root /data/kitti_vo_256 --width 832 --height 256 \
#   --num-threads 8 --device $DEVICE
# cityscapes:
# python -m sc_sfmlearner_release_tpu_torch.prepare_train_data /data/cityscapes \
#   --dataset-format cityscapes --dump-root /data/cs_256 --width 832 --height 342 \
#   --num-threads 8 --device $DEVICE
