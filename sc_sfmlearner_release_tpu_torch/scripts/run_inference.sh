#!/usr/bin/env bash
# Colormapped disparity dump for a directory of images, on the PyTorch port
# (DEVICE=cpu on the CPU).
set -euo pipefail
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
DEVICE=${DEVICE:-cuda}
INPUT_DIR=${INPUT_DIR:-/data/kitti_odometry/sequences/09/image_2}
OUTPUT_DIR=${OUTPUT_DIR:-results/}
DISP_NET=${DISP_NET:-checkpoints/resnet18_depth_256/dispnet_model_best.pth.tar}

python -m sc_sfmlearner_release_tpu_torch.run_inference --pretrained $DISP_NET --resnet-layers 18 \
--dataset-dir $INPUT_DIR --output-dir $OUTPUT_DIR --output-disp --device $DEVICE
