#!/usr/bin/env bash
# Eigen-split depth inference and evaluation, on the PyTorch port
# (DEVICE=cpu on the CPU).
set -euo pipefail
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
DEVICE=${DEVICE:-cuda}
DISP_NET=${DISP_NET:-checkpoints/resnet18_depth_256/dispnet_model_best.pth.tar}
DATA_ROOT=${DATA_ROOT:-/data/kitti_depth_test}
RESULTS_DIR=${RESULTS_DIR:-results/test}

python -m sc_sfmlearner_release_tpu_torch.test_disp --resnet-layers 18 --img-height 256 --img-width 832 \
--pretrained-dispnet $DISP_NET --dataset-dir $DATA_ROOT/color \
--output-dir $RESULTS_DIR --device $DEVICE

python -m sc_sfmlearner_release_tpu_torch.eval_depth \
--dataset kitti \
--pred_depth=$RESULTS_DIR/predictions.npy \
--gt_depth=$DATA_ROOT/depth
