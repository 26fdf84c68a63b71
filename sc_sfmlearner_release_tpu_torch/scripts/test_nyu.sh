#!/usr/bin/env bash
# NYUv2 depth test (256x320) and evaluation with visualizations, on the
# PyTorch port (DEVICE=cpu on the CPU).
set -euo pipefail
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
DEVICE=${DEVICE:-cuda}
DISPNET=${DISPNET:-checkpoints/r18_rectified_nyu/dispnet_model_best.pth.tar}
DATA_ROOT=${DATA_ROOT:-/data/nyu_test}
RESULTS_DIR=${RESULTS_DIR:-results/nyu_test/}

python -m sc_sfmlearner_release_tpu_torch.test_disp --resnet-layers 18 --img-height 256 --img-width 320 \
--pretrained-dispnet $DISPNET --dataset-dir $DATA_ROOT/color \
--output-dir $RESULTS_DIR --device $DEVICE

python -m sc_sfmlearner_release_tpu_torch.eval_depth \
--dataset nyu \
--pred_depth=$RESULTS_DIR/predictions.npy \
--gt_depth=$DATA_ROOT/depth.npy \
--img_dir $DATA_ROOT/color --vis_dir $RESULTS_DIR
