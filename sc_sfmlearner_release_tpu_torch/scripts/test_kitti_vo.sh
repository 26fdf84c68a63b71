#!/usr/bin/env bash
# Full-trajectory VO on sequences 09/10 and the KITTI odometry evaluation
# (7-DoF alignment), on the PyTorch port (DEVICE=cpu on the CPU). The ground
# truth of sequences 00-10 ships in the repository: eval_odom's default
# --gt_dir; GT_DIR overrides it.
set -euo pipefail
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
DEVICE=${DEVICE:-cuda}
DATASET_DIR=${DATASET_DIR:-/data/kitti_odom_test/sequences/}
GT_DIR=${GT_DIR:-}
OUTPUT_DIR=${OUTPUT_DIR:-vo_results/}
POSE_NET=${POSE_NET:-checkpoints/resnet50_pose_256/exp_pose_model_best.pth.tar}

python -m sc_sfmlearner_release_tpu_torch.test_vo \
--img-height 256 --img-width 832 \
--sequence 09 \
--pretrained-posenet $POSE_NET --dataset-dir $DATASET_DIR --output-dir $OUTPUT_DIR \
--device $DEVICE

python -m sc_sfmlearner_release_tpu_torch.test_vo \
--img-height 256 --img-width 832 \
--sequence 10 \
--pretrained-posenet $POSE_NET --dataset-dir $DATASET_DIR --output-dir $OUTPUT_DIR \
--device $DEVICE

python -m sc_sfmlearner_release_tpu_torch.eval_odom --result=$OUTPUT_DIR \
${GT_DIR:+--gt_dir=$GT_DIR} --align=7dof --no-confirm
