#!/usr/bin/env bash
# Canonical KITTI depth training, ResNet-18 @ 832x256, on the PyTorch port
# (the reference's train_resnet18_depth_256.sh hyperparameters). For the
# fastest ingest pack the dataset once
# (python -m sc_sfmlearner_release_tpu_torch.data.packed $TRAIN_SET) and add
# --packed --device-augment. --fused-steps 16 runs 16 optimizer steps per
# dispatch, one CUDA-graph replay. Checkpoints:
# checkpoints/resnet18_depth_256/<timestamp>/dispnet_model_best.pth.tar.
# DEVICE=cpu trains on the CPU.
set -euo pipefail
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
DEVICE=${DEVICE:-cuda}
TRAIN_SET=${TRAIN_SET:-/data/kitti_256/}
python -m sc_sfmlearner_release_tpu_torch.train $TRAIN_SET \
--resnet-layers 18 \
--num-scales 1 \
-b4 -s0.1 -c0.5 --epoch-size 1000 --sequence-length 3 \
--with-ssim 1 \
--with-mask 1 \
--with-auto-mask 1 \
--with-pretrain 1 ${IMAGENET_WEIGHTS_DIR:+--imagenet-weights-dir "$IMAGENET_WEIGHTS_DIR"} \
--fused-steps ${FUSED_STEPS:-16} \
--log-output --with-gt \
--device $DEVICE \
--name resnet18_depth_256
