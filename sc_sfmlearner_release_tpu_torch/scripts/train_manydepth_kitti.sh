#!/usr/bin/env bash
# ManyDepth's published KITTI training (github.com/nianticlabs/manydepth,
# the defaults of its options module: `python -m manydepth.train`) on the
# PyTorch port: ResNet-18 teacher, multi-frame and pose networks, batch 12
# at 640x192, frames 0 -1 +1, four scales, 96 depth bins, Adam 1e-4 for 20
# epochs, the teacher frozen from epoch 15. The prepared 832x256 KITTI
# frames (the port's prepare_train_data) are packed once
# (python -m sc_sfmlearner_release_tpu_torch.data.packed $TRAIN_SET),
# augmented on the card and resized there to 640x192; --fused-steps 16 runs
# 16 optimizer steps per dispatch, one CUDA-graph replay. Checkpoints:
# checkpoints/manydepth_kitti/<timestamp>/manydepth.pth.tar. DEVICE=cpu
# trains on the CPU.
set -euo pipefail
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
DEVICE=${DEVICE:-cuda}
TRAIN_SET=${TRAIN_SET:-/data/kitti_256/}
python -m sc_sfmlearner_release_tpu_torch.train $TRAIN_SET \
--arch manydepth \
--resnet-layers 18 --sequence-length 3 \
-b12 --lr 1e-4 --epochs 20 \
--height 192 --width 640 --num-scales 4 \
--min-depth 0.1 --max-depth 100 \
--num-depth-bins 96 \
--disparity-smoothness 1e-3 --freeze-teacher-epoch 15 \
--with-pretrain 1 ${IMAGENET_WEIGHTS_DIR:+--imagenet-weights-dir "$IMAGENET_WEIGHTS_DIR"} \
--packed --device-augment --fused-steps ${FUSED_STEPS:-16} \
--device $DEVICE \
--name manydepth_kitti
