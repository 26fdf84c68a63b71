#!/usr/bin/env bash
# KITTI Abs-Rel parity runbook on the PyTorch port: the reference-protocol
# chain
#   prepare -> pack -> train -> test_disp -> eval_depth -> test_vo -> eval_odom
# with the canonical hyperparameters (the reference's
# train_resnet18_depth_256.sh, test_kitti_depth.sh, test_kitti_vo.sh). With
# real KITTI present this one script runs the published-number gate (Eigen
# Abs Rel 0.119; odometry sequences 09-10).
#
# Real data (on the card; DEVICE=cpu runs every step on the CPU):
#   KITTI_RAW=/data/kitti_raw DEPTH_TEST=/data/kitti_depth_test \
#   ODOM=/data/kitti_odom/sequences IMAGENET_WEIGHTS_DIR=... \
#   bash sc_sfmlearner_release_tpu_torch/scripts/kitti_parity_runbook.sh
#
# Smoke mode (no data needed; a miniature KITTI at 64x128, one epoch of 4
# steps of batch 2):
#   SMOKE=1 bash sc_sfmlearner_release_tpu_torch/scripts/kitti_parity_runbook.sh
#
# Everything, the checkpoints included (checkpoints/<name>/<timestamp>/
# under $WORK), goes under $WORK; smoke mode starts by emptying $WORK.
set -euo pipefail
REPO=$(cd "$(dirname "$0")/../.." && pwd -P)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

SMOKE=${SMOKE:-0}
WORK=${WORK:-/tmp/kitti_parity}
NAME=${NAME:-parity_r18}
SEQ=${SEQ:-09}
DEVICE=${DEVICE:-cuda}
# bf16 convolutions on the card (the trainer's default), fp32 on the CPU.
if [ "$DEVICE" = "cpu" ]; then PRECISION=${PRECISION:-fp32}; else PRECISION=${PRECISION:-bf16}; fi

# WORK as the caller names it (a relative one from the caller's directory).
# Smoke mode empties it: refuse / and any directory that is or holds the
# repository or $HOME.
mkdir -p "$WORK"
WORK=$(cd "$WORK" && pwd -P)
HOME_DIR=$(cd "${HOME:-/}" 2>/dev/null && pwd -P || echo /)
for keep in / "$REPO" "$HOME_DIR"; do
    case "${keep%/}/" in
        "${WORK%/}"/*) echo "refusing WORK=$WORK: the runbook empties it, and it holds $keep" >&2
                       exit 1 ;;
    esac
done
cd "$REPO"

if [ "$SMOKE" = "1" ]; then
    H=64; W=128  # multiples of 32 (the encoder's stride)
    EPOCHS=1; EPOCH_SIZE=4; BATCH=2; PRETRAIN=0
    KITTI_RAW="$WORK/smoke/raw"
    DEPTH_TEST="$WORK/smoke/depth_test"
    ODOM="$WORK/smoke/odom"
    GT_DIR="$WORK/smoke/odom/gt"
    rm -rf "${WORK:?}"
    mkdir -p "$WORK"
    python -m sc_sfmlearner_release_tpu_torch.tools.make_smoke_kitti "$WORK/smoke" \
        --height $H --width $W --seq "$SEQ"
else
    H=256; W=832
    EPOCHS=${EPOCHS:-200}; EPOCH_SIZE=${EPOCH_SIZE:-1000}
    BATCH=${BATCH:-4}; PRETRAIN=1
    : "${KITTI_RAW:?set KITTI_RAW to the KITTI raw root}"
    : "${DEPTH_TEST:?set DEPTH_TEST to the Eigen test root (color/ + depth/)}"
    : "${ODOM:?set ODOM to the odometry sequences root (<seq>/image_2)}"
    GT_DIR=${GT_DIR:-}  # eval_odom's default: the repository's sequences 00-10
fi

TRAIN_SET="$WORK/train_set"
RESULTS="$WORK/results"
mkdir -p "$RESULTS"

echo "== [1/6] prepare_train_data =="
if [ ! -f "$TRAIN_SET/train.txt" ]; then
    python -m sc_sfmlearner_release_tpu_torch.prepare_train_data "$KITTI_RAW" \
        --dataset-format kitti_raw --dump-root "$TRAIN_SET" --width $W --height $H \
        --num-threads 4 --device "$DEVICE"
else
    echo "   (reusing $TRAIN_SET)"
fi

echo "== [2/6] pack (decode-once uint8 memmap) =="
[ -d "$TRAIN_SET/packed" ] || python -m sc_sfmlearner_release_tpu_torch.data.packed "$TRAIN_SET"

echo "== [3/6] train (canonical r18 config) =="
(cd "$WORK" && python -m sc_sfmlearner_release_tpu_torch.train "$TRAIN_SET" \
    --resnet-layers 18 --num-scales 1 \
    -b$BATCH -s0.1 -c0.5 --epoch-size $EPOCH_SIZE --epochs $EPOCHS \
    --sequence-length 3 \
    --with-ssim 1 --with-mask 1 --with-auto-mask 1 \
    --with-pretrain $PRETRAIN \
    ${IMAGENET_WEIGHTS_DIR:+--imagenet-weights-dir "$IMAGENET_WEIGHTS_DIR"} \
    --packed --device-augment --fused-steps ${FUSED_STEPS:-1} \
    --device "$DEVICE" --precision "$PRECISION" \
    --no-tensorboard --name "$NAME")

CKPT_DIR=$(ls -dt "$WORK"/checkpoints/"$NAME"/*/ | head -1)
DISP_NET="$CKPT_DIR/dispnet_model_best.pth.tar"
POSE_NET="$CKPT_DIR/exp_pose_model_best.pth.tar"
echo "   checkpoints: $CKPT_DIR"

echo "== [4/6] test_disp (Eigen inference) =="
python -m sc_sfmlearner_release_tpu_torch.test_disp --resnet-layers 18 \
    --img-height $H --img-width $W \
    --pretrained-dispnet "$DISP_NET" --dataset-dir "$DEPTH_TEST/color" \
    --output-dir "$RESULTS" --device "$DEVICE" --precision "$PRECISION"

echo "== [5/6] eval_depth (Abs Rel gate) =="
python -m sc_sfmlearner_release_tpu_torch.eval_depth --dataset kitti \
    --pred_depth "$RESULTS/predictions.npy" --gt_depth "$DEPTH_TEST/depth"

echo "== [6/6] test_vo + eval_odom (seq $SEQ) =="
python -m sc_sfmlearner_release_tpu_torch.test_vo --pretrained-posenet "$POSE_NET" \
    --img-height $H --img-width $W \
    --dataset-dir "$ODOM" --sequence "$SEQ" --output-dir "$RESULTS/vo" \
    --device "$DEVICE" --precision "$PRECISION"
python -m sc_sfmlearner_release_tpu_torch.eval_odom --result "$RESULTS/vo" \
    ${GT_DIR:+--gt_dir "$GT_DIR"} --align 7dof --seqs "$SEQ" --no-confirm --no-plot

echo "RUNBOOK COMPLETE — artifacts under $RESULTS"
