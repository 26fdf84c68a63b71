#!/usr/bin/env bash
# NYUv2 parity runbook on the PyTorch port: the reference-protocol
# pair-folder chain
#   train (pair folders, --with-gt nyu validation) -> test_disp -> eval_depth
# with the canonical rectified-NYU hyperparameters (the reference's
# train_nyu.sh and test_nyu.sh). With real rectified NYU present this one
# script runs the published-number gate (Abs Rel 0.143, r18 rectified).
#
# Real data (on the card; DEVICE=cpu runs every step on the CPU):
#   NYU_TRAIN=/data/rectified_nyu NYU_TEST=/data/nyu_test \
#   IMAGENET_WEIGHTS_DIR=... bash sc_sfmlearner_release_tpu_torch/scripts/nyu_parity_runbook.sh
#
# Smoke mode (no data needed; a miniature NYU at 64x96, one epoch of batch 2):
#   SMOKE=1 bash sc_sfmlearner_release_tpu_torch/scripts/nyu_parity_runbook.sh
#
# Everything, the checkpoints included (checkpoints/<name>/<timestamp>/
# under $WORK), goes under $WORK; smoke mode starts by emptying $WORK.
set -euo pipefail
REPO=$(cd "$(dirname "$0")/../.." && pwd -P)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

SMOKE=${SMOKE:-0}
WORK=${WORK:-/tmp/nyu_parity}
NAME=${NAME:-parity_nyu_r18}
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
    H=64; W=96  # multiples of 32 (the encoder's stride)
    EPOCHS=1; BATCH=2; PRETRAIN=0
    NYU_TRAIN="$WORK/smoke/rectified"
    NYU_TEST="$WORK/smoke/test"
    rm -rf "${WORK:?}"
    mkdir -p "$WORK"
    python -m sc_sfmlearner_release_tpu_torch.tools.make_smoke_nyu "$WORK/smoke" \
        --height $H --width $W
else
    # The reference's rectified-NYU protocol: 256x320, batch 16, 50 epochs
    # (train_nyu.sh), full-dataset epochs (--epoch-size 0).
    H=256; W=320
    EPOCHS=${EPOCHS:-50}; BATCH=${BATCH:-16}; PRETRAIN=1
    : "${NYU_TRAIN:?set NYU_TRAIN to the rectified NYU pair-folder root}"
    : "${NYU_TEST:?set NYU_TEST to the NYU test root (color/ + depth.npy)}"
fi

RESULTS="$WORK/results"
mkdir -p "$RESULTS"

echo "== [1/3] train (canonical rectified-NYU r18 config) =="
(cd "$WORK" && python -m sc_sfmlearner_release_tpu_torch.train "$NYU_TRAIN" \
    --folder-type pair --dataset nyu \
    --resnet-layers 18 --num-scales 1 \
    -b$BATCH -s0.1 -c0.5 --epoch-size 0 --epochs $EPOCHS \
    --with-ssim 1 --with-mask 1 --with-auto-mask 1 \
    --with-pretrain $PRETRAIN \
    ${IMAGENET_WEIGHTS_DIR:+--imagenet-weights-dir "$IMAGENET_WEIGHTS_DIR"} \
    --device "$DEVICE" --precision "$PRECISION" \
    --with-gt --no-tensorboard --name "$NAME")

CKPT_DIR=$(ls -dt "$WORK"/checkpoints/"$NAME"/*/ | head -1)
DISP_NET="$CKPT_DIR/dispnet_model_best.pth.tar"
echo "   checkpoints: $CKPT_DIR"

echo "== [2/3] test_disp (NYU test inference) =="
python -m sc_sfmlearner_release_tpu_torch.test_disp --resnet-layers 18 \
    --img-height $H --img-width $W \
    --pretrained-dispnet "$DISP_NET" --dataset-dir "$NYU_TEST/color" \
    --output-dir "$RESULTS" --device "$DEVICE" --precision "$PRECISION"

echo "== [3/3] eval_depth (NYU protocol: Abs Rel / Log10 gate) =="
python -m sc_sfmlearner_release_tpu_torch.eval_depth --dataset nyu \
    --pred_depth "$RESULTS/predictions.npy" --gt_depth "$NYU_TEST/depth.npy"

echo "NYU RUNBOOK COMPLETE — artifacts under $RESULTS"
