#!/bin/bash
# Train -> test pipeline of the PyTorch port (the counterpart of
# experiments/scripts/mv3d.sh), run from the repository root:
#   ./mv3d_tf_tpu_torch/scripts/mv3d.sh DEV DEV_ID WEIGHTS DATASET [ITERS] [KITTI_PATH]
# DEV is cuda or cpu; WEIGHTS is a .npy weight dict or "none". Logs tee to
# experiments/logs/ and the last snapshot train_net wrote feeds test_net.

set -x
set -e
set -o pipefail

export PYTHONUNBUFFERED="True"

DEV=$1
DEV_ID=$2
WEIGHTS=$3
DATASET=$4
ITERS=${5:-50001}
KITTI_PATH=${6:-}

case $DATASET in
  kitti_train|kitti_trainval)
    TRAIN_IMDB=$DATASET
    TEST_IMDB="kitti_val"
    ;;
  *)
    echo "No dataset given"
    exit 1
    ;;
esac

EXTRA=""
if [ -n "$KITTI_PATH" ]; then
  EXTRA="--kitti_path ${KITTI_PATH}"
fi
WEIGHTS_ARG=""
if [ -n "$WEIGHTS" ] && [ "$WEIGHTS" != "none" ]; then
  WEIGHTS_ARG="--weights ${WEIGHTS}"
fi

mkdir -p experiments/logs
LOG="experiments/logs/mv3d_${DATASET}_$(date +'%Y-%m-%d_%H-%M-%S').txt"
exec &> >(tee -a "$LOG")
echo Logging output to "$LOG"

# train_net's own copy of its output: the snapshot is read from it once the
# pipe has closed, not from $LOG while the tee above may still be writing
TRAIN_LOG="${LOG%.txt}_train.txt"
python3 -m mv3d_tf_tpu_torch.tools.train_net --device ${DEV} --device_id ${DEV_ID} \
  ${WEIGHTS_ARG} \
  --imdb ${TRAIN_IMDB} \
  --iters ${ITERS} \
  --cfg experiments/cfgs/faster_rcnn_end2end.yml \
  --network MV3D_train \
  ${EXTRA} 2>&1 | tee "$TRAIN_LOG"

set +x
NET_FINAL=$(grep -B 1 "done solving\|Wrote snapshot" "$TRAIN_LOG" | grep "Wrote snapshot" | tail -n 1 | awk '{print $4}')
set -x

python3 -m mv3d_tf_tpu_torch.tools.test_net --device ${DEV} --device_id ${DEV_ID} \
  --weights ${NET_FINAL} \
  --imdb ${TEST_IMDB} \
  --cfg experiments/cfgs/faster_rcnn_end2end.yml \
  --network MV3D_test \
  ${EXTRA}
