#!/bin/bash
# 2D Faster R-CNN end-to-end train -> test pipeline of the PyTorch port (the
# counterpart of experiments/scripts/faster_rcnn_end2end.sh), run from the
# repository root:
#   ./mv3d_tf_tpu_torch/scripts/faster_rcnn_end2end.sh DEV DEV_ID NET DATASET \
#       [--devkit_path P | --kitti_path P | --set KEY VALUE ...]
# DEV is cuda or cpu; DATASET is pascal_voc or coco; NET is VGGnet (the
# framework's 2D net). Logs tee to experiments/logs/ and the last snapshot
# train_net wrote feeds test_net.

set -x
set -e
set -o pipefail

export PYTHONUNBUFFERED="True"

DEV=$1
DEV_ID=$2
NET=$3
DATASET=$4

array=( $@ )
len=${#array[@]}
EXTRA_ARGS=${array[@]:4:$len}
EXTRA_ARGS_SLUG=${EXTRA_ARGS// /_}

case $DATASET in
  pascal_voc)
    TRAIN_IMDB="voc_2007_trainval"
    TEST_IMDB="voc_2007_test"
    ITERS=70000
    ;;
  coco)
    TRAIN_IMDB="coco_2014_train"
    TEST_IMDB="coco_2014_minival"
    ITERS=490000
    ;;
  *)
    echo "No dataset given"
    exit 1
    ;;
esac

mkdir -p experiments/logs
LOG="experiments/logs/faster_rcnn_end2end_${NET}_${EXTRA_ARGS_SLUG}_$(date +'%Y-%m-%d_%H-%M-%S').txt"
exec &> >(tee -a "$LOG")
echo Logging output to "$LOG"

# train_net's own copy of its output: the snapshot is read from it once the
# pipe has closed, not from $LOG while the tee above may still be writing
TRAIN_LOG="${LOG%.txt}_train.txt"
python3 -m mv3d_tf_tpu_torch.tools.train_net --device ${DEV} --device_id ${DEV_ID} \
  --weights data/pretrain_model/VGG_imagenet.npy \
  --imdb ${TRAIN_IMDB} \
  --iters ${ITERS} \
  --cfg experiments/cfgs/faster_rcnn_end2end.yml \
  --network ${NET}_train \
  ${EXTRA_ARGS} 2>&1 | tee "$TRAIN_LOG"

set +x
NET_FINAL=$(grep -B 1 "done solving\|Wrote snapshot" "$TRAIN_LOG" | grep "Wrote snapshot" | tail -n 1 | awk '{print $4}')
set -x

python3 -m mv3d_tf_tpu_torch.tools.test_net --device ${DEV} --device_id ${DEV_ID} \
  --weights ${NET_FINAL} \
  --imdb ${TEST_IMDB} \
  --cfg experiments/cfgs/faster_rcnn_end2end.yml \
  --network ${NET}_test \
  ${EXTRA_ARGS}
