"""Host data loading (mv3d_tf_tpu/data/loader.py): one frame's image, BEV
raster and calib as fixed-shape numpy blobs, padded to the static image
bucket and MAX_GT gt rows with a validity mask, as the train step and the
detector take them; and ``RoIDataLayer``, the training loop's
epoch-permuted cursor with a background prefetch thread.

Images load as BGR float32 through Pillow, as the JAX package loads them
(cv2.imread parity: PIXEL_MEANS is BGR).
"""

import queue
import threading

import numpy as np

from mv3d_tf_tpu_torch.config import cfg


def load_image_bgr(path):
    """An image file -> (H, W, 3) BGR float32."""
    from PIL import Image
    rgb = np.asarray(Image.open(path).convert("RGB"), np.uint8)
    return rgb[:, :, ::-1].astype(np.float32)


def pad_image(img, bucket=None):
    """Bottom/right zero-pad (or crop) to the static bucket, the zero halo
    the SAME-padded convs would see."""
    if bucket is None:
        bucket = cfg.TPU.IMAGE_SHAPE
    h, w = min(img.shape[0], bucket[0]), min(img.shape[1], bucket[1])
    out = np.zeros(bucket, np.float32)
    out[:h, :w] = img[:h, :w]
    return out


def pad_gt(entry, max_gt=None):
    """A roidb entry -> fixed (MAX_GT, ...) gt blocks and the validity mask,
    the class appended as each block's last column (minibatch_mv3d.py:49-70).
    """
    if max_gt is None:
        max_gt = cfg.TPU.MAX_GT
    gt_inds = np.where(entry["gt_classes"] != 0)[0][:max_gt]
    n = len(gt_inds)
    bv = np.zeros((max_gt, 5), np.float32)
    b3 = np.zeros((max_gt, 7), np.float32)
    b3[:, 3:6] = 1.0          # keep log() finite on padded rows
    cnr = np.zeros((max_gt, 25), np.float32)
    boxes = np.zeros((max_gt, 5), np.float32)
    bv[:n, :4] = entry["boxes_bv"][gt_inds]
    bv[:n, 4] = entry["gt_classes"][gt_inds]
    b3[:n, :6] = entry["boxes_3D"][gt_inds]
    b3[:n, 6] = entry["gt_classes"][gt_inds]
    cnr[:n, :24] = entry["boxes_corners"][gt_inds]
    cnr[:n, 24] = entry["gt_classes"][gt_inds]
    boxes[:n, :4] = entry["boxes"][gt_inds]
    boxes[:n, 4] = entry["gt_classes"][gt_inds]
    valid = np.zeros(max_gt, bool)
    valid[:n] = True
    return {"gt_boxes": boxes, "gt_boxes_bv": bv, "gt_boxes_3d": b3,
            "gt_boxes_corners": cnr, "gt_valid": valid}


def get_minibatch(entry, image_bucket=None, max_gt=None):
    """One prepared roidb entry -> the fixed-shape batch dict of the train
    step (minibatch_mv3d.py:17-76; the mean is subtracted on the device)."""
    image = pad_image(load_image_bgr(entry["image_path"]), image_bucket)
    bev = np.load(entry["lidar_bv_path"]).astype(np.float32)
    batch = {"image": image, "bev": bev,
             "calib": entry["calib"].astype(np.float32),
             "im_info": np.array(
                 [[bev.shape[0], bev.shape[1], 1.0]], np.float32)}
    batch.update(pad_gt(entry, max_gt))
    return batch


class _PrefetchError:
    """A prefetch worker's exception, carried to forward()."""

    def __init__(self, exc):
        self.exc = exc


class RoIDataLayer:
    """Epoch-permuted cursor over the roidb (loader.py:89-143): each epoch
    a permutation from np.random.RandomState(cfg.RNG_SEED, or seed), drawn
    again when the cursor runs out. With prefetch > 0 a daemon thread loads
    that many minibatches ahead; an exception in it is raised by forward()
    as a RuntimeError from the worker's exception."""

    def __init__(self, roidb, num_classes=2, seed=None, prefetch=2):
        self._roidb = roidb
        self._num_classes = num_classes
        self._rng = np.random.RandomState(
            cfg.RNG_SEED if seed is None else seed)
        self._shuffle()
        self._queue = None
        if prefetch:
            self._queue = queue.Queue(maxsize=prefetch)
            threading.Thread(target=self._worker, daemon=True).start()

    def _shuffle(self):
        self._perm = self._rng.permutation(np.arange(len(self._roidb)))
        self._cur = 0

    def next_index(self):
        """Advance the cursor without loading anything: the frame index
        for a device-resident dataset, in forward()'s order."""
        if self._cur >= len(self._roidb):
            self._shuffle()
        i = self._perm[self._cur]
        self._cur += 1
        return i

    def _load_next(self):
        return get_minibatch(self._roidb[self.next_index()])

    def _worker(self):
        while True:
            try:
                item = self._load_next()
            except BaseException as e:      # carried to forward()
                self._queue.put(_PrefetchError(e))
                return
            self._queue.put(item)

    def forward(self):
        """The next minibatch dict (get_minibatch)."""
        if self._queue is None:
            return self._load_next()
        item = self._queue.get()
        if isinstance(item, _PrefetchError):
            raise RuntimeError(
                "prefetch worker died: {!r}".format(item.exc)) from item.exc
        return item
