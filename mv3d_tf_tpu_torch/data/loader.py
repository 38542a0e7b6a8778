"""Host data loading (mv3d_tf_tpu/data/loader.py:23-79): one frame's image,
BEV raster and calib as fixed-shape numpy blobs, padded to the static
image bucket and MAX_GT gt rows with a validity mask, as the train step and
the detector take them. The epoch cursor ``RoIDataLayer`` belongs to the
training loop and waits for it (ROADMAP.md, Queue 1 item 8).

Images load as BGR float32 through Pillow, as the JAX package loads them
(cv2.imread parity: PIXEL_MEANS is BGR).
"""

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
