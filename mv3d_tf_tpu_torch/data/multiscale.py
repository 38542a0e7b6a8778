"""Multiscale (image pyramid) Fast R-CNN data path, the port's copy of
mv3d_tf_tpu/data/multiscale.py: the reference's `cfg.IS_MULTISCALE`
branch for the legacy 2D pipeline. It draws from the caller's
np.random.RandomState in the JAX package's order and resizes with PIL, as
that module does, so both packages build the same blobs bit for bit.

Reference lineage (all host numpy):
  * lib/roi_data_layer/roidb2.py:42-133   — per-class bbox-target
    normalization stats + compact (cls, dx, dy, dw, dh) target rows;
  * lib/roi_data_layer/minibatch2.py:16-256 — IS_MULTISCALE minibatch:
    image pyramid blob over TRAIN.SCALES_BASE, fg/bg ROI sampling, ROI →
    pyramid-level projection by the 224x224 area rule (:228-256), bbox
    label expansion to 4K columns (:258-281);
  * lib/gt_data_layer/roidb.py + minibatch.py — the caffe-era
    info_boxes data math IS rebuilt below (prepare_gt_roidb,
    add_info_boxes_regression_targets, get_minibatch_gt): its required
    config keys (TRAIN.KERNEL_SIZE / ASPECTS / SCALE_MAPPING /
    ASPECT_HEIGHTS / ASPECT_WIDTHS) are commented out of the reference
    config (lib/fast_rcnn/config.py:47-56), so they are explicit
    arguments here with cfg overrides when present. The caffe.Layer
    adapter shell (gt_data_layer/layer.py:20-109) is not rebuilt.

These produce variable-shape host blobs exactly like the reference;
pad_minibatch_multiscale pads them to the train step's bucket.
"""

import numpy as np

from mv3d_tf_tpu_torch.config import cfg
from mv3d_tf_tpu_torch.data.loader import load_image_bgr


def _pixel_means():
    return np.asarray(cfg.PIXEL_MEANS, np.float32).reshape(1, 1, 3)


def compute_bbox_targets(ex_rois, gt_rois, eps=None):
    """Scale-invariant (dx, dy, dw, dh) targets (roidb2.py:88-133 /
    gt roidb _compute_targets semantics with cfg.EPS regularizers)."""
    eps = cfg.EPS if eps is None else eps
    ex_w = ex_rois[:, 2] - ex_rois[:, 0] + eps
    ex_h = ex_rois[:, 3] - ex_rois[:, 1] + eps
    ex_cx = ex_rois[:, 0] + 0.5 * ex_w
    ex_cy = ex_rois[:, 1] + 0.5 * ex_h
    gt_w = gt_rois[:, 2] - gt_rois[:, 0] + eps
    gt_h = gt_rois[:, 3] - gt_rois[:, 1] + eps
    gt_cx = gt_rois[:, 0] + 0.5 * gt_w
    gt_cy = gt_rois[:, 1] + 0.5 * gt_h
    out = np.zeros((ex_rois.shape[0], 4), np.float32)
    out[:, 0] = (gt_cx - ex_cx) / ex_w
    out[:, 1] = (gt_cy - ex_cy) / ex_h
    out[:, 2] = np.log(gt_w / ex_w)
    out[:, 3] = np.log(gt_h / ex_h)
    return out


def add_bbox_regression_targets(roidb, num_classes):
    """Attach compact per-roi (cls, dx, dy, dw, dh) regression rows and
    normalize them by per-class means/stds (roidb2.py:42-86). Returns
    (means.ravel(), stds.ravel()) for snapshot unnormalization."""
    assert len(roidb) > 0 and "max_classes" in roidb[0], \
        "call prepare_roidb first"
    for entry in roidb:
        rois = entry["boxes"].astype(np.float64)
        labels = entry["max_classes"]
        overlaps = entry["max_overlaps"]
        gt_inds = np.where(overlaps == 1)[0]
        ex_inds = []
        for k in range(1, num_classes):
            ex_inds.extend(np.where(
                (labels == k) & (overlaps >= cfg.TRAIN.BBOX_THRESH))[0])
        ex_inds = np.asarray(ex_inds, np.int64)
        targets = np.zeros((rois.shape[0], 5), np.float32)
        if len(ex_inds) and len(gt_inds):
            from mv3d_tf_tpu_torch.data.imdb_base import bbox_overlaps
            ex_gt = np.asarray(bbox_overlaps(
                rois[ex_inds].astype(np.float32),
                rois[gt_inds].astype(np.float32)))
            assign = ex_gt.argmax(axis=1)
            targets[ex_inds, 0] = labels[ex_inds]
            targets[ex_inds, 1:] = compute_bbox_targets(
                rois[ex_inds], rois[gt_inds[assign]])
        entry["bbox_targets"] = targets

    class_counts = np.zeros((num_classes, 1)) + cfg.EPS
    sums = np.zeros((num_classes, 4))
    sq = np.zeros((num_classes, 4))
    for entry in roidb:
        t = entry["bbox_targets"]
        for k in range(1, num_classes):
            idx = np.where(t[:, 0] == k)[0]
            if idx.size:
                class_counts[k] += idx.size
                sums[k] += t[idx, 1:].sum(axis=0)
                sq[k] += (t[idx, 1:] ** 2).sum(axis=0)
    means = sums / class_counts
    stds = np.sqrt(np.maximum(sq / class_counts - means ** 2, 0.0))
    # per-coordinate zero-std guard: the reference only checks coord 0
    # (roidb2.py:80-82), which NaNs the whole row when another coord is
    # degenerate (constant targets) — divide by 1 there instead
    safe = np.where(stds > 0, stds, 1.0)
    for entry in roidb:
        t = entry["bbox_targets"]
        for k in range(1, num_classes):
            idx = np.where(t[:, 0] == k)[0]
            t[idx, 1:] -= means[k]
            t[idx, 1:] /= safe[k]
    return means.ravel(), safe.ravel()


def get_image_blob_multiscale(entries):
    """Image pyramid blob over cfg.TRAIN.SCALES_BASE for each entry
    (minibatch2.py:196-220): mean-subtracted BGR resized per scale,
    stacked into one zero-padded (N*S, maxH, maxW, 3) blob."""
    from PIL import Image
    ims, scales = [], []
    means = _pixel_means()
    for entry in entries:
        im = load_image_bgr(entry.get("image") or entry["image_path"])
        if entry.get("flipped"):
            im = im[:, ::-1, :].copy()
        im = im - means
        for s in cfg.TRAIN.SCALES_BASE:
            h, w = int(round(im.shape[0] * s)), int(round(im.shape[1] * s))
            if s == 1.0:
                ims.append(im)
            else:
                # bilinear resize via PIL per channel (cv2 parity is at
                # the semantic level; interpolation detail differs)
                res = np.stack([
                    np.asarray(Image.fromarray(im[:, :, c]).resize(
                        (w, h), Image.BILINEAR)) for c in range(3)], axis=2)
                ims.append(res)
            scales.append(s)
    mh = max(i.shape[0] for i in ims)
    mw = max(i.shape[1] for i in ims)
    blob = np.zeros((len(ims), mh, mw, 3), np.float32)
    for i, im in enumerate(ims):
        blob[i, :im.shape[0], :im.shape[1]] = im
    return blob, scales


def project_im_rois_multiscale(im_rois, scales):
    """Assign each ROI to the pyramid level whose scaled area is nearest
    224^2, then scale its coords to that level (minibatch2.py:228-256)."""
    im_rois = im_rois.astype(np.float64)
    scales = np.asarray(scales, np.float64)
    if len(scales) > 1:
        widths = im_rois[:, 2] - im_rois[:, 0] + 1
        heights = im_rois[:, 3] - im_rois[:, 1] + 1
        areas = widths * heights
        scaled = areas[:, None] * (scales[None, :] ** 2)
        levels = np.abs(scaled - 224 * 224).argmin(axis=1)[:, None]
    else:
        levels = np.zeros((im_rois.shape[0], 1), np.int64)
    return im_rois * scales[levels], levels


def _expand_bbox_labels(compact, num_classes):
    """(N,5) compact rows -> (N,4K) targets + inside weights
    (minibatch2.py:258-281)."""
    clss = compact[:, 0].astype(np.int64)
    targets = np.zeros((len(clss), 4 * num_classes), np.float32)
    weights = np.zeros_like(targets)
    for ind in np.where(clss > 0)[0]:
        s = 4 * clss[ind]
        targets[ind, s:s + 4] = compact[ind, 1:]
        weights[ind, s:s + 4] = 1.0
    return targets, weights


def sample_rois(entry, fg_rois_per_image, rois_per_image, num_classes,
                rng):
    """Fast R-CNN fg/bg ROI sampling (minibatch2.py:98-166), including
    the two bg fallback widenings when the [LO,HI) band is short."""
    labels = entry["max_classes"].copy()
    overlaps = entry["max_overlaps"]
    rois = entry["boxes"]

    fg_inds = []
    for k in range(1, num_classes):
        fg_inds.extend(np.where(
            (labels == k) & (overlaps >= cfg.TRAIN.FG_THRESH))[0])
    fg_inds = np.asarray(fg_inds, np.int64)
    n_fg = int(min(fg_rois_per_image, fg_inds.size))
    if fg_inds.size > 0:
        fg_inds = rng.choice(fg_inds, size=n_fg, replace=False)

    n_bg = rois_per_image - n_fg
    bg_inds = []
    for k in range(1, num_classes):
        bg_inds.extend(np.where(
            (labels == k) & (overlaps < cfg.TRAIN.BG_THRESH_HI)
            & (overlaps >= cfg.TRAIN.BG_THRESH_LO))[0])
    if len(bg_inds) < n_bg:
        for k in range(1, num_classes):
            bg_inds.extend(np.where(
                (labels == k) & (overlaps < cfg.TRAIN.BG_THRESH_HI))[0])
    if len(bg_inds) < n_bg:
        bg_inds.extend(np.where(overlaps < cfg.TRAIN.BG_THRESH_HI)[0])
    bg_inds = np.asarray(bg_inds, np.int64)
    n_bg = int(min(n_bg, bg_inds.size))
    if bg_inds.size > 0:
        bg_inds = rng.choice(bg_inds, size=n_bg, replace=False)

    keep = np.append(fg_inds, bg_inds).astype(np.int64)
    labels = labels[keep]
    labels[n_fg:] = 0
    targets, weights = _expand_bbox_labels(entry["bbox_targets"][keep],
                                           num_classes)
    return labels, overlaps[keep], rois[keep], targets, weights


def get_minibatch_multiscale(entries, num_classes, rng=None):
    """IS_MULTISCALE minibatch (minibatch2.py:16-96, non-RPN branch):
    pyramid blob + sampled rois with (level-aware batch index, x1..y2),
    labels, expanded bbox targets/weights."""
    rng = rng or np.random.RandomState()
    n = len(entries)
    assert cfg.TRAIN.BATCH_SIZE % n == 0
    rois_per_image = cfg.TRAIN.BATCH_SIZE // n
    fg_per_image = int(round(cfg.TRAIN.FG_FRACTION * rois_per_image))

    blob, _ = get_image_blob_multiscale(entries)
    # ROIs project to the SCALES_BASE pyramid levels actually present in
    # the blob (minibatch2.py:66-68 non-extrapolating branch). The
    # IS_EXTRAPOLATING variant maps to virtual scales via the SubCNN
    # SCALE_MAPPING machinery whose config keys the reference itself
    # ships commented out (lib/fast_rcnn/config.py:51-56) — waived.
    scales = cfg.TRAIN.SCALES_BASE
    num_levels = len(scales)

    rois_blob = np.zeros((0, 5), np.float32)
    labels_blob = np.zeros((0,), np.float32)
    targets_blob = np.zeros((0, 4 * num_classes), np.float32)
    weights_blob = np.zeros_like(targets_blob)
    for i, entry in enumerate(entries):
        labels, _, im_rois, targets, weights = sample_rois(
            entry, fg_per_image, rois_per_image, num_classes, rng)
        rois, levels = project_im_rois_multiscale(im_rois, scales)
        batch_ind = i * num_levels + levels
        rois_blob = np.vstack(
            [rois_blob, np.hstack([batch_ind, rois]).astype(np.float32)])
        labels_blob = np.hstack([labels_blob, labels])
        targets_blob = np.vstack([targets_blob, targets])
        weights_blob = np.vstack([weights_blob, weights])

    return {
        "data": blob,
        "rois": rois_blob,
        "labels": labels_blob,
        "bbox_targets": targets_blob,
        "bbox_inside_weights": weights_blob,
        "bbox_outside_weights": (weights_blob > 0).astype(np.float32),
    }


def prepare_gt_roidb(imdb, scales=None, scale_mapping=None,
                     fg_thresh=None):
    """Attach per-image `info_boxes` (N, 18) rows — the gt_data_layer
    roidb math (lib/gt_data_layer/roidb.py:22-92): for each pyramid
    scale, rate the SubCNN grid boxes (boxes_grid.get_boxes_grid)
    against the scale-rescaled gt, keep grid cells whose max-overlap
    class clears FG_THRESH, and record

      (cx, cy, scale_ind, grid box, scale_ind_map, mapped box,
       gt_label, gt_sublabel[unset->0], 0, regression target)

    columns 0..17 exactly as roidb.py:76-87 lays them out (col 13 is
    never written there either). scales/scale_mapping default to the
    cfg.TRAIN.SCALES / SCALE_MAPPING keys when present (the reference
    ships them commented out, config.py:47-56). No pkl caching here —
    the repo's roidbs are cheap to recompute and tests patch cfg."""
    from mv3d_tf_tpu_torch.data.boxes_grid import get_boxes_grid
    from mv3d_tf_tpu_torch.data.imdb_base import bbox_overlaps
    from PIL import Image

    scales = tuple(scales if scales is not None
                   else getattr(cfg.TRAIN, "SCALES", (1.0,)))
    scale_mapping = tuple(scale_mapping if scale_mapping is not None
                          else getattr(cfg.TRAIN, "SCALE_MAPPING",
                                       tuple(range(len(scales)))))
    fg_thresh = cfg.TRAIN.FG_THRESH if fg_thresh is None else fg_thresh

    roidb = imdb.roidb
    for i in range(len(imdb.image_index)):
        roidb[i]["image"] = imdb.image_path_at(i)
        boxes = roidb[i]["boxes"]
        labels = roidb[i]["gt_classes"]
        info_boxes = np.zeros((0, 18), np.float32)
        if boxes.shape[0] == 0:
            roidb[i]["info_boxes"] = info_boxes
            continue
        with Image.open(imdb.image_path_at(i)) as im:
            image_width, image_height = im.size
        boxes_grid, cx, cy = get_boxes_grid(image_height, image_width)
        for scale_ind, scale in enumerate(scales):
            boxes_rescaled = boxes * scale
            overlaps = np.asarray(bbox_overlaps(
                boxes_grid.astype(np.float32),
                boxes_rescaled.astype(np.float32)))
            max_overlaps = overlaps.max(axis=1)
            argmax_overlaps = overlaps.argmax(axis=1)
            max_classes = labels[argmax_overlaps]
            fg_inds = []
            for k in range(1, imdb.num_classes):
                fg_inds.extend(np.where((max_classes == k)
                                        & (max_overlaps >= fg_thresh))[0])
            if len(fg_inds) > 0:
                fg_inds = np.asarray(fg_inds, np.int64)
                gt_inds = argmax_overlaps[fg_inds]
                gt_targets = compute_bbox_targets(
                    boxes_grid[fg_inds].astype(np.float64),
                    boxes_rescaled[gt_inds].astype(np.float64))
                scale_ind_map = scale_mapping[scale_ind]
                scale_map = scales[scale_ind_map]
                info_box = np.zeros((len(fg_inds), 18), np.float32)
                info_box[:, 0] = cx[fg_inds]
                info_box[:, 1] = cy[fg_inds]
                info_box[:, 2] = scale_ind
                info_box[:, 3:7] = boxes_grid[fg_inds]
                info_box[:, 7] = scale_ind_map
                info_box[:, 8:12] = boxes_grid[fg_inds] * scale_map / scale
                info_box[:, 12] = labels[gt_inds]
                info_box[:, 14:] = gt_targets
                info_boxes = np.vstack((info_boxes, info_box))
        roidb[i]["info_boxes"] = info_boxes
    return roidb


def add_info_boxes_regression_targets(roidb):
    """Normalize info_boxes regression targets (cols 14:18) by per-class
    (col 12) means/stds — gt_data_layer/roidb.py:96-131 incl. its
    quirks: E(x^2)-E(x)^2 std, and the zero-std guard checks ONLY
    coordinate 0 before dividing the whole row (:127-128). Returns
    (means.ravel(), stds.ravel()) for prediction unnormalization."""
    assert len(roidb) > 0 and "info_boxes" in roidb[0], \
        "call prepare_gt_roidb first"
    num_classes = roidb[0]["gt_overlaps"].shape[1]
    class_counts = np.zeros((num_classes, 1)) + cfg.EPS
    sums = np.zeros((num_classes, 4))
    squared_sums = np.zeros((num_classes, 4))
    for entry in roidb:
        t = entry["info_boxes"]
        for k in range(1, num_classes):
            idx = np.where(t[:, 12] == k)[0]
            if idx.size:
                class_counts[k] += idx.size
                sums[k] += t[idx, 14:].sum(axis=0)
                squared_sums[k] += (t[idx, 14:] ** 2).sum(axis=0)
    means = sums / class_counts
    stds = np.sqrt(np.maximum(squared_sums / class_counts - means ** 2,
                              0.0))
    for entry in roidb:
        t = entry["info_boxes"]
        for k in range(1, num_classes):
            idx = np.where(t[:, 12] == k)[0]
            t[idx, 14:] -= means[k]
            if stds[k, 0] != 0:            # coord-0-only guard, :127
                t[idx, 14:] /= stds[k]
    return means.ravel(), stds.ravel()


def get_minibatch_gt(entries, scales=None, scale_mapping=None,
                     aspects=None, aspect_heights=None,
                     aspect_widths=None):
    """gt_data_layer minibatch (lib/gt_data_layer/minibatch.py:16-57):
    image-pyramid blob + info_boxes blob (batch index shifted into cols
    2 and 7 by image slot * num_scale) + the flat parameters blob
    [num_scale, num_aspect, SCALES, SCALE_MAPPING, ASPECT_HEIGHTS,
    ASPECT_WIDTHS]. The reference shifts the roidb's info_boxes rows IN
    PLACE (minibatch.py:33-35 — indices compound across epochs); here
    the rows are copied first, deliberately."""
    scales = tuple(scales if scales is not None
                   else getattr(cfg.TRAIN, "SCALES", (1.0,)))
    scale_mapping = tuple(scale_mapping if scale_mapping is not None
                          else getattr(cfg.TRAIN, "SCALE_MAPPING",
                                       tuple(range(len(scales)))))
    aspects = tuple(aspects if aspects is not None
                    else getattr(cfg.TRAIN, "ASPECTS",
                                 (1, 0.75, 0.5, 0.25)))
    aspect_heights = tuple(
        aspect_heights if aspect_heights is not None
        else getattr(cfg.TRAIN, "ASPECT_HEIGHTS", (1.0,) * len(aspects)))
    aspect_widths = tuple(
        aspect_widths if aspect_widths is not None
        else getattr(cfg.TRAIN, "ASPECT_WIDTHS", (1.0,) * len(aspects)))

    im_blob, _ = get_image_blob_multiscale(entries)
    num_scale = len(scales)
    info_boxes_blob = np.zeros((0, 18), np.float32)
    for i, entry in enumerate(entries):
        info_boxes = entry["info_boxes"].copy()
        info_boxes[:, 2] += i * num_scale
        info_boxes[:, 7] += i * num_scale
        info_boxes_blob = np.vstack((info_boxes_blob, info_boxes))

    num_aspect = len(aspects)
    num = 2 + 2 * num_scale + 2 * num_aspect
    parameters_blob = np.zeros((num,), np.float32)
    parameters_blob[0] = num_scale
    parameters_blob[1] = num_aspect
    parameters_blob[2:2 + num_scale] = scales
    parameters_blob[2 + num_scale:2 + 2 * num_scale] = scale_mapping
    parameters_blob[2 + 2 * num_scale:
                    2 + 2 * num_scale + num_aspect] = aspect_heights
    parameters_blob[2 + 2 * num_scale + num_aspect:] = aspect_widths

    return {"data": im_blob, "info_boxes": info_boxes_blob,
            "parameters": parameters_blob}


def pad_minibatch_multiscale(blobs, bucket_hw, rois_per_batch=None):
    """Pad the variable-shape multiscale blobs to the fixed shapes the
    Fast R-CNN step (faster_rcnn_2d.build_fast_rcnn_train_step)
    expects; adds a roi_valid mask for padded roi slots."""
    rois_per_batch = rois_per_batch or cfg.TRAIN.BATCH_SIZE
    n_levels, h, w = blobs["data"].shape[:3]
    data = np.zeros((n_levels, bucket_hw[0], bucket_hw[1], 3), np.float32)
    data[:, :min(h, bucket_hw[0]), :min(w, bucket_hw[1])] = \
        blobs["data"][:, :bucket_hw[0], :bucket_hw[1]]
    n = len(blobs["rois"])
    assert n <= rois_per_batch
    k = 4 * (blobs["bbox_targets"].shape[1] // 4)
    out = {
        "data": data,
        "rois": np.zeros((rois_per_batch, 5), np.float32),
        "labels": np.zeros((rois_per_batch,), np.int32),
        "bbox_targets": np.zeros((rois_per_batch, k), np.float32),
        "bbox_inside_weights": np.zeros((rois_per_batch, k), np.float32),
        "bbox_outside_weights": np.zeros((rois_per_batch, k), np.float32),
        "roi_valid": np.zeros((rois_per_batch,), bool),
    }
    out["rois"][:n] = blobs["rois"]
    out["labels"][:n] = blobs["labels"].astype(np.int32)
    out["bbox_targets"][:n] = blobs["bbox_targets"]
    out["bbox_inside_weights"][:n] = blobs["bbox_inside_weights"]
    out["bbox_outside_weights"][:n] = blobs["bbox_outside_weights"]
    out["roi_valid"][:n] = True
    return out
