"""RPN proposal generation (mv3d_tf_tpu/rpn_generate.py, the reference's
lib/rpn_msr/generate.py:76-131): the legacy 2D net's trunk, RPN and
proposal layer over every image of an imdb, the proposals returned in the
original image's coordinates with their scores: stage 1 of
py-faster-rcnn's alternating recipe.

The RPN runs on the params' device at a static padding bucket with a fixed
number of post-NMS slots and a validity mask; the unprojection by the
scale (generate.py:100-101) happens on the host, per image.
"""

import functools

import numpy as np
import torch

from mv3d_tf_tpu_torch.config import cfg


@functools.lru_cache(maxsize=4)
def _build_rpn_only(feat_h, feat_w, pre_nms_top_n, post_nms_top_n,
                    compute_dtype=None):
    """rpn_forward(params, image, im_info) -> rois (P,5), scores (P,),
    valid (P,) at TEST.RPN_NMS_THRESH and TEST.RPN_MIN_SIZE
    (rpn_generate.py:29-46)."""
    from mv3d_tf_tpu_torch.faster_rcnn_2d import proposal_layer_2d
    from mv3d_tf_tpu_torch.models import mv3d, vggnet

    @torch.inference_mode()
    def rpn_forward(params, image, im_info):
        dev = next(params.parameters()).device
        image = torch.as_tensor(image, dtype=torch.float32, device=dev)
        im_info = torch.as_tensor(im_info, dtype=torch.float32, device=dev)
        c5 = vggnet.trunk_apply_2d(params, image[None], dtype=compute_dtype)
        cls, box = vggnet.rpn_head_2d(params, c5, dtype=compute_dtype)
        return proposal_layer_2d(
            mv3d.rpn_probs(cls), box.float(), im_info, feat_h, feat_w,
            pre_nms_top_n=pre_nms_top_n, post_nms_top_n=post_nms_top_n,
            nms_thresh=cfg.TEST.RPN_NMS_THRESH,
            min_size=cfg.TEST.RPN_MIN_SIZE)

    return rpn_forward


def im_proposals(params, im_bgr, bucket_hw=(608, 1024),
                 pre_nms_top_n=None, post_nms_top_n=None,
                 compute_dtype=None):
    """Proposals for one BGR float32 image (rpn_generate.py:49-82,
    generate.py:76-101): mean-subtract, scale by TEST.SCALES_BASE[0] (each
    channel by Pillow's mode-F bilinear), pad to the bucket, run the RPN,
    divide the boxes back by the scale. Returns (boxes (N,4), scores (N,1))
    as numpy."""
    assert len(cfg.TEST.SCALES_BASE) == 1  # generate.py:63
    scale = float(cfg.TEST.SCALES_BASE[0])
    pre = pre_nms_top_n or cfg.TEST.RPN_PRE_NMS_TOP_N
    post = post_nms_top_n or cfg.TEST.RPN_POST_NMS_TOP_N

    im = im_bgr.astype(np.float32) - cfg.PIXEL_MEANS.reshape(1, 1, 3)
    if scale != 1.0:
        from PIL import Image
        h = int(round(im.shape[0] * scale))
        w = int(round(im.shape[1] * scale))
        im = np.stack([np.asarray(Image.fromarray(im[:, :, c]).resize(
            (w, h), Image.BILINEAR)) for c in range(3)], axis=2)
    h = min(im.shape[0], bucket_hw[0])
    w = min(im.shape[1], bucket_hw[1])
    padded = np.zeros((bucket_hw[0], bucket_hw[1], 3), np.float32)
    padded[:h, :w] = im[:h, :w]
    im_info = np.array([h, w, scale], np.float32)

    fwd = _build_rpn_only(bucket_hw[0] // 16, bucket_hw[1] // 16, pre, post,
                          compute_dtype)
    rois, scores, valid = (t.cpu().numpy()
                           for t in fwd(params, padded, im_info))
    return rois[valid, 1:5] / scale, scores[valid, None]


def imdb_proposals(params, imdb, log=print, **kw):
    """im_proposals over every image of an imdb (generate.py:103-111): a
    list of (N_i, 4) boxes."""
    from mv3d_tf_tpu_torch.data.loader import load_image_bgr
    from mv3d_tf_tpu_torch.utils.timer import Timer

    t = Timer()
    out = []
    for i in range(imdb.num_images):
        im = load_image_bgr(imdb.image_path_at(i))
        t.tic()
        boxes, _ = im_proposals(params, im, **kw)
        t.toc()
        out.append(boxes)
        if log:
            log("im_proposals: {:d}/{:d} {:.3f}s".format(
                i + 1, imdb.num_images, t.average_time))
    return out


def imdb_proposals_det(params, imdb, log=print, **kw):
    """As imdb_proposals, with (N_i, 5) [x1,y1,x2,y2,score] float32 rows
    (generate.py:113-131)."""
    from mv3d_tf_tpu_torch.data.loader import load_image_bgr

    out = []
    for i in range(imdb.num_images):
        boxes, scores = im_proposals(
            params, load_image_bgr(imdb.image_path_at(i)), **kw)
        out.append(np.hstack([boxes, scores]).astype(np.float32))
        if log:
            log("im_proposals: {:d}/{:d}".format(i + 1, imdb.num_images))
    return out
