"""The legacy 2D Faster R-CNN demo on one image: the counterpart of
tools/demo.py, with the same flags and ``--device``/``--dtype``.

    python -m mv3d_tf_tpu_torch.tools.demo --image <img.jpg> \\
        [--weights w.npy] [--out <dir>] [--device cuda|cpu] \\
        [--dtype bfloat16|float32] [--conf 0.8] [--nms 0.3] [--bucket 608 800]

Pads the mean-subtracted image (unscaled) into the static bucket, runs
faster_rcnn_2d.build_im_detect_2d (VGG16, 20 VOC classes; pre-NMS 6000,
post-NMS 300) on the card (``--device cpu`` for the plain versions on the
CPU), keeps each class's detections above ``--conf`` after host NMS at
``--nms``, and writes ``<image name>_det.png`` with their boxes.
``--weights`` takes a reference-style .npy weight dict or a snapshot of
tools.train_net; without it the random init (vggnet.init_params_2d from a
generator seeded 0) stands in.
"""

import argparse
import os
import os.path as osp
import sys
import tempfile
import time

import numpy as np

CLASSES = ("__background__",
           "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
           "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
           "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor")


def build_parser():
    p = argparse.ArgumentParser(description="Faster R-CNN 2D demo")
    p.add_argument("--image", required=True)
    p.add_argument("--weights", dest="model", default=None)
    p.add_argument("--out", default=osp.join(tempfile.gettempdir(),
                                             "frcnn_demo"))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--conf", type=float, default=0.8)
    p.add_argument("--nms", type=float, default=0.3)
    p.add_argument("--bucket", type=int, nargs=2, default=(608, 800),
                   help="static H W padding bucket (multiple of 16)")
    return p


def main(argv=None):
    """Run the demo; returns (the PNG's path, detections per class)."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    import torch
    from PIL import Image

    from mv3d_tf_tpu_torch.data.loader import load_image_bgr
    from mv3d_tf_tpu_torch.eval import PIXEL_MEANS
    from mv3d_tf_tpu_torch.faster_rcnn_2d import build_im_detect_2d
    from mv3d_tf_tpu_torch.models import vggnet
    from mv3d_tf_tpu_torch.ops.nms import nms_np
    from mv3d_tf_tpu_torch.utils.checkpoint import load_pretrained
    from mv3d_tf_tpu_torch.utils.draw import show_image_boxes

    device = torch.device(args.device)
    os.makedirs(args.out, exist_ok=True)
    img_raw = load_image_bgr(args.image)
    H, W = args.bucket
    image = np.zeros((H, W, 3), np.float32)
    h, w = min(img_raw.shape[0], H), min(img_raw.shape[1], W)
    image[:h, :w] = img_raw[:h, :w] - PIXEL_MEANS
    im_info = np.array([h, w, 1.0], np.float32)

    params = vggnet.init_params_2d(
        torch.Generator(device=device).manual_seed(0), device=device)
    if args.model:
        load_pretrained(params, args.model)
    detect = build_im_detect_2d(
        H // 16, W // 16,
        compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else None)
    t0 = time.time()
    out = {k: v.cpu().numpy() for k, v in
           detect(params, image, im_info).items()}
    print("Detection took {:.3f}s".format(time.time() - t0))

    scores, boxes, valid = out["scores"], out["boxes"], out["valid"]
    vis = img_raw[:, :, ::-1].astype(np.uint8)
    counts = {}
    for j, cls in enumerate(CLASSES[1:], start=1):
        inds = np.where(valid & (scores[:, j] > args.conf))[0]
        if len(inds) == 0:
            continue
        dets = np.hstack([boxes[inds, 4 * j:4 * (j + 1)],
                          scores[inds, j:j + 1]]).astype(np.float32)
        dets = dets[nms_np(dets, args.nms)]
        counts[cls] = len(dets)
        print("{}: {} detections".format(cls, len(dets)))
        vis = show_image_boxes(vis, dets[:, :4])
    out_path = osp.join(args.out, osp.splitext(
        osp.basename(args.image))[0] + "_det.png")
    Image.fromarray(np.asarray(vis)).save(out_path)
    print("{} total detections -> {}".format(sum(counts.values()), out_path))
    return out_path, counts


if __name__ == "__main__":
    main()
