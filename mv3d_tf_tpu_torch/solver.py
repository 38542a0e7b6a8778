"""The full-dataset evaluation loop (mv3d_tf_tpu/solver.py:236-437, the
reference's lib/fast_rcnn/test_mv.py:321-517): batched detection over an
imdb, per-class threshold and NMS, the top-300 cap, the detections pickles
and the KITTI result writing and AP.

A prefetch thread loads each batch from disk and copies it to the device
on a side stream while the previous batch computes; the previous batch's
host post-processing overlaps the current batch's device work. With a
``quant_cfg`` it calibrates the int8 detector on the first frames
of the split (the accuracy gate with the same flags is tools/quant_check).
``train_net`` belongs to the training loop and waits for it (ROADMAP.md,
Queue 1 item 8).
"""

import os
import pickle
import queue
import threading

import numpy as np
import torch

from mv3d_tf_tpu_torch.config import cfg, get_output_dir
from mv3d_tf_tpu_torch.data.loader import load_image_bgr, pad_image
from mv3d_tf_tpu_torch.eval import build_detect_batch_fn, frame_detections
from mv3d_tf_tpu_torch.utils.timer import Timer

_DET_KEYS = ("scores", "boxes_bv", "boxes_cnr", "boxes_cnr_r", "valid")


def _load_eval_frame(imdb, i, image_dtype=np.float32):
    """Frame i of the imdb: (padded BGR image, BEV raster float32, calib)."""
    image = pad_image(load_image_bgr(imdb.image_path_at(i))).astype(
        image_dtype)
    bev = np.load(imdb.lidar_path_at(i)).astype(np.float32)
    return image, bev, np.asarray(imdb.calib_at(i), np.float32)


def _numpy(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _params_device(params):
    return (next(params.parameters()).device if params is not None
            else torch.device("cpu"))


def _to_device(host, device):
    """Host tensors -> tensors on device. On a card the copies go through
    pinned memory on a side stream; returns the tensors and an event that
    marks their arrival (None on the CPU)."""
    if device.type != "cuda":
        return [t.to(device) for t in host], None
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        out = [t.pin_memory().to(device, non_blocking=True) for t in host]
        ready = torch.cuda.Event()
        ready.record(stream)
    return out, ready


def _wait(ready, tensors):
    """Make the current stream wait for a side-stream copy, and keep its
    tensors' memory from reuse until the current stream is done with them."""
    if ready is None:
        return
    stream = torch.cuda.current_stream(tensors[0].device)
    stream.wait_event(ready)
    for t in tensors:
        t.record_stream(stream)


def _build_detector(params, imdb, indices, compute_dtype, quant_cfg, log):
    """The batched detector at the TEST config's proposal budget; with a
    quant_cfg, the int8 detector calibrated on the first calib_frames
    frames (solver.py:327-356)."""
    qs, q_kwargs = None, {}
    if quant_cfg is not None:
        from mv3d_tf_tpu_torch import quant as Q
        from mv3d_tf_tpu_torch.eval import PIXEL_MEANS
        qc = dict(quant_cfg)
        n_cal = int(qc.pop("calib_frames", 8))
        frames = [_load_eval_frame(imdb, i)
                  for i in indices[:max(1, min(n_cal, len(indices)))]]
        cb = np.stack([f[1] for f in frames])
        ci = np.stack([f[0] for f in frames]) - PIXEL_MEANS
        cc = np.stack([f[2] for f in frames])
        pool_bv = pool_img = None
        if qc.pop("int8_head", False):
            pool_bv, pool_img = Q.calibrate_pooled_features(params, cb, ci,
                                                            cc)
        log("int8 calibration on {} frames".format(len(cb)))
        qs = Q.build_quant_state(params, cb, ci, pooled_bv=pool_bv,
                                 pooled_img=pool_img)
        q_kwargs = {"quant_conv_impl": qc.pop("conv_impl", "xla"),
                    "stem_impl": qc.pop("stem", None)}
    return build_detect_batch_fn(
        pre_nms_top_n=cfg.TEST.RPN_PRE_NMS_TOP_N,
        post_nms_top_n=cfg.TEST.RPN_POST_NMS_TOP_N,
        rpn_nms_thresh=cfg.TEST.RPN_NMS_THRESH,
        compute_dtype=compute_dtype, quant=qs, **q_kwargs)


def test_net(params, imdb, weights_filename="default", max_per_image=300,
             thresh=0.05, compute_dtype=None, log=print, detect_fn=None,
             evaluate=True, batch_size=8, quant_cfg=None):
    """Evaluate over an imdb; returns (all_boxes, all_boxes_cnr).

    all_boxes[cls][image] = (N,5) BEV detections, all_boxes_cnr[cls][image]
    = (N,25) corner detections (test_mv.py:321-517), all_boxes_cnr_r the
    regressed corners. The device path is eval.build_detect_batch_fn on the
    params' device at batch_size frames a call (the tail batch padded with
    its last frame); its "nms_converged" certificate must hold on every
    frame, or test_net raises. quant_cfg {"stem", "conv_impl",
    "int8_head", "calib_frames"} runs the int8 detector after calibrating
    it on the first frames. detect_fn injects a per-frame detector
    (tests), run one frame at a time on CPU tensors or the params' device;
    evaluate=False skips the pickles and the AP.
    """
    num_images = imdb.num_images
    k = imdb.num_classes
    all_boxes = [[[] for _ in range(num_images)] for _ in range(k)]
    all_boxes_cnr = [[[] for _ in range(num_images)] for _ in range(k)]
    all_boxes_cnr_r = [[[] for _ in range(num_images)] for _ in range(k)]
    output_dir = get_output_dir(imdb, weights_filename)
    device = _params_device(params)
    indices = list(range(num_images))

    def drain(chunk, det):
        """Per-class NMS and slot assignment for one finished batch."""
        det = {key: _numpy(v) for key, v in det.items()}
        if "nms_converged" in det:
            conv = det["nms_converged"][:len(chunk)]
            if not conv.all():
                raise RuntimeError(
                    "blocked_fixed NMS certificate failed on frames "
                    "{} of batch {}".format(
                        [chunk[i] for i in np.where(~conv)[0]], chunk))
        for bi, i in enumerate(chunk):
            one = {key: det[key][bi] for key in _DET_KEYS}
            per_cls = frame_detections(one, num_classes=k,
                                       score_thresh=thresh,
                                       nms_thresh=cfg.TEST.NMS,
                                       max_per_image=max_per_image)
            for j, (dets_bv, dets_cnr, dets_cnr_r) in per_cls.items():
                all_boxes[j][i] = dets_bv
                all_boxes_cnr[j][i] = dets_cnr
                all_boxes_cnr_r[j][i] = dets_cnr_r

    timer = Timer()
    if detect_fn is not None:
        for n, i in enumerate(indices):
            image, bev, calib = _load_eval_frame(imdb, i)
            timer.tic()
            det = detect_fn(params, *(torch.from_numpy(a).to(device)
                                      for a in (bev, image, calib)))
            drain([i], {key: _numpy(v)[None] for key, v in det.items()})
            timer.toc()
            log("im_detect: {:d}/{:d} {:.3f}s".format(
                n + 1, len(indices), timer.average_time))
    elif indices:
        B = max(1, min(batch_size, len(indices)))
        detect_batch = _build_detector(params, imdb, indices, compute_dtype,
                                       quant_cfg, log)
        nb = -(-len(indices) // B)
        q = queue.Queue(maxsize=2)
        # images travel as their uint8 pixels and, under bf16 compute, the
        # BEV as bf16 (the trunks' first act is the same cast)
        bev_bf16 = compute_dtype == torch.bfloat16

        def producer():
            try:
                for b in range(nb):
                    chunk = indices[b * B:(b + 1) * B]
                    frames = [_load_eval_frame(imdb, i, image_dtype=np.uint8)
                              for i in chunk]
                    while len(frames) < B:      # pad the tail batch
                        frames.append(frames[-1])
                    images, bevs, calibs = (
                        torch.from_numpy(np.stack([f[j] for f in frames]))
                        for j in range(3))
                    if bev_bf16:
                        bevs = bevs.to(torch.bfloat16)
                    q.put((chunk, *_to_device([images, bevs, calibs],
                                              device)))
                q.put(None)
            except BaseException as e:          # propagate to the consumer
                q.put(e)

        threading.Thread(target=producer, daemon=True).start()
        pending = None
        done = 0
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            if item is None:
                break
            chunk, (images, bevs, calibs), ready = item
            _wait(ready, (images, bevs, calibs))
            timer.tic()
            det = detect_batch(params, bevs, images, calibs)
            if pending is not None:
                drain(*pending)     # overlaps this batch's device work
            pending = (chunk, det)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timer.toc()
            done += len(chunk)
            log("im_detect: {:d}/{:d} {:.3f}s/batch{}".format(
                done, len(indices), timer.average_time, B))
        if pending is not None:
            drain(*pending)

    if not evaluate:
        return all_boxes, all_boxes_cnr

    os.makedirs(output_dir, exist_ok=True)
    for name, boxes in (("detections.pkl", all_boxes),
                        ("detections_cnr.pkl", all_boxes_cnr),
                        ("detections_cnr_r.pkl", all_boxes_cnr_r)):
        with open(os.path.join(output_dir, name), "wb") as f:
            pickle.dump(boxes, f, pickle.HIGHEST_PROTOCOL)

    log("Evaluating detections")
    imdb.evaluate_detections(all_boxes, all_boxes_cnr, output_dir,
                             all_boxes_cnr_r=all_boxes_cnr_r)
    return all_boxes, all_boxes_cnr
