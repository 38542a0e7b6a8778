"""The training loop and the full-dataset evaluation loop
(mv3d_tf_tpu/solver.py).

``train_net`` (solver.py:69-233, the reference's train_mv.py:87-219): the
single-frame train step over an epoch-permuted roidb, fed from a
card-resident copy of the train set when it fits (bf16 BEV, uint8 image)
or by a host prefetch thread; Adam with the optional staircase LR decay as
a torch scheduler; the reference's display and snapshot cadence; resume
from the latest snapshot with Adam's and the scheduler's state; an optional
torch.profiler trace of three iterations.

``test_net`` (solver.py:236-437, the reference's test_mv.py:321-517):
batched detection over an imdb, per-class threshold and NMS, the top-300
cap, the detections pickles and the KITTI result writing and AP.

``train_net_2d``, ``train_net_fast_rcnn`` and ``test_net_2d``
(solver.py:440-668) are the legacy 2D Faster R-CNN's loops: training with
momentum SGD, end to end or (HAS_RPN off) Fast R-CNN over precomputed
proposals on an image pyramid, and the VOC or KITTI-2D evaluation.

A prefetch thread loads each batch from disk and copies it to the device
on a side stream while the previous batch computes; the previous batch's
host post-processing overlaps the current batch's device work. With a
``quant_cfg`` it calibrates the int8 detector on the first frames
of the split (the accuracy gate with the same flags is tools/quant_check).
"""

import os
import pickle
import queue
import threading
import time

import numpy as np
import torch

from mv3d_tf_tpu_torch import train
from mv3d_tf_tpu_torch.config import cfg, get_output_dir
from mv3d_tf_tpu_torch.data.loader import (RoIDataLayer, get_minibatch,
                                           load_image_bgr, pad_image)
from mv3d_tf_tpu_torch.eval import build_detect_batch_fn, frame_detections
from mv3d_tf_tpu_torch.models import mv3d
from mv3d_tf_tpu_torch.ops.nms import nms_np
from mv3d_tf_tpu_torch.utils.checkpoint import (latest_snapshot,
                                                load_checkpoint,
                                                load_pretrained,
                                                save_checkpoint,
                                                snapshot_iter)
from mv3d_tf_tpu_torch.utils.timer import Timer

LR = 1e-5               # the MV3D Adam lr (train.build_train_step's)
FEAT = 75               # the train step's stride-8 BEV feature map side
KEEP_PROB = 0.5         # the fusion head's dropout keep rate


def _build_device_dataset(roidb, device, log=print):
    """The whole roidb stacked on ``device`` for train.build_train_step_cached
    (solver.py:27-66): bev as bfloat16 (the bf16 trunk's first act is that
    cast), image as uint8 (raw pixels are integers), the rest as loaded.
    Returns None when the estimate exceeds cfg.TPU.TRAIN_DATA_HBM_GB; the
    caller then feeds frames from the host."""
    n = len(roidb)
    b0 = get_minibatch(roidb[0])
    keys = train.BATCH_KEYS
    per_frame = (b0["bev"].size * 2 + b0["image"].size
                 + sum(b0[k].size * 4 for k in keys[2:-1])
                 + b0["gt_valid"].size)
    total = n * per_frame
    budget = float(cfg.TPU.TRAIN_DATA_HBM_GB) * (1 << 30)
    if total > budget:
        log("device dataset {} frames = {:.1f} GiB > budget {:.1f} GiB; "
            "feeding from the host".format(n, total / (1 << 30),
                                           budget / (1 << 30)))
        return None
    log("pinning {} train frames on device ({:.2f} GiB)...".format(
        n, total / (1 << 30)))
    host = {"bev": torch.empty((n,) + b0["bev"].shape, dtype=torch.bfloat16),
            "image": torch.empty((n,) + b0["image"].shape,
                                 dtype=torch.uint8)}
    for k in keys[2:]:
        host[k] = torch.empty((n,) + b0[k].shape,
                              dtype=torch.from_numpy(b0[k]).dtype)
    for i in range(n):
        b = b0 if i == 0 else get_minibatch(roidb[i])
        host["bev"][i] = torch.from_numpy(b["bev"])
        host["image"][i] = torch.from_numpy(b["image"])
        for k in keys[2:]:
            host[k][i] = torch.from_numpy(b[k])
    t0 = time.time()
    data = {k: v.to(device) for k, v in host.items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log("device dataset ready ({:.1f}s transfer)".format(time.time() - t0))
    return data


def _lr_scheduler(opt, start_iter):
    """cfg.TRAIN.LR_DECAY's staircase, optax.exponential_decay(1e-5, STEPSIZE,
    GAMMA, staircase=True) (solver.py:114-126): the lr of the update after
    ``count`` updates is 1e-5 * GAMMA ** (count // STEPSIZE). Stepped once an
    iteration; built at start_iter, so a resumed run continues its lr."""
    step, gamma = int(cfg.TRAIN.STEPSIZE), float(cfg.TRAIN.GAMMA)
    for group in opt.param_groups:
        group["initial_lr"] = LR
    return torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: gamma ** (count // step), last_epoch=start_iter - 1)


def train_net(imdb, roidb, output_dir, pretrained_model=None,
              max_iters=10000, compute_dtype=None, seed=None,
              display=None, snapshot_iters=None, log=print,
              resume=False, trace_dir=None, device_data=None,
              device="cuda"):
    """Train MV3D on a roidb on ``device`` (the card unless the caller asks
    for the CPU); returns the params.

    The params start from mv3d.init_params with a generator seeded from
    ``seed`` (cfg.RNG_SEED if None), then ``pretrained_model`` (a .npy dict
    or a port snapshot). The same generator then gives each iteration's
    draws (train.make_draws). On a card with a compute dtype the train set
    is kept on the card (_build_device_dataset; ``device_data`` passes one
    built before, so that segmented drivers pin it once); otherwise frames
    come from the host with a prefetch of 2. resume=True restores the
    latest snapshot in output_dir: params, Adam and the LR scheduler; the
    draws and the epoch permutation restart from the seed, as the JAX
    package's do (solver.py:92-93, 175-176). trace_dir (or
    cfg.TRAIN.DEBUG_TIMELINE, under output_dir/traces) records a
    torch.profiler Chrome trace of iterations start+2 to start+4.
    """
    roidb = train.filter_roidb(roidb)
    display = cfg.TRAIN.DISPLAY if display is None else display
    snapshot_iters = (cfg.TRAIN.SNAPSHOT_ITERS if snapshot_iters is None
                      else snapshot_iters)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(
        cfg.RNG_SEED if seed is None else seed)
    params = mv3d.init_params(gen, device=device)
    if pretrained_model is not None:
        log("Loading pretrained model weights from {:s}".format(
            pretrained_model))
        load_pretrained(params, pretrained_model)

    if (device_data is None and device.type == "cuda"
            and compute_dtype is not None):
        device_data = _build_device_dataset(roidb, device, log)

    kw = dict(pre_nms_top_n=cfg.TRAIN.RPN_PRE_NMS_TOP_N,
              post_nms_top_n=cfg.TRAIN.RPN_POST_NMS_TOP_N,
              rpn_nms_thresh=cfg.TRAIN.RPN_NMS_THRESH,
              rois_per_image=cfg.TRAIN.BATCH_SIZE,
              compute_dtype=compute_dtype,
              stem_impl=(cfg.TPU.TRAIN_STEM or None))
    if device_data is not None:
        step, make_opt = train.build_train_step_cached(**kw)
    else:
        step, make_opt = train.build_train_step(**kw)
    opt = make_opt(params)

    snap = latest_snapshot(output_dir) if resume else None
    start_iter = 0 if snap is None else snapshot_iter(snap)
    sched = None
    if cfg.TRAIN.LR_DECAY:
        sched = _lr_scheduler(opt, start_iter)
        log("LR_DECAY on: 1e-5 * {}^(it // {})".format(
            cfg.TRAIN.GAMMA, cfg.TRAIN.STEPSIZE))
    if snap is not None:
        load_checkpoint(snap, params, opt, sched)
        log("Resumed from {} (iter {})".format(snap, start_iter))

    data_layer = RoIDataLayer(roidb, imdb.num_classes,
                              prefetch=0 if device_data is not None else 2)
    draw_args = (FEAT * FEAT * mv3d.NUM_ANCHORS,
                 cfg.TRAIN.RPN_POST_NMS_TOP_N + cfg.TPU.MAX_GT,
                 cfg.TRAIN.BATCH_SIZE, params["fc7_1"].weight.shape[0],
                 KEEP_PROB, device)

    if cfg.TRAIN.DEBUG_TIMELINE and trace_dir is None:
        trace_dir = os.path.join(output_dir, "traces")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def stop_trace(last):
        sync()
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "trace_iter_{}_{}.json".format(
            start_iter + 2, last))
        prof.export_chrome_trace(path)
        log("profiler trace written to " + path)

    timer = Timer()
    last_display_t = time.time()
    last_snapshot_iter = -1
    for it in range(start_iter, max_iters):
        if trace_dir is not None and it == start_iter + 2:
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        if prof is not None and it == start_iter + 5:
            stop_trace(it - 1)
            prof = None
        draws = train.make_draws(gen, *draw_args)
        if device_data is not None:
            # no sync per iteration: the loss read at display points syncs
            m = step(params, opt, device_data, int(data_layer.next_index()),
                     draws)
        else:
            blobs = data_layer.forward()
            timer.tic()
            m = step(params, opt, blobs, draws)
            sync()
            timer.toc()
        if sched is not None:
            sched.step()

        if (it + 1) % display == 0:
            log("iter: %d / %d, total loss: %.4f, rpn_loss_cls: %.4f, "
                "rpn_loss_box: %.4f, loss_cls: %.4f, loss_box: %.4f"
                % (it + 1, max_iters, m["loss"].item(),
                   m["rpn_cross_entropy"].item(), m["rpn_loss_box"].item(),
                   m["cross_entropy"].item(), m["loss_box"].item()))
            if device_data is not None:
                now = time.time()
                log("speed: {:.3f}s / iter".format(
                    (now - last_display_t) / display))
                last_display_t = now
            else:
                log("speed: {:.3f}s / iter".format(timer.average_time))

        if (it + 1) % snapshot_iters == 0:
            last_snapshot_iter = it
            save_checkpoint(output_dir, it + 1, params, opt, sched)

    if prof is not None:        # a short run can end before the stop
        stop_trace(max_iters - 1)
    if last_snapshot_iter != max_iters - 1:
        save_checkpoint(output_dir, max_iters, params, opt, sched)
    return params

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


def _batch_slots(indices, B):
    """The whole run's batches that indices meet, in order: frame i in row
    i mod B of batch i // B, None in the rows of frames not in indices. A
    frame takes its row of the single-process run in any shard: cuDNN's
    bf16 conv4_2 on the image view (B x 48x156x512) rounds a frame's
    outputs by the row it sits in, so a shard that packed its frames from
    row 0 would differ from the single run in the last bit."""
    batches = {}
    for i in indices:
        batches.setdefault(i // B, [None] * B)[i % B] = i
    return list(batches.values())


def test_net(params, imdb, weights_filename="default", max_per_image=300,
             thresh=0.05, compute_dtype=None, log=print, frame_indices=None,
             detect_fn=None, evaluate=True, batch_size=8, quant_cfg=None,
             return_cnr_r=False):
    """Evaluate over an imdb; returns (all_boxes, all_boxes_cnr), and
    all_boxes_cnr_r third with return_cnr_r (tools/accuracy_eval scores
    the regressed corners).

    all_boxes[cls][image] = (N,5) BEV detections, all_boxes_cnr[cls][image]
    = (N,25) corner detections (test_mv.py:321-517), all_boxes_cnr_r the
    regressed corners. The device path is eval.build_detect_batch_fn on the
    params' device at batch_size frames a call (the tail batch padded with
    its last frame); its "nms_converged" certificate must hold on every
    frame, or test_net raises. quant_cfg {"stem", "conv_impl",
    "int8_head", "calib_frames"} runs the int8 detector after calibrating
    it on the first frames. detect_fn injects a per-frame detector
    (tests), run one frame at a time on CPU tensors or the params' device;
    evaluate=False skips the pickles and the AP. frame_indices restricts
    the loop to those frames (a host's shard, parallel/multihost.py): the
    slots of other frames stay empty. Each call takes the whole run's batch
    size, each frame in its row of the whole run's batch (_batch_slots), the
    other rows a neighbour frame, so a frame's bytes do not depend on the
    shard that served it.
    """
    num_images = imdb.num_images
    k = imdb.num_classes
    all_boxes = [[[] for _ in range(num_images)] for _ in range(k)]
    all_boxes_cnr = [[[] for _ in range(num_images)] for _ in range(k)]
    all_boxes_cnr_r = [[[] for _ in range(num_images)] for _ in range(k)]
    output_dir = get_output_dir(imdb, weights_filename)
    device = _params_device(params)
    indices = (list(range(num_images)) if frame_indices is None
               else list(frame_indices))

    def drain(slots, det):
        """Per-class NMS and slot assignment for one finished batch; slots
        holds each batch row's frame, None for a padding row."""
        det = {key: _numpy(v) for key, v in det.items()}
        real = [(bi, i) for bi, i in enumerate(slots) if i is not None]
        if "nms_converged" in det:
            failed = [i for bi, i in real if not det["nms_converged"][bi]]
            if failed:
                raise RuntimeError(
                    "blocked_fixed NMS certificate failed on frames "
                    "{} of batch {}".format(failed, [i for _, i in real]))
        for bi, i in real:
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
        B = max(1, min(batch_size, num_images))
        detect_batch = _build_detector(params, imdb, indices, compute_dtype,
                                       quant_cfg, log)
        q = queue.Queue(maxsize=2)
        # images travel as their uint8 pixels and, under bf16 compute, the
        # BEV as bf16 (the trunks' first act is the same cast)
        bev_bf16 = compute_dtype == torch.bfloat16

        def producer():
            try:
                for slots in _batch_slots(indices, B):
                    frames = [None if i is None else
                              _load_eval_frame(imdb, i, image_dtype=np.uint8)
                              for i in slots]
                    first = next(f for f in frames if f is not None)
                    for s in range(B):          # pad with a neighbour frame
                        if frames[s] is None:
                            frames[s] = frames[s - 1] if s else first
                    images, bevs, calibs = (
                        torch.from_numpy(np.stack([f[j] for f in frames]))
                        for j in range(3))
                    if bev_bf16:
                        bevs = bevs.to(torch.bfloat16)
                    q.put((slots, *_to_device([images, bevs, calibs],
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
            slots, (images, bevs, calibs), ready = item
            _wait(ready, (images, bevs, calibs))
            timer.tic()
            det = detect_batch(params, bevs, images, calibs)
            if pending is not None:
                drain(*pending)     # overlaps this batch's device work
            pending = (slots, det)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timer.toc()
            done += sum(i is not None for i in slots)
            log("im_detect: {:d}/{:d} {:.3f}s/batch{}".format(
                done, len(indices), timer.average_time, B))
        if pending is not None:
            drain(*pending)

    result = ((all_boxes, all_boxes_cnr, all_boxes_cnr_r) if return_cnr_r
              else (all_boxes, all_boxes_cnr))
    if not evaluate:
        return result

    os.makedirs(output_dir, exist_ok=True)
    for name, boxes in (("detections.pkl", all_boxes),
                        ("detections_cnr.pkl", all_boxes_cnr),
                        ("detections_cnr_r.pkl", all_boxes_cnr_r)):
        with open(os.path.join(output_dir, name), "wb") as f:
            pickle.dump(boxes, f, pickle.HIGHEST_PROTOCOL)

    log("Evaluating detections")
    imdb.evaluate_detections(all_boxes, all_boxes_cnr, output_dir,
                             all_boxes_cnr_r=all_boxes_cnr_r)
    return result


# --------------------------------------------------------------------------
# The legacy 2D Faster R-CNN (solver.py:440-668, the reference's
# lib/fast_rcnn/train.py and test.py)
# --------------------------------------------------------------------------

def _prep_image_2d(path, bucket_hw, target_size=None, max_size=None):
    """Load, scale (data/blob.prep_im_for_blob) and pad to the static bucket
    (solver.py:444-457). Returns (image (H,W,3) float32 mean-subtracted,
    im_info [h, w, scale] float32)."""
    from mv3d_tf_tpu_torch.data.blob import prep_im_for_blob
    target_size = cfg.TRAIN.SCALES[0] if target_size is None else target_size
    max_size = cfg.TRAIN.MAX_SIZE if max_size is None else max_size
    im, scale = prep_im_for_blob(load_image_bgr(path),
                                 cfg.PIXEL_MEANS.reshape(1, 1, 3),
                                 target_size, max_size)
    h = min(im.shape[0], bucket_hw[0])
    w = min(im.shape[1], bucket_hw[1])
    out = np.zeros((bucket_hw[0], bucket_hw[1], 3), np.float32)
    out[:h, :w] = im[:h, :w]
    return out, np.array([h, w, scale], np.float32)


def _snapshot_2d(params, n_classes):
    """The params a 2D snapshot holds: bbox_pred unnormalized when the
    targets were normalized (solver.py:595-609)."""
    from mv3d_tf_tpu_torch.faster_rcnn_2d import snapshot_unnormalize_2d
    if not cfg.TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED:
        return params
    return snapshot_unnormalize_2d(params, cfg.TRAIN.BBOX_NORMALIZE_MEANS,
                                   cfg.TRAIN.BBOX_NORMALIZE_STDS, n_classes)


def train_net_fast_rcnn(imdb, roidb, output_dir, pretrained_model=None,
                        max_iters=10000, compute_dtype=None, seed=None,
                        bucket_hw=(608, 1024), ims_per_batch=2, log=print,
                        device="cuda"):
    """Train Fast R-CNN over precomputed proposals (solver.py:460-522, the
    reference's HAS_RPN = False branch, minibatch2.py:16-96) on ``device``
    (the card unless the caller asks for the CPU); returns the params.

    roidb carries proposal boxes with max_classes / max_overlaps (e.g.
    PascalVOC.region_proposal_roidb or selective_search_roidb);
    multiscale.add_bbox_regression_targets adds the normalized targets.
    Each iteration takes ims_per_batch images of an epoch permutation from
    np.random.RandomState(cfg.RNG_SEED), whose state also draws the rois
    (multiscale.get_minibatch_multiscale): a pyramid of
    len(cfg.TRAIN.SCALES_BASE) levels per image, cfg.TRAIN.BATCH_SIZE rois,
    padded to ``bucket_hw``. The params start from vggnet.init_params_2d
    with a generator seeded from ``seed`` (cfg.RNG_SEED if None), then
    ``pretrained_model``; the same generator gives the dropout masks
    (faster_rcnn_2d.make_draws_fast_rcnn). The snapshots
    ``<prefix>_iter_<N>.pt`` always unnormalize bbox_pred with the
    per-class means and stds of the targets (solver.py:511-520), and hold
    SGD's momentum and the scheduler.
    """
    from mv3d_tf_tpu_torch import faster_rcnn_2d as F2
    from mv3d_tf_tpu_torch.data import multiscale as ms
    from mv3d_tf_tpu_torch.models import vggnet

    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(
        cfg.RNG_SEED if seed is None else seed)
    params = vggnet.init_params_2d(gen, n_classes=imdb.num_classes,
                                   device=device)
    if pretrained_model is not None:
        log("Loading pretrained model weights from {:s}".format(
            pretrained_model))
        load_pretrained(params, pretrained_model)

    means, stds = ms.add_bbox_regression_targets(roidb, imdb.num_classes)
    step, make_opt = F2.build_fast_rcnn_train_step(
        lr=cfg.TRAIN.LEARNING_RATE, momentum=cfg.TRAIN.MOMENTUM,
        stepsize=cfg.TRAIN.STEPSIZE, gamma=cfg.TRAIN.GAMMA,
        compute_dtype=compute_dtype)
    opt, sched = make_opt(params)
    draw_args = (cfg.TRAIN.BATCH_SIZE, params["fc7"].weight.shape[0], 0.5,
                 device)

    def snapshot(it):
        save_checkpoint(output_dir, it, F2.snapshot_unnormalize_2d(
            params, means, stds, imdb.num_classes), opt, sched)

    rng = np.random.RandomState(cfg.RNG_SEED)
    perm = rng.permutation(len(roidb))
    cur = 0
    timer = Timer()
    for it in range(max_iters):
        if cur + ims_per_batch > len(perm):
            perm = rng.permutation(len(roidb))
            cur = 0
        entries = [roidb[perm[cur + j]] for j in range(ims_per_batch)]
        cur += ims_per_batch
        blobs = ms.get_minibatch_multiscale(entries, imdb.num_classes,
                                            rng=rng)
        batch = ms.pad_minibatch_multiscale(blobs, bucket_hw,
                                            cfg.TRAIN.BATCH_SIZE)
        draws = F2.make_draws_fast_rcnn(gen, *draw_args)
        timer.tic()
        m = step(params, opt, sched, batch, draws)
        loss = m["loss"].item()          # waits for the step
        timer.toc()
        if (it + 1) % cfg.TRAIN.DISPLAY == 0:
            log("iter: %d / %d, total loss: %.4f (%.3fs/iter)"
                % (it + 1, max_iters, loss, timer.average_time))
        if (it + 1) % cfg.TRAIN.SNAPSHOT_ITERS == 0:
            snapshot(it + 1)
    snapshot(max_iters)
    return params


def train_net_2d(imdb, roidb, output_dir, pretrained_model=None,
                 max_iters=10000, compute_dtype=None, seed=None,
                 bucket_hw=(608, 1024), max_gt=32, log=print,
                 device="cuda"):
    """Train the legacy 2D Faster R-CNN end to end (solver.py:525-609, the
    cfg.TRAIN.HAS_RPN branch) on ``device`` (the card unless the caller asks
    for the CPU); returns the params.

    Momentum SGD with the staircase lr decay, conv1/conv2 frozen, one image
    an iteration in an epoch permutation from np.random.RandomState(
    cfg.RNG_SEED), scaled by prep_im_for_blob and padded to ``bucket_hw``;
    bbox targets normalized when cfg.TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED
    is set, and then unnormalized in the snapshots. The params start from
    vggnet.init_params_2d with a generator seeded from ``seed``
    (cfg.RNG_SEED if None), then ``pretrained_model``; the same generator
    gives each iteration's draws (faster_rcnn_2d.make_draws_2d). Snapshots
    ``<prefix>_iter_<N>.pt`` hold the params, SGD's momentum and the
    scheduler. With HAS_RPN off (the config default; the end2end YAML turns
    it on) it trains Fast R-CNN over the roidb's precomputed proposals
    instead: train_net_fast_rcnn, image pyramid included (solver.py:
    536-541).
    """
    from mv3d_tf_tpu_torch import faster_rcnn_2d as F2
    from mv3d_tf_tpu_torch.models import vggnet

    if not cfg.TRAIN.HAS_RPN:
        return train_net_fast_rcnn(
            imdb, roidb, output_dir, pretrained_model=pretrained_model,
            max_iters=max_iters, compute_dtype=compute_dtype, seed=seed,
            bucket_hw=bucket_hw, log=log, device=device)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(
        cfg.RNG_SEED if seed is None else seed)
    params = vggnet.init_params_2d(gen, n_classes=imdb.num_classes,
                                   device=device)
    if pretrained_model is not None:
        log("Loading pretrained model weights from {:s}".format(
            pretrained_model))
        load_pretrained(params, pretrained_model)

    feat_h, feat_w = bucket_hw[0] // 16, bucket_hw[1] // 16
    step, make_opt = F2.build_train_step_2d(
        feat_h, feat_w, lr=cfg.TRAIN.LEARNING_RATE,
        momentum=cfg.TRAIN.MOMENTUM, stepsize=cfg.TRAIN.STEPSIZE,
        gamma=cfg.TRAIN.GAMMA, rois_per_image=cfg.TRAIN.BATCH_SIZE,
        pre_nms_top_n=cfg.TRAIN.RPN_PRE_NMS_TOP_N,
        post_nms_top_n=cfg.TRAIN.RPN_POST_NMS_TOP_N,
        n_classes=imdb.num_classes, compute_dtype=compute_dtype,
        bbox_normalize=cfg.TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED)
    opt, sched = make_opt(params)
    draw_args = (feat_h * feat_w * vggnet.NUM_ANCHORS_2D,
                 cfg.TRAIN.RPN_POST_NMS_TOP_N + max_gt, cfg.TRAIN.BATCH_SIZE,
                 params["fc7"].weight.shape[0], 0.5, device)

    rng = np.random.RandomState(cfg.RNG_SEED)
    perm = rng.permutation(len(roidb))
    cur = 0
    timer = Timer()
    for it in range(max_iters):
        if cur >= len(perm):
            perm = rng.permutation(len(roidb))
            cur = 0
        entry = roidb[perm[cur]]
        image, im_info = _prep_image_2d(
            entry["image_path"] if "image_path" in entry
            else imdb.image_path_at(perm[cur]), bucket_hw)
        cur += 1
        gt = np.zeros((max_gt, 5), np.float32)
        gt_valid = np.zeros(max_gt, bool)
        inds = np.where(entry["gt_classes"] != 0)[0][:max_gt]
        gt[:len(inds), :4] = entry["boxes"][inds] * im_info[2]
        gt[:len(inds), 4] = entry["gt_classes"][inds]
        gt_valid[:len(inds)] = True
        batch = {"image": image, "im_info": im_info, "gt_boxes": gt,
                 "gt_valid": gt_valid}
        draws = F2.make_draws_2d(gen, *draw_args)
        timer.tic()
        m = step(params, opt, sched, batch, draws)
        loss = m["loss"].item()          # waits for the step
        timer.toc()
        if (it + 1) % cfg.TRAIN.DISPLAY == 0:
            log("iter: %d / %d, total loss: %.4f (%.3fs/iter)"
                % (it + 1, max_iters, loss, timer.average_time))
        if (it + 1) % cfg.TRAIN.SNAPSHOT_ITERS == 0:
            save_checkpoint(output_dir, it + 1,
                            _snapshot_2d(params, imdb.num_classes), opt,
                            sched)
    save_checkpoint(output_dir, max_iters,
                    _snapshot_2d(params, imdb.num_classes), opt, sched)
    return params


def test_net_2d(params, imdb, weights_filename="default", max_per_image=100,
                thresh=0.05, compute_dtype=None, bucket_hw=(608, 1024),
                log=print):
    """Evaluate the 2D detector over an imdb (solver.py:612-668, the
    reference's test.py:216-346) on the params' device: each image scaled
    by TEST.SCALES/MAX_SIZE, faster_rcnn_2d.build_im_detect_2d at the TEST
    proposal budget, per-class threshold and host NMS at TEST.NMS, the
    max_per_image cap, detections.pkl, then the imdb's evaluation (VOC AP
    for voc_*, the 2D AP table for kitti2d_*), which it returns. The JAX
    package passes no output_dir to the evaluation, so its kitti2d run
    raises there; the port passes the detections' directory."""
    from mv3d_tf_tpu_torch.faster_rcnn_2d import build_im_detect_2d

    num_images = imdb.num_images
    k = imdb.num_classes
    all_boxes = [[[] for _ in range(num_images)] for _ in range(k)]
    output_dir = get_output_dir(imdb, weights_filename)
    detect = build_im_detect_2d(
        bucket_hw[0] // 16, bucket_hw[1] // 16,
        pre_nms_top_n=cfg.TEST.RPN_PRE_NMS_TOP_N,
        post_nms_top_n=cfg.TEST.RPN_POST_NMS_TOP_N,
        compute_dtype=compute_dtype)

    timer = Timer()
    for i in range(num_images):
        image, im_info = _prep_image_2d(imdb.image_path_at(i), bucket_hw,
                                        cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE)
        timer.tic()
        out = {key: _numpy(v) for key, v in
               detect(params, image, im_info).items()}
        timer.toc()
        scores = out["scores"]
        boxes = out["boxes"] / im_info[2]       # back to image coordinates
        valid = out["valid"]
        for j in range(1, k):
            inds = np.where(valid & (scores[:, j] > thresh))[0]
            dets = np.hstack([boxes[inds, 4 * j:4 * (j + 1)],
                              scores[inds, j:j + 1]]).astype(np.float32)
            all_boxes[j][i] = dets[nms_np(dets, cfg.TEST.NMS)]
        if max_per_image > 0:
            flat = np.concatenate([all_boxes[j][i][:, -1]
                                   for j in range(1, k)
                                   if len(all_boxes[j][i])] or [np.zeros(0)])
            if len(flat) > max_per_image:
                t = np.sort(flat)[-max_per_image]
                for j in range(1, k):
                    if len(all_boxes[j][i]):
                        all_boxes[j][i] = all_boxes[j][i][
                            all_boxes[j][i][:, -1] >= t]
        log("im_detect: {:d}/{:d} {:.3f}s".format(i + 1, num_images,
                                                  timer.average_time))

    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "detections.pkl"), "wb") as f:
        pickle.dump(all_boxes, f, pickle.HIGHEST_PROTOCOL)
    log("Evaluating detections")
    return imdb.evaluate_detections(all_boxes, output_dir)
