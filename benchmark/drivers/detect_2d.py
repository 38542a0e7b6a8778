"""2D detection, one image per request as solver.test_net_2d runs it: the
scaled, mean-subtracted image padded into the bucket goes to
faster_rcnn_2d.build_im_detect_2d's im_detect as a host float32 array, then
test_net_2d's per-class threshold, host NMS (ops.nms.nms_np) and cap, in
the original image's coordinates. The program keeps that loop inside
test_net_2d, so the driver runs its steps (``class_detections``)."""

import numpy as np
import torch

from benchmark.drivers.base import Driver as BaseDriver
from benchmark.drivers.base import to_numpy
from benchmark.lib import roofline as R
from benchmark.lib import timing
from benchmark.reference import frcnn as ref
from benchmark.reference import nets
from benchmark.traffic import generate


def class_detections(out, im_scale, thresh, nms_thresh, max_per_image):
    """test_net_2d's host steps for one image (solver.test_net_2d)."""
    from mv3d_tf_tpu_torch.ops.nms import nms_np
    scores, valid = out["scores"], out["valid"]
    boxes = out["boxes"] / im_scale
    k = scores.shape[1]
    dets_all = [np.zeros((0, 5), np.float32)]
    for j in range(1, k):
        inds = np.where(valid & (scores[:, j] > thresh))[0]
        dets = np.hstack([boxes[inds, 4 * j:4 * (j + 1)],
                          scores[inds, j:j + 1]]).astype(np.float32)
        dets_all.append(dets[nms_np(dets, nms_thresh)])
    if max_per_image > 0:
        flat = np.concatenate([d[:, -1] for d in dets_all[1:]])
        if len(flat) > max_per_image:
            t = np.sort(flat)[-max_per_image]
            dets_all = [dets_all[0]] + [d[d[:, -1] >= t]
                                        for d in dets_all[1:]]
    return dets_all


class Driver(BaseDriver):
    ITEMS_METRIC = "images_per_s"

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        from mv3d_tf_tpu_torch import faster_rcnn_2d as F2
        self.F2 = F2
        self.pool = generate.make(traffic, seed,
                                  pixel_means=cfg["pixel_means"])
        t = cfg["test"]
        h, w = cfg["image_hw"]
        self.feat_hw = (h // 16, w // 16)
        self.class_kw = dict(thresh=t["score_thresh"], nms_thresh=t["nms"],
                             max_per_image=t["max_per_image"])
        self.p_params = self.params()
        self.p_detect = F2.build_im_detect_2d(
            self.feat_hw[0], self.feat_hw[1],
            pre_nms_top_n=t["pre_nms_top_n"],
            post_nms_top_n=t["post_nms_top_n"],
            compute_dtype=getattr(torch, cfg["dtype"]))
        self.warm_up(traffic["pool"])

    def call(self, i):
        f = i % self.traffic["pool"]
        im_info = self.pool["im_info"]
        out = to_numpy(self.p_detect(self.p_params, self.pool["images"][f],
                                     im_info))
        self.kept[f] = (out, class_detections(out, im_info[2],
                                              **self.class_kw))
        return 1

    def flops_per_item(self):
        return R.frcnn_image_flops(self.cfg)

    def stages(self):
        from mv3d_tf_tpu_torch.models import mv3d, vggnet
        from mv3d_tf_tpu_torch.ops.roi_pool import roi_pool_fast
        F2, dev, t = self.F2, self.device, self.cfg["test"]
        dt = getattr(torch, self.cfg["dtype"])
        params = self.p_params
        image = torch.as_tensor(self.pool["images"][0], device=dev)[None]
        im_info = torch.as_tensor(self.pool["im_info"], device=dev)
        h, w = self.feat_hw

        def trunk():
            return vggnet.trunk_apply_2d(params, image, dtype=dt)

        with torch.inference_mode():
            c5 = trunk()
            cls, box = vggnet.rpn_head_2d(params, c5, dtype=dt)

            def props():
                return F2.proposal_layer_2d(
                    mv3d.rpn_probs(cls), box.float(), im_info, h, w,
                    pre_nms_top_n=t["pre_nms_top_n"],
                    post_nms_top_n=t["post_nms_top_n"])
            rois = props()[0]

        def pool():
            roi_pool_fast(c5[0], rois, spatial_scale=F2.SPATIAL_SCALE)

        def run(fn, **kw):
            def reading():
                with torch.inference_mode():
                    return {"ms": timing.stage_ms(fn, **kw)}
            return reading

        def pool_reading():
            r = run(pool, iters=20)()
            r["work"] = [R.roi_pool_work(c5[0], rois, F2.SPATIAL_SCALE)]
            return r
        return {"trunk": run(trunk), "proposals": run(props),
                "roi_pool": pool_reading}

    def judge(self, control=False):
        nets.no_tf32()
        weights = self.reference_weights()
        dev = self.device
        im_info = torch.from_numpy(self.pool["im_info"]).to(dev)
        readings = []
        for f in sorted(self.kept):
            image = torch.from_numpy(self.pool["images"][f]).to(dev)
            if control:
                det = ref.im_detect(weights, image, im_info, self.cfg["test"],
                                    q=nets.fp8)
                dets = ref.class_detections(
                    det, float(im_info[2]), self.cfg["test"]["score_thresh"],
                    self.cfg["test"]["nms"], self.cfg["test"]["max_per_image"])
            else:
                det, dets = self.kept[f]
            readings.append(ref.judge_image(weights, det, dets, image,
                                            im_info, self.cfg))
        return self.worst(readings)
