"""2D detection with Faster R-CNN ResNet-101 C4, one image per request as
solver.test_net_2d runs it: detect_2d.py's steps with the configuration's
network (models/factory.get_network("Res101C4_test"): the trunk to res4,
15 anchors of scales 2-32, a 14x14 RoI pool, res5 per RoI) handed to
faster_rcnn_2d.build_im_detect_2d, then test_net_2d's per-class threshold,
host NMS and cap over 80 classes, the program's own step
(solver.class_detections_2d).

The weights are lib/weights_r101.make's, folded by the program's own
conversion (models/resnet.params_from_raw). A program without
models/resnet.py cannot run the cell and fails in set-up."""

import torch

from benchmark.drivers.base import Driver as BaseDriver
from benchmark.drivers.base import to_numpy
from benchmark.lib import flops_r101
from benchmark.lib import weights_r101 as W
from benchmark.reference import frcnn_r101 as ref
from benchmark.reference import nets
from benchmark.traffic import generate


class Driver(BaseDriver):
    ITEMS_METRIC = "images_per_s"

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        from mv3d_tf_tpu_torch import faster_rcnn_2d as F2
        from mv3d_tf_tpu_torch.models.factory import get_network
        spec = get_network("Res101C4_test")
        if not spec.is_2d:
            raise SystemExit("the program has no %s network" % cfg["trunk"])
        from mv3d_tf_tpu_torch.solver import class_detections_2d
        self.class_detections = class_detections_2d
        self.pool = generate.make(traffic, seed,
                                  pixel_means=cfg["pixel_means"])
        t = cfg["test"]
        h, w = cfg["image_hw"]
        stride = cfg["feat_stride"]
        self.feat_hw = (h // stride, w // stride)
        self.class_kw = dict(thresh=t["score_thresh"], nms_thresh=t["nms"],
                             max_per_image=t["max_per_image"])
        self.p_params = self.params()
        self.p_detect = F2.build_im_detect_2d(
            self.feat_hw[0], self.feat_hw[1],
            pre_nms_top_n=t["pre_nms_top_n"],
            post_nms_top_n=t["post_nms_top_n"],
            compute_dtype=getattr(torch, cfg["dtype"]), spec=spec)
        self.warm_up(traffic["pool"])

    def reference_weights(self):
        return W.make(self.cfg, self.cfg["weight_seed"], self.device)

    def params(self):
        raw = self.reference_weights()
        params = W.program_params(raw)
        del raw
        return params

    def call(self, i):
        f = i % self.traffic["pool"]
        im_info = self.pool["im_info"]
        out = to_numpy(self.p_detect(self.p_params, self.pool["images"][f],
                                     im_info))
        self.kept[f] = (out, self.class_detections(out, im_info[2],
                                                   **self.class_kw))
        return 1

    def flops_per_item(self):
        return flops_r101.image_flops(self.cfg)

    def res5_flops(self):
        """res5's FLOPs in a call: every post-NMS slot."""
        return (self.cfg["test"]["post_nms_top_n"]
                * flops_r101.res5_flops_per_roi(self.cfg))

    def roi_pool_bytes(self):
        """The 14x14 pool's bytes in a call on pool image 0 (the image of
        the traced calls), from its kept rois."""
        rois = torch.as_tensor(self.kept[0][0]["rois"])
        h, w = self.feat_hw
        return flops_r101.roi_pool_bytes(
            rois, (h, w, self.cfg["out_dims"][2]), self.cfg["pooled"],
            1.0 / self.cfg["feat_stride"],
            torch.finfo(getattr(torch, self.cfg["dtype"])).bits // 8)

    def stages(self):
        return {}

    def judge(self, control=False):
        nets.no_tf32()
        weights = self.reference_weights()
        dev, t = self.device, self.cfg["test"]
        im_info = torch.from_numpy(self.pool["im_info"]).to(dev)
        readings = []
        for f in sorted(self.kept):
            image = torch.from_numpy(self.pool["images"][f]).to(dev)
            with torch.no_grad():
                if control:
                    det = ref.im_detect(weights, image, im_info, self.cfg,
                                        q=nets.fp8)
                    dets = ref.class_detections(
                        det, float(im_info[2]), t["score_thresh"], t["nms"],
                        t["max_per_image"])
                else:
                    det, dets = self.kept[f]
                readings.append(ref.judge_image(weights, det, dets, image,
                                                im_info, self.cfg))
        return self.worst(readings)
