"""Instance segmentation with Mask R-CNN ResNet-101-FPN, one image per
request as solver.test_net_2d runs it: the configuration's network
(models/factory.get_network("MaskRCNN_R101_FPN_test")) through
faster_rcnn_2d.build_im_detect_2d (the trunk to C2-C5, the pyramid, the
RPN over five levels, per-level proposals on one NMS call, one multi-level
RoIAlign, the box head), the host's class step (solver.class_detections_2d:
threshold, per-class NMS, the cap over 80 classes), then the mask stage
(faster_rcnn_2d.build_im_mask_2d) on the kept detections against the
pyramid left on the card. A request ends when its detections and their
28x28 masks are on the host.

The weights are lib/weights_fpn.make's, folded by the program's own
conversion (models/fpn.params_from_raw). A program without the network
cannot run the cell and leaves set-up at once."""

import numpy as np
import torch

from benchmark.drivers.base import Driver as BaseDriver
from benchmark.drivers.base import to_numpy
from benchmark.lib import flops_fpn
from benchmark.lib import weights_fpn as W
from benchmark.reference import mask_rcnn_fpn as ref
from benchmark.reference import nets
from benchmark.traffic import generate

NETWORK = "MaskRCNN_R101_FPN_test"


class Driver(BaseDriver):
    ITEMS_METRIC = "images_per_s"

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        from mv3d_tf_tpu_torch.models.factory import get_network
        spec = get_network(NETWORK)
        if not spec.is_2d or getattr(spec, "mask_head", None) is None:
            raise SystemExit("the program has no %s network" % NETWORK)
        from mv3d_tf_tpu_torch import faster_rcnn_2d as F2
        from mv3d_tf_tpu_torch.solver import class_detections_2d
        self.class_detections = class_detections_2d
        self.pool = generate.make(traffic, seed,
                                  pixel_means=cfg["pixel_means"])
        t = cfg["test"]
        self.class_kw = dict(thresh=t["score_thresh"], nms_thresh=t["nms"],
                             max_per_image=t["max_per_image"])
        dtype = getattr(torch, cfg["dtype"])
        self.p_params = self.params()
        self.p_detect = F2.build_im_detect_2d(
            0, 0, pre_nms_top_n=t["pre_nms_top_n"],
            post_nms_top_n=t["post_nms_top_n"], compute_dtype=dtype,
            spec=spec)
        self.p_mask = F2.build_im_mask_2d(spec, compute_dtype=dtype)
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
        dets = self.class_detections(out, im_info[2], **self.class_kw)
        masks = self.p_mask(self.p_params, self.p_detect.maps, dets,
                            im_info[2])
        self.kept[f] = (out, dets, masks)
        return 1

    def mask_dets(self):
        """Detections a call sent through the mask head, the mean over the
        kept images."""
        return float(np.mean([sum(len(d) for d in dets)
                              for _, dets, _ in self.kept.values()]))

    def flops_per_item(self):
        return flops_fpn.image_flops(self.cfg, self.mask_dets())

    def roi_align_bytes(self):
        """The bytes of the two RoIAlign launches of a call on pool image 0
        (the image of the traced calls): [(box pass, 0), (mask pass, 0)]."""
        out, dets, masks = self.kept[0]
        shapes = flops_fpn.level_shapes(self.cfg["image_hw"])[:4]
        elem = torch.finfo(getattr(torch, self.cfg["dtype"])).bits // 8
        c, t = self.cfg["fpn_dim"], self.cfg["test"]
        box = flops_fpn.roi_align_bytes(
            torch.as_tensor(out["rois"][out["valid"]][:, 1:]),
            torch.as_tensor(out["levels"][out["valid"]]), shapes, c,
            self.cfg["box_pooled"], elem, t["post_nms_top_n"])
        boxes, _ = ref.det_boxes(dets, float(self.pool["im_info"][2]), "cpu")
        mask = flops_fpn.roi_align_bytes(
            boxes, torch.as_tensor(masks["levels"]), shapes, c,
            self.cfg["mask_pooled"], elem, len(boxes))
        return [(box, 0), (mask, 0)]

    def stages(self):
        return {}

    def judge(self, control=False):
        nets.no_tf32()
        weights = self.reference_weights()
        dev = self.device
        im_info = torch.from_numpy(self.pool["im_info"]).to(dev)
        readings = []
        for f in sorted(self.kept):
            image = torch.from_numpy(self.pool["images"][f]).to(dev)
            with torch.no_grad():
                if control:
                    det, dets, masks = ref.im_detect(weights, image, im_info,
                                                     self.cfg, q=nets.fp8)
                else:
                    det, dets, masks = self.kept[f]
                readings.append(ref.judge_image(weights, det, dets, masks,
                                                image, im_info, self.cfg))
        return self.worst(readings)
