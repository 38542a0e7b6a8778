"""What the MV3D detection drivers share: the frame pool, the program's
detector settings, its stages, and the judgement by the reference."""

import numpy as np
import torch

from benchmark.drivers.base import Driver, to_numpy
from benchmark.lib import roofline as R
from benchmark.lib import timing
from benchmark.reference import mv3d as ref
from benchmark.reference import nets
from benchmark.reference.ops import point_cloud_2_top_np
from benchmark.traffic import generate


def crop_raster(raster, hw):
    """The configuration's BEV window of a (601, 601, 9) raster: its rows
    nearest the sensor and its middle columns (the whole raster at full
    size; the tests' small shapes keep the populated part)."""
    h, w = hw
    c0 = (raster.shape[1] - w) // 2
    return np.ascontiguousarray(raster[raster.shape[0] - h:, c0:c0 + w])


class MV3DDriver(Driver):

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        self.pool = generate.make(traffic, seed)
        h, w = cfg["image_hw"]
        self.pool["images"] = np.ascontiguousarray(
            self.pool["images"][:, :h, :w])
        t = cfg["test"]
        self.feat_hw = (cfg["bev_hw"][0] // 8, cfg["bev_hw"][1] // 8)
        self.detect_kw = dict(
            feat_h=self.feat_hw[0], feat_w=self.feat_hw[1],
            pre_nms_top_n=t["pre_nms_top_n"],
            post_nms_top_n=t["post_nms_top_n"],
            rpn_nms_thresh=t["rpn_nms_thresh"],
            compute_dtype=getattr(torch, cfg["dtype"]))
        self.class_kw = dict(num_classes=cfg["num_classes"],
                             score_thresh=t["score_thresh"],
                             nms_thresh=t["nms"],
                             max_per_image=t["max_per_image"])

    def raster(self, f):
        """The reference's raster of pool frame f, cropped to the config."""
        return crop_raster(point_cloud_2_top_np(self.pool["scans"][f]),
                           self.cfg["bev_hw"])

    def flops_per_item(self):
        return R.mv3d_frame_flops(self.cfg)

    # --- stages of the program, on one batch of the cell's frames --------

    def stage_inputs(self, bev, image, calib):
        """Device inputs as the program's detector makes them."""
        from mv3d_tf_tpu_torch import eval as E
        dev = self.device
        bev = torch.as_tensor(bev, dtype=torch.float32, device=dev)
        image = (torch.as_tensor(image, device=dev).float()
                 - torch.from_numpy(E.PIXEL_MEANS).to(dev))
        calib = torch.as_tensor(calib, dtype=torch.float32, device=dev)
        return bev, image, calib

    def mv3d_stages(self, bev, image, calib, dets_fn):
        """{trunks, proposals, roi_pool, host} on device inputs of a batch;
        dets_fn() runs the host assembly of one call's frames."""
        from mv3d_tf_tpu_torch import eval as E
        from mv3d_tf_tpu_torch.models import mv3d
        from mv3d_tf_tpu_torch.ops.roi_pool import roi_pool_fast
        kw, dt = self.detect_kw, self.detect_kw["compute_dtype"]
        params = self.p_params

        def feats():
            return mv3d.extract_features(params, bev, image, dtype=dt,
                                         stem_impl="fused")

        with torch.inference_mode():
            c5, c5_2 = feats()
            rpn_cls, rpn_box = mv3d.rpn_head(params, c5, dtype=dt)

            def props():
                return E.proposals(rpn_cls, rpn_box, calib, kw["feat_h"],
                                   kw["feat_w"], kw["pre_nms_top_n"],
                                   kw["post_nms_top_n"], kw["rpn_nms_thresh"])
            _, flat_bv, flat_img = props()

            def pool():
                roi_pool_fast(c5, flat_bv, spatial_scale=1.0 / 8)
                roi_pool_fast(c5_2, flat_img, spatial_scale=1.0 / 8)

            def run(fn):
                def reading():
                    with torch.inference_mode():
                        return {"ms": timing.stage_ms(fn)}
                return reading

            def pool_reading():
                with torch.inference_mode():
                    return {"ms": timing.stage_ms(pool, iters=20),
                            "work": [R.roi_pool_work(c5, flat_bv, 1.0 / 8),
                                     R.roi_pool_work(c5_2, flat_img,
                                                     1.0 / 8)]}
        return {"trunks": run(feats), "proposals": run(props),
                "roi_pool": pool_reading,
                "host": lambda: {"ms": timing.host_ms(dets_fn)}}

    # --- the judgement ---------------------------------------------------

    def frame_inputs(self, f):
        """(raster, image, calib) of pool frame f as the reference's device
        tensors."""
        dev = self.device
        return (torch.from_numpy(self.raster(f)).to(dev),
                torch.from_numpy(self.pool["images"][f]).to(dev),
                torch.from_numpy(self.pool["calib"]).to(dev))

    def judge_frames(self, control, extra=None):
        """The worst of each number over the kept frames (all the pool's
        frames that the window finished). extra(f) adds numbers of frame f
        that the reference works out apart from the detector."""
        nets.no_tf32()
        weights = self.reference_weights()
        readings = []
        for f in sorted(self.kept):
            bev, image, calib = self.frame_inputs(f)
            if control:
                det = ref.detect(weights, bev, image, calib, self.cfg["test"],
                                 q=nets.fp8)
                dets = ref.frame_detections(det, **self.class_kw)
            else:
                det, dets = to_numpy(self.kept[f][0]), self.kept[f][1]
            r = ref.judge_frame(weights, det, dets, bev, image, calib,
                                self.cfg)
            if extra is not None:
                r.update(extra(f, control))
            readings.append(r)
        return self.worst(readings)
