"""Online detection, one lidar scan at a time as tools/demo_mv runs it: the
scan, a host (N, 4) float32 array, goes through ops.bev.pad_points and
ops.bev.point_cloud_2_top_batch (B=1, on the card), then
eval.build_detect_fn's detect on the raster and the frame's uint8 image,
then eval.frame_detections. A request's latency runs from the scan's
hand-off to its per-class detections on the host."""

import numpy as np
import torch

from benchmark.drivers.mv3d_common import MV3DDriver, crop_raster
from benchmark.lib import timing
from benchmark.reference.ops import point_cloud_2_top_np


class Driver(MV3DDriver):

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        from mv3d_tf_tpu_torch import eval as E
        from mv3d_tf_tpu_torch.ops import bev
        self.E, self.bev = E, bev
        self.rasters = {}
        self.p_params = self.params()
        self.p_detect = E.build_detect_fn(**self.detect_kw)
        self.warm_up(traffic["pool"])

    def front_end(self, f):
        pts, valid = self.bev.pad_points(self.pool["scans"][f],
                                         self.traffic["bucket"])
        raster = self.bev.point_cloud_2_top_batch(pts[None], valid[None],
                                                  device=self.device)[0]
        h, w = self.cfg["bev_hw"]
        c0 = (raster.shape[1] - w) // 2
        return raster[raster.shape[0] - h:, c0:c0 + w]

    def call(self, i):
        f = i % self.traffic["pool"]
        raster = self.front_end(f)
        det = self.p_detect(self.p_params, raster, self.pool["images"][f],
                            self.pool["calib"])
        self.kept[f] = (det, self.E.frame_detections(det, **self.class_kw))
        self.rasters[f] = raster
        return 1

    def stages(self):
        bev, image, calib = self.stage_inputs(
            self.front_end(0)[None], self.pool["images"][:1],
            self.pool["calib"][None])
        with torch.inference_mode():
            det = self.p_detect(self.p_params, bev[0], self.pool["images"][0],
                                self.pool["calib"])
        stages = self.mv3d_stages(
            bev, image, calib,
            lambda: self.E.frame_detections(det, **self.class_kw))
        stages["bev"] = lambda: {"ms": timing.stage_ms(
            lambda: self.front_end(0))}
        return stages

    def judge(self, control=False):
        def raster_cells(f, control):
            # the program's raster against the reference's, cell by cell;
            # the control's raster is the reference's own
            if control:
                return {"raster_mismatch": 0}
            ref = crop_raster(point_cloud_2_top_np(self.pool["scans"][f]),
                              self.cfg["bev_hw"])
            got = self.rasters[f].cpu().numpy()
            return {"raster_mismatch": int(np.sum(got != ref))}
        return self.judge_frames(control, raster_cells)
