"""Offline detection, as solver.test_net runs it: frames in batches of the
traffic's "batch", handed to eval.build_detect_batch_fn's detect_batch as
host arrays (the BEV raster in float32, the image in uint8, so that the
copies to the card are inside the call), then eval.frame_detections on
each frame. The rasters are made in set-up from the pool's scans by the
reference's rasterizer: the front end is not this cell's work."""

import numpy as np
import torch

from benchmark.drivers.mv3d_common import MV3DDriver


class Driver(MV3DDriver):

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        from mv3d_tf_tpu_torch import eval as E
        self.E = E
        b, n = traffic["batch"], traffic["pool"]
        rasters = np.stack([self.raster(f) for f in range(n)])
        self.batches = [list(range(i, i + b)) for i in range(0, n, b)]
        self.bev = [np.ascontiguousarray(rasters[ix]) for ix in self.batches]
        self.images = [np.ascontiguousarray(self.pool["images"][ix])
                       for ix in self.batches]
        self.calib = np.repeat(self.pool["calib"][None], b, 0)
        self.p_params = self.params()
        self.p_detect = E.build_detect_batch_fn(**self.detect_kw)
        self.warm_up(len(self.batches))

    def call(self, i):
        k = i % len(self.batches)
        det = self.p_detect(self.p_params, self.bev[k], self.images[k],
                            self.calib)
        for j, f in enumerate(self.batches[k]):
            one = {name: v[j] for name, v in det.items()}
            self.kept[f] = (one, self.E.frame_detections(one,
                                                         **self.class_kw))
        return len(self.batches[k])

    def stages(self):
        bev, image, calib = self.stage_inputs(self.bev[0], self.images[0],
                                              self.calib)
        with torch.inference_mode():
            det = self.p_detect(self.p_params, self.bev[0], self.images[0],
                                self.calib)

        def dets():
            for j in range(len(self.batches[0])):
                self.E.frame_detections({n: v[j] for n, v in det.items()},
                                        **self.class_kw)
        return self.mv3d_stages(bev, image, calib, dets)

    def judge(self, control=False):
        return self.judge_frames(control)
