"""What a cell's driver provides to the harness (lib/harness.py).

A driver module holds a class ``Driver(cfg, traffic, seed, device)`` whose
constructor is the run's set-up: it makes the weights (from the
configuration's weight_seed) and the traffic (from the run's seed), builds
the program's entry points, and warms up the shapes the window uses.
Then:
  * ``call(i)``: the window's i-th call, as a user makes it, ending with its
    results on the host; returns the items it finished. It keeps what the
    program produced for the judgement.
  * ``ITEMS_METRIC``: the name of the end-to-end rate the items give.
  * ``stages()``: {stage: reading()} for the per-layer readers, each timing
    one of the program's public layer entries on the cell's own inputs and
    returning {"ms", ...}.
  * ``flops_per_item()``: the model's operations per item, counted from
    the configuration's shapes.
  * ``release()``: frees the program's state, once the window and any
    traced readings are done.
  * ``judge(control=False)``: the reference's numbers over the kept
    outputs, each the worst over them; with control=True the reference
    computed one precision step down stands in for the program.
"""

import time

import numpy as np
import torch

from benchmark.lib import weights as W


# the warm-up: calls over the whole pool, and for at least this long, so
# that caches, clocks and allocator pools are settled before the window
WARM_UP_S = 2.0


class Driver:
    ITEMS_METRIC = "frames_per_s"

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = device
        self.kept = {}

    def params(self):
        """The program's parameters: copies of the model's weights."""
        weights = self.reference_weights()
        params = W.module_dict(weights)
        del weights
        return params

    def warm_up(self, calls):
        """Calls 0, 1, ... until ``calls`` are done and WARM_UP_S passed."""
        t0, i = time.perf_counter(), 0
        while i < calls or time.perf_counter() - t0 < WARM_UP_S:
            self.call(i)
            i += 1
        if self.device == "cuda":
            torch.cuda.synchronize()

    def reference_weights(self):
        """The model's weights, made anew on the device from the
        configuration's weight_seed: one network for every run, as one
        trained model serves every frame; the run's seed makes the traffic.
        (Weights drawn from the run's seed changed the work from run to run:
        the number of detections that pass the score threshold, and with it
        the host's per-class NMS, follows the network.)"""
        return W.make(self.cfg, self.cfg["weight_seed"], self.device)

    def release(self):
        for name in list(vars(self)):
            if name.startswith("p_"):
                delattr(self, name)
        if self.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    @staticmethod
    def worst(readings):
        """The worst of each number over a list of per-item readings."""
        out = {}
        for r in readings:
            for k, v in r.items():
                out[k] = max(out.get(k, -np.inf), v)
        return out


def to_numpy(det):
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in det.items()}
