"""Training frames with ground truth: generate.py's lidar_frames (the same
scans and images for the same seed) and, for each frame, the cars its scan
holds as 3D boxes, padded as the program's data layer pads them
(mv3d_tf_tpu_torch/data/loader.py:pad_gt).

generate.lidar_scan draws its cars from the frame's generator after the
beams, azimuths, street and background; ``frame_cars`` replays those draws
on a generator seeded alike, so the boxes are the scan's own cars. A car
is an axis-aligned box in the lidar frame, MV3D's box form: centre (x, y)
on the road, z its middle above the ground, CAR_LWH's length, width and
height (its yaw of up to 0.3 rad is not part of the box).

Kind ``lidar_frames_gt``: lidar_frames' parameters and ``max_gt``.
"""

import numpy as np
import torch

from benchmark.reference import geometry as G
from benchmark.traffic import generate


def frame_cars(p, seed, i):
    """(n, 2) [x, y] of frame i's cars, by the draws of lidar_scan."""
    rng = np.random.default_rng([int(seed), i])
    n = p["points"]
    rng.integers(0, 64, n)
    rng.uniform(-np.pi, np.pi, n)
    rng.uniform(*p["street_half_width_m"], 2)
    rng.uniform(*p["background_m"], n)
    n_cars = rng.integers(p["cars"][0], p["cars"][1] + 1)
    r = rng.uniform(*p["car_range_m"], n_cars)
    a = rng.uniform(-1, 1, n_cars) * np.deg2rad(p["car_azimuth_deg"])
    return np.stack([r * np.cos(a), r * np.sin(a)], 1)


def gt_blocks(cars, max_gt):
    """The padded ground truth of one frame: gt_boxes_bv (G, 5), gt_boxes_3d
    (G, 7), gt_boxes_corners (G, 25), each with class 1 last, and gt_valid
    (G,), as float32 / bool tensors."""
    n = min(len(cars), max_gt)
    l, w, h = generate.CAR_LWH
    box = torch.tensor([[x, y, -generate.LIDAR_Z + h / 2, l, w, h]
                        for x, y in cars[:n]], dtype=torch.float32)
    bv = torch.zeros(max_gt, 5)
    b3 = torch.zeros(max_gt, 7)
    b3[:, 3:6] = 1.0          # log() stays finite on padded rows
    cnr = torch.zeros(max_gt, 25)
    bv[:n, :4] = G.lidar_3d_to_bv(box)
    b3[:n, :6] = box
    cnr[:n, :24] = G.lidar_3d_to_corners(box)
    bv[:n, 4] = b3[:n, 6] = cnr[:n, 24] = 1.0
    return {"gt_boxes_bv": bv, "gt_boxes_3d": b3, "gt_boxes_corners": cnr,
            "gt_valid": torch.arange(max_gt) < n}


def lidar_frames_gt(p, seed):
    """generate.lidar_frames' pool plus "gt": each frame's gt_blocks."""
    pool = generate.lidar_frames(p, seed)
    pool["gt"] = [gt_blocks(frame_cars(p, seed, i), p["max_gt"])
                  for i in range(p["pool"])]
    return pool


def make(p, seed):
    if p["kind"] != "lidar_frames_gt":
        raise ValueError("frames_gt makes lidar_frames_gt, not %r"
                         % p["kind"])
    return lidar_frames_gt(p, seed)
