"""The one generator of the benchmark's traffic. A traffic mix is a data
file beside this one (``<name>.json``) whose "kind" names what it makes and
whose other keys are the parameters; the same seed gives the same pool.

Kinds:
  * ``lidar_frames``: a pool of KITTI-like frames. Each scan is a 64-beam
    lidar (elevations +2 to -24.8 degrees, an HDL-64E's) mounted 1.73 m
    above a ground plane, so that the point density falls with range; rays
    that clear the ground hit two building fronts beside the road or the
    far background, and a few car-sized boxes stand on the road. Each
    frame has a camera image (smooth colour blobs with pixel noise, 8-bit)
    padded into the network's input, and the KITTI example calibration.
  * ``voc_images``: a pool of VOC-sized 8-bit images, scaled so that the
    short side is the test scale (the long side at most the cap), the
    configuration's pixel means subtracted, padded into the bucket.
"""

import numpy as np
import torch
import torch.nn.functional as F

LIDAR_Z = 1.73        # the sensor above the ground, m
CAR_LWH = (3.9, 1.6, 1.56)


def example_calib():
    """KITTI's calibration rows P2, P3, R0 (padded), Tr_velo_to_cam."""
    calib = np.zeros((4, 12), np.float32)
    calib[0] = [707.0, 0, 601.8, 45.7, 0, 707.0, 183.1, -0.34,
                0, 0, 1.0, 0.005]
    calib[1] = calib[0]
    calib[2, :9] = np.eye(3, dtype=np.float32).reshape(-1)
    calib[3] = [0.0002, -0.9999, -0.0106, -0.002, 0.0104, 0.0106,
                -0.9999, -0.075, 0.9999, 0.0002, 0.0105, -0.272]
    return calib


def _box_hits(ox, oy, dx, dy, cars):
    """Distance along rays (dx, dy) from the sensor to each car's footprint
    (a rotated rectangle), inf where a ray misses: (N, cars)."""
    t = np.full((len(dx), len(cars)), np.inf, np.float32)
    for k, (cx, cy, yaw) in enumerate(cars):
        c, s = np.cos(yaw), np.sin(yaw)
        # the ray in the car's frame
        px, py = c * (ox - cx) + s * (oy - cy), -s * (ox - cx) + c * (oy - cy)
        vx, vy = c * dx + s * dy, -s * dx + c * dy
        with np.errstate(divide="ignore", invalid="ignore"):
            t1, t2 = (-CAR_LWH[0] / 2 - px) / vx, (CAR_LWH[0] / 2 - px) / vx
            t3, t4 = (-CAR_LWH[1] / 2 - py) / vy, (CAR_LWH[1] / 2 - py) / vy
        near = np.maximum(np.minimum(t1, t2), np.minimum(t3, t4))
        far = np.minimum(np.maximum(t1, t2), np.maximum(t3, t4))
        t[:, k] = np.where((near <= far) & (near > 0), near, np.inf)
    return t


def lidar_scan(rng, p):
    """One scan (n, 4) float32 [x, y, z, reflectance]."""
    n = p["points"]
    elev = np.deg2rad(np.linspace(p["elev_max_deg"], p["elev_min_deg"], 64))
    e = elev[rng.integers(0, 64, n)]
    az = rng.uniform(-np.pi, np.pi, n)
    dx, dy = np.cos(az), np.sin(az)
    # the ground, else a building front beside the road, else the background
    down = e < -1e-3
    t = np.where(down, LIDAR_Z / np.tan(-np.minimum(e, -1e-3)), np.inf)
    left, right = rng.uniform(*p["street_half_width_m"], 2)
    with np.errstate(divide="ignore"):
        wall = np.where(dy > 0, left / dy, -right / dy)
    t = np.minimum(t, np.where(wall > 0, wall, np.inf))
    t = np.minimum(t, rng.uniform(*p["background_m"], n))
    n_cars = rng.integers(p["cars"][0], p["cars"][1] + 1)
    r = rng.uniform(*p["car_range_m"], n_cars)
    a = rng.uniform(-1, 1, n_cars) * np.deg2rad(p["car_azimuth_deg"])
    cars = np.stack([r * np.cos(a), r * np.sin(a),
                     rng.uniform(-0.3, 0.3, n_cars)], 1)
    if n_cars:
        tc = _box_hits(0.0, 0.0, dx, dy, cars)
        z_at = tc * np.tan(e)[:, None]
        on = (z_at >= -LIDAR_Z) & (z_at <= -LIDAR_Z + CAR_LWH[2])
        tc = np.where(on, tc, np.inf).min(1)
        t = np.minimum(t, tc)
    t = t + rng.normal(0, p["range_noise_m"], n)
    z = t * np.tan(e)
    z = np.where(down & (z < -LIDAR_Z), -LIDAR_Z, z)
    z = z + rng.normal(0, p["height_noise_m"], n)
    refl = rng.uniform(0, 1, n)
    return np.stack([t * dx, t * dy, z, refl], 1).astype(np.float32)


def camera_image(rng, h, w, blob):
    """(h, w, 3) uint8: colour blobs of size ``blob`` px plus pixel noise."""
    low = torch.from_numpy(rng.uniform(0, 255, (1, 3, h // blob + 2,
                                                 w // blob + 2)))
    img = F.interpolate(low, size=(h, w), mode="bilinear",
                        align_corners=False)[0].permute(1, 2, 0).numpy()
    img = img + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def lidar_frames(p, seed):
    """{"scans": [(n, 4)], "images": (P, H, W, 3) uint8 padded, "calib"
    (4, 12)} for a pool of p["pool"] frames."""
    scans, images = [], []
    ph, pw = p["image_pad_hw"]
    for i in range(p["pool"]):
        rng = np.random.default_rng([int(seed), i])
        scans.append(lidar_scan(rng, p))
        img = np.zeros((ph, pw, 3), np.uint8)
        h, w = p["image_hw"]
        img[:h, :w] = camera_image(rng, h, w, p["image_blob_px"])
        images.append(img)
    return {"scans": scans, "images": np.stack(images),
            "calib": example_calib()}


def voc_images(p, seed, pixel_means):
    """{"images": (P, H, W, 3) float32 mean-subtracted and padded,
    "im_info": (3,) [h, w, scale]}: one scale for the pool, whose images
    share one size."""
    h, w = p["image_hw"]
    scale = min(p["scale"] / min(h, w), p["max_size"] / max(h, w))
    sh, sw = int(round(h * scale)), int(round(w * scale))
    bh, bw = p["bucket_hw"]
    out = np.zeros((p["pool"], bh, bw, 3), np.float32)
    for i in range(p["pool"]):
        rng = np.random.default_rng([int(seed), i])
        img = torch.from_numpy(camera_image(rng, h, w, p["image_blob_px"])
                               .astype(np.float32))
        img = img - torch.tensor(pixel_means, dtype=torch.float32)
        big = F.interpolate(img.permute(2, 0, 1)[None], size=(sh, sw),
                            mode="bilinear", align_corners=False)
        out[i, :sh, :sw] = big[0].permute(1, 2, 0).numpy()
    return {"images": out,
            "im_info": np.array([sh, sw, scale], np.float32)}


KINDS = {"lidar_frames": lidar_frames, "voc_images": voc_images}


def make(p, seed, **kw):
    """The pool of the traffic file's kind, from the seed."""
    return KINDS[p["kind"]](p, seed, **kw)
