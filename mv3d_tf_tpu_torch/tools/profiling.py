"""What the trace and profile tools share: the reference shapes, their
inputs made from a seed, the He-scaled parameters, and the two clocks.

The JAX package's tools time jitted programs, and they time prefixes and
ablations of one fused graph because XLA fusion makes a stage timed alone
lie on the TPU (tools/profile_detect.py:1-12). PyTorch runs eagerly: a
stage here launches the same kernels alone as inside the whole call, so
the port's tools time stages directly, with CUDA events around the calls
(``stage_ms``), and read the device's busy and idle shares from a
torch.profiler trace (``device_busy``). On the CPU (--device cpu, for the
tests) the clock is the host's and no device share is measured.
"""

import time

import numpy as np
import torch

# the reference shapes: a 601x601x9 BEV raster, a 384x1248 image, the
# stride-8 feature map and the fc width (the tests shrink them)
BEV_HW = (601, 601)
IMAGE_HW = (384, 1248)
FC_DIM = 2048
MAX_GT = 32              # cfg.TPU.MAX_GT: gt rows of a training frame
# the train step's proposal budget and rois (train_mv.py:159-183)
TRAIN_PRE_NMS, TRAIN_POST_NMS, TRAIN_ROIS = 12000, 2000, 128


def feat_hw():
    """The BEV trunk's stride-8 map (75x75 at the reference shape)."""
    return BEV_HW[0] // 8, BEV_HW[1] // 8


def example_calib():
    """The calib blob of __graft_entry__._example_calib (rows P2, P3, R0,
    Tr_velo_to_cam)."""
    calib = np.zeros((4, 12), np.float32)
    calib[0] = [707.0, 0, 601.8, 45.7, 0, 707.0, 183.1, -0.34,
                0, 0, 1.0, 0.005]
    calib[1] = calib[0]
    calib[2, :9] = np.eye(3, dtype=np.float32).reshape(-1)
    calib[3] = [0.0002, -0.9999, -0.0106, -0.002, 0.0104, 0.0106,
                -0.9999, -0.075, 0.9999, 0.0002, 0.0105, -0.272]
    return calib


def he_params(device, seed=0):
    """utils/weights.he_normal_params(seed) on ``device``: distinct RPN
    scores, so the NMS keeps what it would keep on real frames (the JAX
    init's std 0.01 gives all-equal scores)."""
    from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,
                                                  params_from_jax)
    return params_from_jax(he_normal_params(seed, fc_dim=FC_DIM),
                           device=device)


def detector_inputs(batch, device, seed=0):
    """(bev (B,H,W,9) in [0,1), image (B,H',W',3) in [0,255), calib
    (B,4,12)) float32 tensors on device, from a numpy seed (the JAX tools'
    inputs)."""
    rng = np.random.RandomState(seed)
    bev = rng.rand(batch, *BEV_HW, 9).astype(np.float32)
    image = (rng.rand(batch, *IMAGE_HW, 3) * 255).astype(np.float32)
    calib = np.repeat(example_calib()[None], batch, 0)
    return tuple(torch.from_numpy(a).to(device) for a in (bev, image, calib))


def train_batch(device, seed=0, n_gt=4):
    """One training frame at the reference shapes on device: random BEV and
    image, the example calib, and n_gt cars in BEV range (lidar boxes with
    their BEV boxes and corners, class 1) in MAX_GT rows padded as
    data/loader.py:pad_gt leaves them."""
    from mv3d_tf_tpu_torch import geometry as G
    rng = np.random.RandomState(seed)
    x_hi = BEV_HW[0] * 0.1 * 0.85           # inside the raster's 0-60 m
    y_hi = BEV_HW[1] * 0.05 * 0.85
    box = torch.from_numpy(np.stack([
        rng.uniform(x_hi * 0.15, x_hi, n_gt), rng.uniform(-y_hi, y_hi, n_gt),
        np.full(n_gt, -0.95), rng.uniform(3.5, 4.5, n_gt),
        rng.uniform(1.5, 1.9, n_gt), rng.uniform(1.4, 1.7, n_gt)],
        1).astype(np.float32))
    bv = torch.zeros(MAX_GT, 5)
    b3 = torch.zeros(MAX_GT, 7)
    b3[:, 3:6] = 1.0
    cnr = torch.zeros(MAX_GT, 25)
    bv[:n_gt, :4] = G.lidar_3d_to_bv(box)
    b3[:n_gt, :6] = box
    cnr[:n_gt, :24] = G.lidar_3d_to_corners(box)
    bv[:n_gt, 4] = b3[:n_gt, 6] = cnr[:n_gt, 24] = 1.0
    batch = {"bev": torch.from_numpy(rng.rand(*BEV_HW, 9).astype(np.float32)),
             "image": torch.from_numpy(
                 (rng.rand(*IMAGE_HW, 3) * 255).astype(np.float32)),
             "calib": torch.from_numpy(example_calib()),
             "gt_boxes_bv": bv, "gt_boxes_3d": b3, "gt_boxes_corners": cnr,
             "gt_valid": torch.arange(MAX_GT) < n_gt}
    return {k: v.to(device) for k, v in batch.items()}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def stage_ms(fn, device, iters=5, warmup=1):
    """Mean ms per call of fn after warmup calls: CUDA events around iters
    calls on a card (the time the device took, launches included), the
    host clock around them on the CPU. Returns (ms, fn's last result)."""
    out = None
    for _ in range(warmup):
        out = fn()
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / iters, out


def activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def device_busy(fn, device="cuda"):
    """One call of fn under torch.profiler: {"kernels": the device kernels'
    count, "busy_ms": the union of their intervals, "span_ms": the call's
    span (first host event to last device event), "idle_share": the share
    of the span no kernel covers}; None when the profiler saw no device
    kernel (a CPU run)."""
    with torch.profiler.profile(activities=activities(device)) as prof:
        fn()
        sync(device)
    events = prof.events()
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if not dev:
        return None
    busy, end = 0.0, float("-inf")
    for s, e in dev:
        if e > end:
            busy += e - max(s, end)
            end = e
    start = min(e.time_range.start for e in events)
    span = max(end, max(e.time_range.end for e in events)) - start
    return {"kernels": len(dev), "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "idle_share": 1 - busy / span}


def busy_line(fn, device):
    """device_busy(fn) as one printable line."""
    b = device_busy(fn, device)
    if b is None:
        return "device busy: not measured (no device kernel in the trace)"
    return ("%d device kernels, busy %.3f of %.3f ms, idle share %.3f"
            % (b["kernels"], b["busy_ms"], b["span_ms"], b["idle_share"]))


def device_name(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
