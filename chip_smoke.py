"""Smoke run of the PyTorch/CUDA port (mv3d_tf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ (nvcc, sm_90a), checks each against its
plain PyTorch version on the card, then drives the full-shape detector
(601x601x9 BEV, 384x1248x3 image, pre-NMS 6000, post-NMS 300) with random
He-scaled weights: single-frame in float32 and bfloat16, and batched in
bfloat16 with B=4. Every failed check raises, so the exit code is non-zero;
without a CUDA device it exits non-zero before printing any result.
The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and before that a JSON line per kernel.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from mv3d_tf_tpu_torch import kernels
from mv3d_tf_tpu_torch.eval import (PIXEL_MEANS, build_detect_batch_fn,
                                    build_detect_fn, detect_from_features,
                                    frame_detections)
from mv3d_tf_tpu_torch.models import mv3d
from mv3d_tf_tpu_torch.models.vgg import conv2d, layer, max_pool_2x2_valid
from mv3d_tf_tpu_torch.ops.roi_pool import roi_pool, roi_pool_fast
from mv3d_tf_tpu_torch.ops.roi_pool_cuda import roi_pool_cuda
from mv3d_tf_tpu_torch.ops.vgg_stem_cuda import vgg_stem_cuda, vgg_stem_plain
from mv3d_tf_tpu_torch.utils.weights import he_normal_params, params_from_jax

SEED = 0
PRE_NMS, POST_NMS = 6000, 300
STEM_TOL = 2 ** -7    # one bf16 ulp of the max magnitude (+1e-6)
ROI_SOURCE = "mv3d_tf_tpu_torch/csrc/roi_pool.cu"
STEM_SOURCE = "mv3d_tf_tpu_torch/csrc/vgg_stem.cu"


def example_calib():
    """The calib blob of __graft_entry__._example_calib (rows P2, P3, R0, Tr)."""
    calib = np.zeros((4, 12), np.float32)
    calib[0] = [707.0, 0, 601.8, 45.7, 0, 707.0, 183.1, -0.34,
                0, 0, 1.0, 0.005]
    calib[1] = calib[0]
    calib[2, :9] = np.eye(3, dtype=np.float32).reshape(-1)
    calib[3] = [0.0002, -0.9999, -0.0106, -0.002, 0.0104, 0.0106,
                -0.9999, -0.075, 0.9999, 0.0002, 0.0105, -0.272]
    return calib


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, by CUDA events around iters calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(
        [kernels.nvcc_path(), "--version"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    kernels.library()
    load_s = time.perf_counter() - t0
    print("environment: gpu=[%s] torch=%s cuda=%s nvcc=[%s] nvcc_build_s=%.2f "
          "build_and_load_s=%.2f" % (smi, torch.__version__, torch.version.cuda,
                                     nvcc, kernels.build_info["seconds"],
                                     load_s))
    for line in kernels.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    return smi


def make_rois(gen, n, in_h, in_w, frames):
    """n random rois over `frames` frames (some past the map edge) plus the
    edge cases: the right/bottom-edge and whole-map rois of
    tools/tpu_selfcheck.py:78-80 scaled to the map, rois past the image
    edge, a degenerate point and a malformed roi (x2 < x1)."""
    x1 = torch.rand(n, generator=gen) * (in_w + 100) - 50
    y1 = torch.rand(n, generator=gen) * (in_h + 100) - 50
    rois = torch.stack([
        torch.randint(0, frames, (n,), generator=gen).float(), x1, y1,
        x1 + torch.rand(n, generator=gen) * in_w / 4 + 2,
        y1 + torch.rand(n, generator=gen) * in_h / 4 + 2], 1)
    edge = torch.tensor([
        [0, in_w - 8, in_h - 8, in_w - 1, in_h - 1],
        [0, 0, 0, in_w - 1, in_h - 1],
        [0, -40, -40, in_w + 40, in_h + 40],
        [0, in_w - 20, in_h - 20, in_w + 60, in_h + 60],
        [0, 300, 200, 300, 200],
        [0, 200, 100, 120, 180]], dtype=torch.float32)
    edge[:, 0] = frames - 1
    return torch.cat([rois, edge]).cuda()


def phase_roi_pool(gen):
    """Kernel vs plain on the card: bit-identical in float32 and bf16, on
    BEV (2,75,75,512) and image (2,48,156,512) maps with ~600 rois; then the
    time of one batched-detector call's pools (B=4, 1200 rois a view)."""
    maps = {"bev": ((2, 75, 75, 512), 600, 600),
            "image": ((2, 48, 156, 512), 384, 1248)}
    worst = 0.0
    for name, (shape, in_h, in_w) in maps.items():
        feat32 = torch.randn(shape, generator=gen).cuda()
        rois = make_rois(gen, 594, in_h, in_w, shape[0])
        for dtype in (torch.float32, torch.bfloat16):
            feat = feat32.to(dtype)
            got = roi_pool_cuda(feat, rois)
            ref = roi_pool(feat, rois)
            err = (got.float() - ref.float()).abs().max().item()
            if not torch.equal(got, ref):
                raise AssertionError("roi_pool_cuda != plain on %s %s: max "
                                     "|diff| %g" % (name, dtype, err))
            worst = max(worst, err)
            print("roi_pool %s %s %s rois=%d: bit-identical to plain" % (
                name, dtype, tuple(shape), rois.shape[0]))
            # NaN in ~0.1% of cells: a bin holding one gives NaN in both
            feat = torch.where(torch.rand(shape, generator=gen).cuda() < 1e-3,
                               float("nan"), feat32).to(dtype)
            got = roi_pool_cuda(feat, rois)
            ref = roi_pool(feat, rois)
            nan = ref.isnan()
            if not (nan.any() and torch.equal(got.isnan(), nan)
                    and torch.equal(got.nan_to_num(0.0), ref.nan_to_num(0.0))):
                raise AssertionError("roi_pool_cuda != plain on %s %s with "
                                     "NaN cells" % (name, dtype))
            print("roi_pool %s %s with NaN cells: equal to plain, NaN in the "
                  "same %d outputs" % (name, dtype, int(nan.sum())))
    ms = plain_ms = 0.0
    for name, shape, in_h, in_w in (("bev", (4, 75, 75, 512), 600, 600),
                                    ("image", (4, 48, 156, 512), 384, 1248)):
        feat = torch.randn(shape, generator=gen).cuda().to(torch.bfloat16)
        rois = make_rois(gen, 1194, in_h, in_w, 4)
        k = cuda_ms(lambda: roi_pool_cuda(feat, rois))
        p = cuda_ms(lambda: roi_pool(feat, rois), iters=5)
        print("roi_pool time %s bf16 %s rois=%d: kernel %.4f ms, plain %.4f ms"
              % (name, shape, rois.shape[0], k, p))
        ms, plain_ms = ms + k, plain_ms + p
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def stem_halo_leak(x, w1, b1, w2, b2):
    """The plain stem as it comes out if conv1_2's SAME padding holds
    relu(conv1_1's bias) instead of 0: the trap the check must tell apart."""
    y = conv2d(x, w1, b1, dtype=torch.bfloat16)
    B, H, W, C = y.shape
    padded = F.relu(b1).to(y.dtype).expand(B, H + 2, W + 2, C).clone()
    padded[:, 1:-1, 1:-1] = y
    return max_pool_2x2_valid(conv2d(padded, w2, b2, padding="VALID",
                                     dtype=torch.bfloat16))


def phase_stem(params):
    """Kernel vs plain on the card at the detector's stem shapes, with the
    batched detector's B=4 of distinct frames, and at a narrow shape,
    within STEM_TOL of the max magnitude; then the time of one frame's two
    stems. The biases are drawn here, nonzero (the detector's He params
    have zero biases): b1 in [0.5, 1), so relu(b1) in conv1_2's padding
    would show, and b2 of both signs."""
    gen = torch.Generator().manual_seed(SEED + 1)
    means = torch.from_numpy(PIXEL_MEANS)
    inputs = {
        "bev": (torch.rand((4, 601, 601, 9), generator=gen), ""),
        "image": (torch.rand((4, 384, 1248, 3), generator=gen) * 255 - means,
                  "_2"),
        "narrow": (torch.rand((2, 36, 200, 9), generator=gen), ""),
    }
    worst = 0.0
    ms = plain_ms = 0.0
    for name, (x, suffix) in inputs.items():
        x = x.cuda()
        b1 = (0.5 + 0.5 * torch.rand(64, generator=gen)).cuda()
        b2 = (0.1 * torch.randn(64, generator=gen)).cuda()
        w = (layer(params, "conv1_1" + suffix)[0], b1,
             layer(params, "conv1_2" + suffix)[0], b2)
        with torch.inference_mode():
            got = vgg_stem_cuda(x, *w)
            ref = vgg_stem_plain(x, *w)
            leak = stem_halo_leak(x, *w)
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != torch.bfloat16:
            raise AssertionError("stem %s: %s %s vs %s" % (
                name, got.dtype, tuple(got.shape), tuple(ref.shape)))
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = STEM_TOL * scale + 1e-6
        if not err <= tol:
            raise AssertionError("stem %s: max |diff| %g > %g * %g" % (
                name, err, STEM_TOL, scale))
        leak_err = (leak.float() - ref.float()).abs().max().item()
        if not leak_err > tol:
            raise AssertionError("stem %s: a relu(b1) halo would pass the "
                                 "check (%g <= %g)" % (name, leak_err, tol))
        worst = max(worst, err)
        line = ("stem %s %s: max |diff| %g, max |ref| %g; a relu(b1) halo "
                "would be off by %g" % (name, tuple(x.shape), err, scale,
                                        leak_err))
        if name != "narrow":
            x1 = x[:1]
            with torch.inference_mode():
                k = cuda_ms(lambda: vgg_stem_cuda(x1, *w), iters=10)
                p = cuda_ms(lambda: vgg_stem_plain(x1, *w), iters=10)
            ms, plain_ms = ms + k, plain_ms + p
            line += "; one frame: kernel %.4f ms, plain %.4f ms" % (k, p)
        print(line)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def check_outputs(out, lead, what):
    shapes = {"scores": (2,), "boxes_bv": (8,), "boxes_cnr": (48,),
              "boxes_cnr_r": (48,), "rois_3d": (7,), "valid": ()}
    if len(lead) == 1:
        shapes["rois_img"] = (5,)
    if set(out) != set(shapes):
        raise AssertionError("%s: keys %s" % (what, sorted(out)))
    for key, tail in shapes.items():
        v = out[key]
        if tuple(v.shape) != lead + tail:
            raise AssertionError("%s: %s has shape %s" % (
                what, key, tuple(v.shape)))
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise AssertionError("%s: %s is not finite" % (what, key))
    if not out["valid"].any():
        raise AssertionError("%s: no valid proposal" % what)


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_detector(params, smi):
    """The main path at full shape. Returns the kernels' launch counts,
    read just after the detector runs (the counts are zeroed just before)."""
    rng = np.random.RandomState(SEED)
    frames = 4
    bev = torch.from_numpy(rng.rand(frames, 601, 601, 9).astype(np.float32))
    image = torch.from_numpy(
        (rng.rand(frames, 384, 1248, 3) * 255).astype(np.float32))
    calib = torch.from_numpy(np.stack([example_calib()] * frames))
    bev, image, calib = bev.cuda(), image.cuda(), calib.cuda()
    kw = dict(pre_nms_top_n=PRE_NMS, post_nms_top_n=POST_NMS)
    runs = {"f32 single-frame": build_detect_fn(**kw),
            "bf16 single-frame": build_detect_fn(
                compute_dtype=torch.bfloat16, **kw)}
    detect_b = build_detect_batch_fn(compute_dtype=torch.bfloat16, **kw)
    roi_pool_cuda.launches = vgg_stem_cuda.launches = 0
    outputs = {}
    for name, detect in runs.items():
        timed(detect, params, bev[0], image[0], calib[0])     # warm-up
        times = []
        for i in range(frames):
            out, ms = timed(detect, params, bev[i], image[i], calib[i])
            check_outputs(out, (POST_NMS,), name)
            outputs[(name, i)] = out
            times.append(ms)
        print("detector %s: p50 %.3f ms/frame over %d frames (%s) on [%s]" % (
            name, float(np.median(times)), frames,
            ", ".join("%.3f" % t for t in times), smi))
    batch_calls = 3
    timed(detect_b, params, bev, image, calib)                # warm-up
    times = []
    for _ in range(batch_calls):
        out, ms = timed(detect_b, params, bev, image, calib)
        check_outputs(out, (frames, POST_NMS), "bf16 batch")
        times.append(ms / frames)
    print("detector bf16 batch B=%d: p50 %.3f ms/frame over %d calls (%s) "
          "on [%s]" % (frames, float(np.median(times)), batch_calls,
                    ", ".join("%.3f" % t for t in times), smi))
    launches = {"roi_pool": roi_pool_cuda.launches,
                "vgg_stem": vgg_stem_cuda.launches}
    # two pools per detector call, two stems per bf16 call; warm-ups count
    single_calls, batch_calls = frames + 1, batch_calls + 1
    expected = {"roi_pool": 2 * (2 * single_calls + batch_calls),
                "vgg_stem": 2 * (single_calls + batch_calls)}
    print("main-path launches: %s (expected %s)" % (launches, expected))
    if launches != expected:
        raise AssertionError("kernel launch counts %s != %s"
                             % (launches, expected))
    for i in range(frames):
        outputs[("bf16 batch", i)] = {k: v[i] for k, v in out.items()}

    # f32 tail from the same trunk features: ROI kernel vs plain pool
    with torch.inference_mode():
        image0 = image[:1] - torch.from_numpy(PIXEL_MEANS).cuda()
        c5, c5_2 = mv3d.extract_features(params, bev[:1], image0)
        tail = {name: detect_from_features(params, c5, c5_2, calib[:1],
                                           pool=pool, **kw)
                for name, pool in (("kernel", roi_pool_fast),
                                   ("plain", roi_pool))}
    mismatched = [k for k in tail["kernel"]
                  if not torch.equal(tail["kernel"][k], tail["plain"][k])]
    if mismatched:
        raise AssertionError("f32 tail through the ROI kernel differs from "
                             "the plain pool in %s" % mismatched)
    print("f32 tail (proposals -> pool -> head) bit-identical through the ROI "
          "kernel and the plain pool")

    n_det = [sum(len(d[0]) for d in frame_detections(out).values())
             for out in outputs.values()]
    print("frame_detections: %d frames, detections per frame %s"
          % (len(n_det), n_det))
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this run needs an NVIDIA GPU")
    smi = phase_environment()
    gen = torch.Generator().manual_seed(SEED)
    roi = phase_roi_pool(gen)
    params = params_from_jax(he_normal_params(SEED), device="cuda")
    stem = phase_stem(params)
    launches = phase_detector(params, smi)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": [
        {"name": "roi_pool", "route": "cuda", "source": ROI_SOURCE,
         "replaces": "mv3d_tf_tpu/ops/roi_pool_pallas.py:71",
         "launches": launches["roi_pool"], **roi},
        {"name": "vgg_stem", "route": "cuda", "source": STEM_SOURCE,
         "replaces": "mv3d_tf_tpu/ops/vgg_stem_pallas.py:106",
         "launches": launches["vgg_stem"], **stem},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
