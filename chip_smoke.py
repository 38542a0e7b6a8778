"""Smoke run of the PyTorch/CUDA port (mv3d_tf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ (nvcc, sm_90a), checks each against its
plain PyTorch version on the card (the literal stem's kernel, which is the
fused s2d stem's bf16 kernel, against both stems' plain versions), then
drives the full-shape detector
(601x601x9 BEV, 384x1248x3 image, pre-NMS 6000, post-NMS 300) with random
He-scaled weights: single-frame in float32 and bfloat16, and batched in
bfloat16 with B=4. Then it checks the ROI-pool backward kernel against its
plain version and takes full-width train steps (pre-NMS 12000, post-NMS
2000, 128 rois, Adam) in float32 and bfloat16 through both ROI kernels.
Last, the LiDAR front end on KITTI-scale scans (8 x 131072 points, the
traffic of bench.py): the BEV placement kernel against its plain version
and the whole rasterizer against the numpy twin, bit for bit; the
read_lidar CLI over 16 scans on disk; and scan -> raster -> detections in
float32, bfloat16 and batched bfloat16.
Then the int8 detector: the s8 convolution kernels against their plain
versions at every shape of the int8 path (both views' trunk layers on
weights prepared once, the packed conv1_2 of the s2d stem, the RPN conv in
float32 output) and at edge shapes, the s8 GEMM on prepared (N, K) weights
at the fc6/fc7 shapes and five edge shapes, all bit for bit, beside
torch._int_mm on the same bytes; then PTQ calibration on 4 frames and
the int8 detector (s2d_int8 stem, int8 RPN, int8 ROI pool and head,
pre-NMS 1024, post-NMS 300) at B=8, with the kernel route held bit for bit
to the plain route at B=2.
Then the fused space-to-depth stem: its kernel against its plain version in
float32 and bfloat16 at the detector's shapes, four odd and even small
ones and four off the bf16 kernel's tile, and the plain version without the
edge mask shown to miss; the
batched detectors with stem_impl="s2d_fused" (bf16 at B=4, int8 at B=8);
and the evaluation entry points on a synthetic KITTI tree that the port
writes: tools/test_net over its val split (bf16, and int8 with the s2d_int8
stem) and tools/quant_check with the s2d_fused stem.
Then the blocked NMS on the proposal layer's own candidates at the train
step's shape (pre-NMS 12000, post-NMS 2000) and at test_net's (B=8): keep
sets equal to the greedy loop's, the fixed variant certified, a 40-box
chain that leaves its certificate False, and the layer's time on the
greedy and on the blocked route in turns; solver.train_net on a second
synthetic tree (8 train frames, bf16, the train set on the card: 6
iterations with a trace, then tools/train_net --resume to 8, then 2
iterations on the host feed); and tools/demo_mv on one of its frames, with
and without the frame's raster file. Then tools/accuracy_eval on that tree
in two segments with the LR decay, a constant-lr resume of its decayed
snapshot refused; the trace and profile tools at the reference shapes,
each launching (and the traces naming) their hand kernels; and
tools/tracklet2label -> a kitti_raw imdb -> two train_net iterations. The
host code in C++ (the velodyne loader, the host BEV raster of read_lidar
--host, the AP matcher) is held to its numpy versions along the way.
Last, the legacy 2D Faster R-CNN at full width (VGG16, stride 16, fc 4096,
21 classes, He weights): both ROI kernels at its shapes (2000 rois on a
38x64x512 conv5_3 at 1/16; the gradient on 128) against their plain
versions; im_detect_2d on a 608x1024 image in float32 and bf16 (pre-NMS
12000, post-NMS 2000) against the plain pool, with nms_matrix's keep set
held to the host greedy loop; full-width 2D train steps (momentum SGD,
conv1/conv2 frozen); and tools.train_net / tools.test_net with VGGnet*
and tools.demo on a synthetic VOC tree. Then Fast R-CNN over precomputed
proposals, the 2D config's default: the ROI gradient kernel over a batched
map (8 pyramid levels of 38x64x512) against its plain version, the 3-D call
held to the B = 1 call and the plain version bit for bit; the full-width
Fast R-CNN step (2 images, 128 rois) at 2 pyramid levels and at
kitti_rcnn.yml's 8, in float32 and bf16, its gradients through the kernel
pair held to the plain pair's; and the alternating-optimisation flow:
rpn_generate's proposal files, PascalVOC.region_proposal_roidb,
tools.train_net VGGnet_train with HAS_RPN off in a subprocess without jax,
and tools.test_net VGGnet_test on its snapshot.
Then the multi-device layer and the last tools: multi-host tools.test_net
over the tree's 8 val frames (two shard processes without jax, then the
merge, byte for byte the plain run's); bench_ab, microbench_int8,
prenms_knee, profile_detect and profile_loo once each; parallel/mesh.py on
two ranks sharing the card over gloo, which first run the dry run's own
spec and checks (the data-parallel train step in f32 and bf16, its
all-reduced gradients held to the mean-loss gradients taken frame by
frame, one NCCL rank beside it; frame-parallel bf16 detection at B=4;
row-sharded detection of one frame in f32 and bf16, the stems and ROI
kernels on band shapes); and tools.gpu_selfcheck in a process of its own.
Every failed check raises, so the exit code is non-zero; without a CUDA
device it exits non-zero before printing any result.
The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and before that a JSON line per kernel.
"""

import concurrent.futures
import contextlib
import copy
import io
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from mv3d_tf_tpu_torch import eval as eval_mod
from mv3d_tf_tpu_torch import faster_rcnn_2d as F2
from mv3d_tf_tpu_torch import geometry as G
from mv3d_tf_tpu_torch import kernels
from mv3d_tf_tpu_torch import proposals as proposals_mod
from mv3d_tf_tpu_torch import quant as Q
from mv3d_tf_tpu_torch import rpn_generate
from mv3d_tf_tpu_torch import solver as solver_mod
from mv3d_tf_tpu_torch import train as train_mod
from mv3d_tf_tpu_torch.config import cfg, cfg_from_file, get_output_dir
from mv3d_tf_tpu_torch.data import multiscale as MS
from mv3d_tf_tpu_torch.data import synthetic
from mv3d_tf_tpu_torch.data.kitti import get_imdb, prepare_roidb
from mv3d_tf_tpu_torch.data.kitti_raw import KittiRaw
from mv3d_tf_tpu_torch.data.kitti_eval import (evaluate_kitti_bev,
                                               evaluate_kitti_official)
from mv3d_tf_tpu_torch.data.pascal_voc import PascalVOC
from mv3d_tf_tpu_torch.eval import (PIXEL_MEANS, build_detect_batch_fn,
                                    build_detect_fn, detect_from_features,
                                    frame_detections)
from mv3d_tf_tpu_torch.models import mv3d
from mv3d_tf_tpu_torch.data.blob import make_bird_view
from mv3d_tf_tpu_torch.models.vgg import (conv2d, layer, max_pool_2x2_valid,
                                          module_key, trunk_apply)
from mv3d_tf_tpu_torch.ops import bev, conv_s8_cuda
from mv3d_tf_tpu_torch.ops import conv_s8 as S8
from mv3d_tf_tpu_torch.ops import roi_pool_cuda as roi_pool_cuda_mod
from mv3d_tf_tpu_torch.ops.bev_cuda import (CHUNK_CELLS, N_FLAT,
                                            bev_place_cuda, bev_place_plain)
from mv3d_tf_tpu_torch.ops.iou import bbox_overlaps
from mv3d_tf_tpu_torch.ops.nms import (nms, nms_blocked, nms_blocked_fixed,
                                       nms_matrix, nms_np)
from mv3d_tf_tpu_torch.ops.conv_s8_cuda import (conv2x2_s8_cuda,
                                                conv2x2_s8_nk_cuda,
                                                conv3x3_s8_cuda,
                                                conv3x3_s8_nk_cuda,
                                                matmul_s8_cuda,
                                                matmul_s8_nk_cuda)
from mv3d_tf_tpu_torch.ops.roi_pool import (bin_bounds, bin_cells,
                                            boundary_rois, roi_pool,
                                            roi_pool_bwd, roi_pool_fast,
                                            roi_pool_train,
                                            roi_pool_train_plain)
from mv3d_tf_tpu_torch.ops.roi_pool_cuda import roi_pool_bwd_cuda, roi_pool_cuda
from mv3d_tf_tpu_torch.ops.stem_s2d import _conv as s2d_conv
from mv3d_tf_tpu_torch.ops.stem_s2d import (group_max, hwio,
                                            pack_stem_weights, stem_s2d)
from mv3d_tf_tpu_torch.ops.stem_s2d_cuda import (stem_s2d_fused_cuda,
                                                 stem_s2d_fused_plain)
from mv3d_tf_tpu_torch.ops.vgg_stem_cuda import vgg_stem_cuda, vgg_stem_plain
from mv3d_tf_tpu_torch.parallel import dryrun as PD
from mv3d_tf_tpu_torch.parallel import mesh as PM
from mv3d_tf_tpu_torch.tools import (accuracy_eval, bench_ab, demo_mv,
                                     microbench_int8, prenms_knee,
                                     profile_bev, profile_detect, profile_loo,
                                     profile_stages, profile_train, profiling,
                                     quant_check, read_lidar, test_net,
                                     trace_detect, trace_train, tracklet2label)
from mv3d_tf_tpu_torch.tools import demo as demo_2d
from mv3d_tf_tpu_torch.tools import train_net as train_net_cli
from mv3d_tf_tpu_torch.train import (build_forward_losses, build_train_step,
                                     make_draws)
from mv3d_tf_tpu_torch.utils import native
from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,
                                             he_normal_params_2d,
                                             params_from_jax)

SEED = 0
PRE_NMS, POST_NMS = 6000, 300
STEM_TOL = 2 ** -7    # one bf16 ulp of the max magnitude (+1e-6)
# the backward kernel sums with f32 atomics in another order than the plain
# version's index_add_; tie counts are exact, so only the sums' rounding
BWD_RTOL, BWD_ATOL = 1e-5, 1e-7
ROI_SOURCE = "mv3d_tf_tpu_torch/csrc/roi_pool.cu"
BWD_SOURCE = "mv3d_tf_tpu_torch/csrc/roi_pool_bwd.cu"
BEV_SOURCE = "mv3d_tf_tpu_torch/csrc/bev_place.cu"
CONV_S8_SOURCE = "mv3d_tf_tpu_torch/csrc/conv_s8.cu"
MATMUL_S8_SOURCE = "mv3d_tf_tpu_torch/csrc/matmul_s8.cu"
S2D_SOURCE = "mv3d_tf_tpu_torch/csrc/stem_s2d.cu"   # both stems' kernel
TRAIN_STEPS = 3
TRAIN_PRE_NMS, TRAIN_POST_NMS, TRAIN_ROIS, FC_DIM = 12000, 2000, 128, 2048
MAX_GT = 32           # the config's TPU.MAX_GT: gt rows per frame
TRAIN_BEV, TRAIN_IMAGE, FEAT = (601, 601, 9), (384, 1248, 3), 75
# the train pools' maps (stride-8 conv5_3 of each view) and input extents
BWD_VIEWS = {"bev": ((75, 75, 512), 600, 600),
             "image": ((48, 156, 512), 384, 1248)}
SCANS, SCAN_POINTS = 8, 131072   # bench.py:164-176: B=8 scans of 131072
CLI_SCANS = 16
# one H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s,
# float32 outside the tensor cores and dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S, F32_PER_S, BF16_PER_S = 3.35e12, 67e12, 989e12
INT8_PER_S = 1979e12  # dense int8 tensor-core operations/s
# the int8 detector of bench.py:201-205: s2d int8 stem, int8 RPN, int8 head,
# pre-NMS 1024; B=8 frames a call, PTQ calibrated on CALIB_FRAMES frames
INT8_B, INT8_PRE_NMS, CALIB_FRAMES, PLAIN_B = 8, 1024, 4, 2
INT8_KW = dict(stem_impl="s2d_int8", quant_rpn=True, nms_impl="blocked_fixed",
               pre_nms_top_n=INT8_PRE_NMS, post_nms_top_n=POST_NMS)
# each view's stem output (H, W): the s8 trunk convs run from there
S8_VIEWS = {"bev": (300, 300), "image": (192, 624)}
# the evaluation CLIs' synthetic KITTI tree: half train, half val
EVAL_FRAMES = 16
TRAIN_FRAMES = 8      # train_net's and the demo's tree: 8 train, 8 val
NATIVE_LIBS = ("mv3d_loader", "bev_raster", "kitti_eval")


def max_err(got, ref):
    """max |got - ref| over two tensors of one shape, taken in float64 (exact
    for int8, int32 and float32 values)."""
    return (got.double() - ref.double()).abs().max().item()


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(parts, peak):
    """The least time the card could take for launches given as (bytes
    read and written once, operations) pairs: per launch the larger of
    bytes / HBM rate and operations / peak, summed; bound_by names the
    larger of the two sums."""
    by_bytes = [b / HBM_BYTES_PER_S * 1e3 for b, _ in parts]
    by_ops = [o / peak * 1e3 for _, o in parts]
    return {"bound_ms": sum(max(b, o) for b, o in zip(by_bytes, by_ops)),
            "bound_by": ("bytes" if sum(by_bytes) >= sum(by_ops)
                         else "operations")}


def bin_cells_total(rois, H, W, scale=1.0 / 8):
    """The feature cells that the rois' 7x7 bins cover, summed over bins."""
    hs, he, ws, we = bin_bounds(rois, 7, scale, H, W).unbind(1)
    return ((he - hs).clamp(min=0)[:, :, None]
            * (we - ws).clamp(min=0)[:, None, :]).sum().item()


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
    # the host code's g++ builds (one process per source) beside nvcc's
    with concurrent.futures.ThreadPoolExecutor(len(NATIVE_LIBS)) as pool:
        native_libs = pool.map(native.build, NATIVE_LIBS)
        kernels.library()
        load_s = time.perf_counter() - t0
        native_libs = [os.path.basename(p) for p in native_libs]
    native_s = time.perf_counter() - t0
    print("environment: gpu=[%s] torch=%s cuda=%s nvcc=[%s] nvcc_build_s=%.2f "
          "build_and_load_s=%.2f; g++ host code %s in %.2f s" % (
              smi, torch.__version__, torch.version.cuda, nvcc,
              kernels.build_info["seconds"], load_s, native_libs, native_s))
    # one line per kernel: its (mangled) name, registers and spills
    entry, spill = None, ""
    for line in kernels.build_info["log"].splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.split(":", 1)[-1].strip()
        elif "Used" in line and "registers" in line and entry:
            print("ptxas: %s: %s; %s" % (
                entry, line.split(":", 1)[-1].strip(), spill))
            entry = None
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


# the round boundaries of both ROI kernels: a block's 2 slices take a bin's
# cells in turn, 4 loads a lane a round, so bins of 2, 8, 16 and 32 cells
# end a round exactly and one cell more starts another
SPLIT_CELLS = (2, 3, 8, 9, 16, 17, 32, 33)


def stress_rois(in_h, in_w, frame):
    """64 whole-map and beyond-map rois (up to 84 px past every edge) on one
    frame, then rois whose 7x7 bins hold exactly SPLIT_CELLS cells each
    (a roi of 7*bh x 7*bw cells from the map's corner), as far as the map
    has room for them."""
    k = torch.arange(64, dtype=torch.float32)
    a, b = (k % 8) * 12, (k // 8) * 12
    rois = [torch.stack([torch.full_like(k, frame), -a, -b, in_w - 1 + b,
                         in_h - 1 + a], 1)]
    H, W = in_h // 8, in_w // 8
    for n in SPLIT_CELLS:
        for bh in range(1, n + 1):
            bw = n // bh
            if bh * bw == n and 7 * bh <= H and 7 * bw <= W:
                rois.append(torch.tensor([[frame, 0, 0, 8 * (7 * bw - 1),
                                           8 * (7 * bh - 1)]],
                                         dtype=torch.float32))
    return torch.cat(rois).cuda()


def check_rois(gen, n, in_h, in_w, frames):
    """The check set: make_rois' random and edge rois, the boundary rois
    that the CPU tests hold bin_bounds and the plain pool to JAX on, and
    the stress rois on the last frame."""
    return torch.cat([make_rois(gen, n, in_h, in_w, frames),
                      boundary_rois(in_h, in_w, frames).cuda(),
                      stress_rois(in_h, in_w, frames - 1)])


def roi_entry(feat, rois, out, scale=1.0 / 8):
    """One launch of the forward kernel's C entry point, without the
    wrapper (no checks, no allocation, no count): the kernel alone."""
    fn = getattr(kernels.library(), roi_pool_cuda_mod._ENTRY[feat.dtype])
    B, H, W, C = feat.shape
    args = (feat.data_ptr(), rois.data_ptr(), out.data_ptr(), B, H, W, C,
            rois.shape[0], 7, scale, torch.cuda.current_stream().cuda_stream)
    # the default argument keeps the tensors behind the pointers alive
    return lambda keep=(feat, rois, out): kernels.check(fn(*args),
                                                        "roi_pool entry")


def roi_bwd_entry(feat, rois, out, dy, dfeat, scale=1.0 / 8):
    """One launch of the backward kernel's C entry point, without the
    wrapper: the kernel alone, adding into dfeat. feat (H,W,C) is the
    launch with B = 1."""
    fn = getattr(kernels.library(), roi_pool_cuda_mod._BWD_ENTRY[feat.dtype])
    B, H, W, C = feat.shape if feat.dim() == 4 else (1, *feat.shape)
    args = (feat.data_ptr(), rois.data_ptr(), out.data_ptr(), dy.data_ptr(),
            dfeat.data_ptr(), B, H, W, C, rois.shape[0], 7, scale,
            torch.cuda.current_stream().cuda_stream)
    return lambda keep=(feat, rois, out, dy, dfeat): kernels.check(
        fn(*args), "roi_pool_bwd entry")


def time_roi_pool(name, feat, rois, what):
    """The kernel alone (20 raw launches), the same without make_rois' six
    edge rois, the wrapper and the plain pool; the bytes the bins read and
    the rate over them. Returns (kernel ms, plain ms, bound part)."""
    out = roi_pool_cuda(feat, rois)
    k = cuda_ms(roi_entry(feat, rois, out))
    core = rois[:-6]
    k_core = cuda_ms(roi_entry(feat, core, out))
    wrapper = cuda_ms(lambda: roi_pool_cuda(feat, rois))
    p = cuda_ms(lambda: roi_pool(feat, rois), iters=3, warmup=1)
    # each bin reads its cells once; the output is written once
    moved = (bin_cells_total(rois, *feat.shape[1:3]) * feat.shape[3]
             * feat.element_size() + nbytes(out))
    print("roi_pool time %s %s %s rois=%d: kernel alone %.4f ms (%.4f "
          "without the 6 edge rois), wrapper %.4f ms, plain %.4f ms; bins "
          "read %.1f MB + out %.1f MB, %.0f GB/s" % (
              name, what, tuple(feat.shape), rois.shape[0], k, k_core,
              wrapper, p, (moved - nbytes(out)) / 1e6, nbytes(out) / 1e6,
              moved / k / 1e6))
    # one max per covered cell and channel
    return k, p, (nbytes(feat, rois, out),
                  bin_cells_total(rois, *feat.shape[1:3]) * feat.shape[3])


def phase_roi_pool(gen):
    """Kernel vs plain on the card: bit-identical in float32 and bf16, on
    BEV (2,75,75,512) and image (2,48,156,512) maps with ~600 random and
    edge rois, the boundary rois and the stress rois; then the time of one
    batched-detector call's pools (B=4, 1200 rois a view)."""
    maps = {"bev": ((2, 75, 75, 512), 600, 600),
            "image": ((2, 48, 156, 512), 384, 1248)}
    worst = 0.0
    for name, (shape, in_h, in_w) in maps.items():
        feat32 = torch.randn(shape, generator=gen).cuda()
        rois = check_rois(gen, 594, in_h, in_w, shape[0])
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
        hs, he, ws, we = bin_bounds(rois, 7, 1.0 / 8, *shape[1:3]).unbind(1)
        cells = ((he - hs).clamp(min=0)[:, :, None]
                 * (we - ws).clamp(min=0)[:, None, :])
        print("roi_pool %s check set: bins of %s cells present, largest %d"
              % (name, [n for n in SPLIT_CELLS if (cells == n).any()],
                 int(cells.max())))
    roi_pool_s8_check()
    roi_unpacked_check(gen)
    ms = plain_ms = 0.0
    parts = []
    for name, shape, in_h, in_w in (("bev", (4, 75, 75, 512), 600, 600),
                                    ("image", (4, 48, 156, 512), 384, 1248)):
        feat = torch.randn(shape, generator=gen).cuda().to(torch.bfloat16)
        rois = make_rois(gen, 1194, in_h, in_w, 4)
        k, p, part = time_roi_pool(name, feat, rois, "bf16")
        parts.append(part)
        ms, plain_ms = ms + k, plain_ms + p
    # no single PyTorch call pools rois with these integer bins
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **bound(parts, F32_PER_S), "library_ms": None}


def roi_unpacked_check(gen):
    """Both kernels one channel a lane, where 16-byte loads do not fit: C
    not a multiple of the pack (18 float32, 20 bf16 and int8 channels) and
    a float32 map 4 bytes off a 16-byte boundary; forward bit for bit,
    backward within its tolerance."""
    for dtype, C, offset in ((torch.float32, 18, 0), (torch.bfloat16, 20, 0),
                             (torch.int8, 20, 0), (torch.float32, 512, 1)):
        shape = (2, 11, 15, C)
        n = int(np.prod(shape))
        x = torch.randn(n + offset, generator=gen).cuda()[offset:].view(shape)
        # float32 at offset 1 stays the view, 4 bytes past its storage
        feat = (x * 40).clamp(-128, 127).to(dtype) if dtype == torch.int8 \
            else x.to(dtype)
        rois = check_rois(gen, 40, 88, 120, 2)
        if not torch.equal(roi_pool_cuda(feat, rois), roi_pool(feat, rois)):
            raise AssertionError("roi_pool_cuda != plain, %s C=%d offset %d"
                                 % (dtype, C, offset))
        if dtype != torch.int8:
            one, rs = feat[1], rois.clone()
            rs[:, 0] = 0
            out = roi_pool_cuda(one, rs)
            dy = torch.rand(out.shape, generator=gen).cuda()
            got = roi_pool_bwd_cuda(one, rs, out, dy)
            ref = roi_pool_bwd(one, rs, out, dy)
            err = (got - ref).abs().max().item()
            if not err <= BWD_RTOL * ref.abs().max().item() + BWD_ATOL:
                raise AssertionError("roi_pool_bwd_cuda != plain, %s C=%d "
                                     "offset %d: %g" % (dtype, C, offset, err))
        print("roi_pool unpacked %s C=%d, map %d bytes off 16: forward "
              "bit-identical%s" % (dtype, C, 4 * offset,
                                   "" if dtype == torch.int8
                                   else ", backward within tolerance"))


def roi_pool_s8_check():
    """The int8 kernel against the plain pool on int8 maps of both signs
    (the int8 detector pools its trunk codes), on the check set,
    bit-identical; then its time at the int8 detector's shapes (B=8, 2400
    rois a view), printed beside the plain pool's."""
    gen = torch.Generator().manual_seed(SEED + 8)
    for name, shape, in_h, in_w in (("bev", (2, 75, 75, 512), 600, 600),
                                    ("image", (2, 48, 156, 512), 384, 1248)):
        feat = torch.randint(-128, 128, shape, generator=gen,
                             dtype=torch.int8).cuda()
        rois = check_rois(gen, 594, in_h, in_w, shape[0])
        got = roi_pool_cuda(feat, rois)
        ref = roi_pool(feat, rois)
        if got.dtype != torch.int8 or not torch.equal(got, ref):
            raise AssertionError("roi_pool_cuda != plain on %s int8" % name)
        print("roi_pool %s int8 %s rois=%d: bit-identical to plain (%d empty "
              "bins give 0)" % (name, tuple(shape), rois.shape[0],
                                int((ref == 0).all(-1).sum())))
    for name, shape, in_h, in_w in (
            ("bev", (INT8_B, 75, 75, 512), 600, 600),
            ("image", (INT8_B, 48, 156, 512), 384, 1248)):
        feat = torch.randint(0, 128, shape, generator=gen,
                             dtype=torch.int8).cuda()
        rois = make_rois(gen, INT8_B * POST_NMS - 6, in_h, in_w, INT8_B)
        time_roi_pool(name, feat, rois, "int8")


def stem_halo_leak(x, w1, b1, w2, b2):
    """The plain stem as it comes out if conv1_2's SAME padding holds
    relu(conv1_1's bias) instead of 0: the trap the check must tell apart."""
    y = conv2d(x, w1, b1, dtype=torch.bfloat16)
    B, H, W, C = y.shape
    padded = F.relu(b1).to(y.dtype).expand(B, H + 2, W + 2, C).clone()
    padded[:, 1:-1, 1:-1] = y
    return max_pool_2x2_valid(conv2d(padded, w2, b2, padding="VALID",
                                     dtype=torch.bfloat16))


def phase_stem(params, smi):
    """The literal stem's kernel (csrc/stem_s2d.cu's bf16 instance, through
    vgg_stem_cuda) on the card, within STEM_TOL of the max magnitude of both
    plain versions: vgg_stem_plain (the literal bf16 conv pair, cuDNN) and
    stem_s2d_fused_plain in bf16 (the kernel's own rounding). At the
    detector's stem shapes with B=4 distinct frames, at a narrow shape, and
    at B=1 on three shapes whose pooled extents are no multiple of the
    kernel's 8 x 16 tile. The biases are drawn here, nonzero (the
    detector's He params have zero biases): b1 in [0.5, 1), so relu(b1) in
    conv1_2's padding would show, and b2 of both signs. Then the time of
    one frame's two stems beside cuDNN's and the bound."""
    gen = torch.Generator().manual_seed(SEED + 1)
    means = torch.from_numpy(PIXEL_MEANS)
    cases = [("bev", 4, 601, 601, 9), ("image", 4, 384, 1248, 3),
             ("narrow", 2, 36, 200, 9)]
    cases += [("ragged tile", 1, h, w, c) for h, w, c in
              ((75, 203, 9), (50, 90, 3), (21, 29, 9))]
    worst = 0.0
    ms = plain_ms = 0.0
    parts = []
    for name, B, H, W, cin in cases:
        x = torch.rand((B, H, W, cin), generator=gen)
        if cin == 3:
            x = x * 255 - means
        x = x.cuda()
        suffix = "" if cin == 9 else "_2"
        b1 = (0.5 + 0.5 * torch.rand(64, generator=gen)).cuda()
        b2 = (0.1 * torch.randn(64, generator=gen)).cuda()
        w = (layer(params, "conv1_1" + suffix)[0], b1,
             layer(params, "conv1_2" + suffix)[0], b2)
        with torch.inference_mode():
            got = vgg_stem_cuda(x, *w)
            refs = {"vgg_stem_plain": vgg_stem_plain(x, *w),
                    "stem_s2d_fused_plain": stem_s2d_fused_plain(
                        x, *w, dtype=torch.bfloat16)}
            leak = stem_halo_leak(x, *w)
        torch.cuda.synchronize()
        what = "stem %s %s" % (name, tuple(x.shape))
        line = what + ":"
        for rname, ref in refs.items():
            if got.shape != ref.shape or got.dtype != torch.bfloat16:
                raise AssertionError("%s: %s %s vs %s %s" % (
                    what, got.dtype, tuple(got.shape), rname,
                    tuple(ref.shape)))
            err = max_err(got, ref)
            scale = ref.float().abs().max().item()
            tol = STEM_TOL * scale + 1e-6
            if not err <= tol:
                raise AssertionError("%s: max |diff| to %s %g > %g * %g" % (
                    what, rname, err, STEM_TOL, scale))
            worst = max(worst, err)
            line += " max |diff| to %s %g <= %g;" % (rname, err, tol)
        ref = refs["vgg_stem_plain"]
        tol = STEM_TOL * ref.float().abs().max().item() + 1e-6
        leak_err = max_err(leak, ref)
        if not leak_err > tol:
            raise AssertionError("%s: a relu(b1) halo would pass the check "
                                 "(%g <= %g)" % (what, leak_err, tol))
        line += " a relu(b1) halo would be off by %g" % leak_err
        if name in ("bev", "image"):
            x1 = x[:1]
            with torch.inference_mode():
                k = cuda_ms(lambda: vgg_stem_cuda(x1, *w), iters=10)
                p = cuda_ms(lambda: vgg_stem_plain(x1, *w), iters=10)
            ms, plain_ms = ms + k, plain_ms + p
            _, H, W, cin = x1.shape
            parts.append((nbytes(x1, *w) + (H // 2) * (W // 2) * 64 * 2,
                          2 * H * W * 64 * 9 * (cin + 64)))
            line += "; one frame: kernel %.4f ms, cuDNN %.4f ms" % (k, p)
        print(line)
    # the plain version is the library path: two cuDNN convs and the pool
    stats = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
             **bound(parts, BF16_PER_S), "library_ms": plain_ms}
    print("vgg_stem: one frame's two stems: kernel %.4f ms, cuDNN conv pair "
          "+ pool %.4f ms (kernel / cuDNN %.3f), bound %.4f ms (%s), on [%s]"
          % (ms, plain_ms, ms / plain_ms, stats["bound_ms"],
             stats["bound_by"], smi))
    return stats


def s2d_mask_leak(x, w1, b1, w2, b2, dtype):
    """The plain fused stem without the edge mask: packed entries outside
    the image keep relu(conv1_1 + b1) instead of acting as conv1_2's zero
    padding. The check must tell it apart."""
    C2 = w2.shape[0]
    B, H, W, _ = x.shape
    Ho, Wo = H // 2, W // 2
    K1, B1, K2, B2 = pack_stem_weights(hwio(w1), b1, hwio(w2), b2)
    f32 = torch.float32
    x, K1, K2 = (t.to(dtype).to(f32) for t in (x, K1, K2))
    y = s2d_conv(x, K1, 2, (2, 2 * Wo + 2 - W, 2, 2 * Ho + 2 - H))
    y = F.relu(y + B1.to(f32)).to(dtype).to(f32)
    return group_max(F.relu(s2d_conv(y, K2) + B2.to(f32)), C2).to(dtype)


def phase_stem_s2d_fused(params, smi):
    """The fused s2d stem kernel against its plain version on the card, in
    float32 (within 1e-5 * max|ref|) and bf16 (within STEM_TOL * max|ref|),
    at B=4 on the detector's BEV 601x601x9 (odd: no last-row or last-column
    mask) and image 384x1248x3 (even: both masks), and at B=2 on the four
    odd and even shapes of tests/test_stem_s2d_pallas.py and on four whose
    pooled extents are no multiple of the bf16 kernel's 8 x 16 tile (two
    with 5 and 16 input channels); the biases drawn here, nonzero (b1 in
    [0.5, 1), b2 of both signs). The plain version
    without the edge mask must miss the tolerance. Then one int8 detector
    call's stems (B=8, both views, bf16): kernel, plain, the literal bf16
    stem through cuDNN (the library yardstick) and the XLA-twin route
    ops/stem_s2d.stem_s2d (cuDNN), beside the bound."""
    gen = torch.Generator().manual_seed(SEED + 12)
    means = torch.from_numpy(PIXEL_MEANS)
    cases = [("bev", 4, 601, 601, 9), ("image", 4, 384, 1248, 3)]
    cases += [("small", PLAIN_B, h, w, c) for h, w, c in
              ((26, 26, 9), (25, 21, 9), (24, 34, 3), (27, 20, 3))]
    # pooled extents off the bf16 kernel's 8 x 16 tile, and channel counts
    # that take its other conv1_1 depths (K = 48 -> 96, 144)
    cases += [("ragged tile", PLAIN_B, h, w, c) for h, w, c in
              ((75, 203, 9), (50, 90, 3), (21, 29, 5), (22, 35, 16))]
    tols = {torch.float32: 1e-5, torch.bfloat16: STEM_TOL}
    weights = {}
    worst = 0.0
    for name, B, H, W, cin in cases:
        x = torch.rand((B, H, W, cin), generator=gen)
        if cin == 3:
            x = x * 255 - means
        x = x.cuda()
        suffix = "" if cin == 9 else "_2"
        b1 = (0.5 + 0.5 * torch.rand(64, generator=gen)).cuda()
        b2 = (0.1 * torch.randn(64, generator=gen)).cuda()
        w1 = layer(params, "conv1_1" + suffix)[0]
        if cin not in (3, 9):       # He-scaled, as the detector's
            w1 = (torch.randn((64, cin, 3, 3), generator=gen)
                  * (2.0 / (9 * cin)) ** 0.5).cuda()
        w = (w1, b1, layer(params, "conv1_2" + suffix)[0], b2)
        weights.setdefault(cin, w)
        for dtype, rtol in tols.items():
            with torch.inference_mode():
                got = stem_s2d_fused_cuda(x, *w, dtype=dtype)
                ref = stem_s2d_fused_plain(x, *w, dtype=dtype)
                leak = s2d_mask_leak(x, *w, dtype=dtype)
            torch.cuda.synchronize()
            what = "stem_s2d_fused %s %s %s" % (
                name, tuple(x.shape), str(dtype).split(".")[-1])
            if got.shape != ref.shape or got.dtype != dtype:
                raise AssertionError("%s: %s %s vs %s" % (
                    what, got.dtype, tuple(got.shape), tuple(ref.shape)))
            err = max_err(got, ref)
            scale = ref.float().abs().max().item()
            tol = rtol * scale + 1e-6
            if not err <= tol:
                raise AssertionError("%s: max |diff| %g > %g * %g"
                                     % (what, err, rtol, scale))
            leak_err = max_err(leak, ref)
            if not leak_err > tol:
                raise AssertionError("%s: the stem without the edge mask "
                                     "would pass the check (%g <= %g)"
                                     % (what, leak_err, tol))
            worst = max(worst, err)
            print("%s: max |diff| %g <= %g, max |ref| %g; without the edge "
                  "mask off by %g" % (what, err, tol, scale, leak_err))

    # one B=8 int8 detector call's two stems, bf16, from its float32 inputs
    ms = plain_ms = lib_ms = twin_ms = 0.0
    parts = []
    literal_ops = packed_ops = 0
    for name, H, W, cin in (("bev", 601, 601, 9), ("image", 384, 1248, 3)):
        x = torch.rand((INT8_B, H, W, cin), generator=gen).cuda()
        w = weights[cin]
        with torch.inference_mode():
            out = stem_s2d_fused_cuda(x, *w)
            k = cuda_ms(lambda: stem_s2d_fused_cuda(x, *w), iters=5, warmup=1)
            p = cuda_ms(lambda: stem_s2d_fused_plain(x, *w), iters=3,
                        warmup=1)
            lib = cuda_ms(lambda: vgg_stem_plain(x, *w), iters=5, warmup=1)
            twin = cuda_ms(lambda: stem_s2d(x, *w, dtype=torch.bfloat16),
                           iters=3, warmup=1)
        ops = 2 * INT8_B * H * W * 64 * 9 * (cin + 64)     # the literal convs
        literal_ops += ops
        Ho, Wo = H // 2, W // 2
        packed_ops += 2 * INT8_B * ((Ho + 1) * (Wo + 1) * 16 * cin * 256
                                    + Ho * Wo * 4 * 256 * 256)
        parts.append((nbytes(x, *w, out), ops))
        ms, plain_ms, lib_ms, twin_ms = (ms + k, plain_ms + p, lib_ms + lib,
                                         twin_ms + twin)
        print("stem_s2d_fused time %s bf16 B=%d %dx%dx%d: kernel %.4f ms, "
              "plain %.4f ms, literal cuDNN stem %.4f ms, stem_s2d (XLA twin, "
              "cuDNN) %.4f ms" % (name, INT8_B, H, W, cin, k, p, lib, twin))
    stats = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
             **bound(parts, BF16_PER_S), "library_ms": lib_ms}
    print("stem_s2d_fused: one B=%d int8 call's two stems: kernel %.4f ms, "
          "bound %.4f ms (%s; literal convs %.4g GFLOP = %.2f a frame, the "
          "packed dots %.4g GFLOP = %.2f a frame), plain %.4f ms, literal "
          "cuDNN stem %.4f ms, stem_s2d %.4f ms, on [%s]" % (
              INT8_B, ms, stats["bound_ms"], stats["bound_by"],
              literal_ops / 1e9, literal_ops / 1e9 / INT8_B, packed_ops / 1e9,
              packed_ops / 1e9 / INT8_B, plain_ms, lib_ms, twin_ms, smi))
    return stats


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
    calib = torch.from_numpy(np.stack([profiling.example_calib()] * frames))
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


def replay_trap(feat, rois, out, dy, rule):
    """The plain replay under a tie rule the contract rejects: "all" gives
    the whole dy to every tying cell, "first" only to the first tying cell
    in row-major order (the reference CUDA kernel's argmax)."""
    H, W, C = feat.shape
    dfeat = torch.zeros((H * W, C), device=feat.device)
    o = out.float()
    taken = torch.zeros_like(o, dtype=torch.bool)
    for cell, cells, inside in bin_cells(feat,
                                         bin_bounds(rois, 7, 1.0 / 8, H, W)):
        hit = inside[..., None] & (cells.float() == o)
        if rule == "first":
            hit &= ~taken
            taken |= hit
        dfeat.index_add_(0, cell.reshape(-1),
                         torch.where(hit, dy, 0.0).reshape(-1, C))
    return dfeat.reshape(H, W, C)


def phase_roi_bwd(gen):
    """Backward kernel vs plain on the card, within BWD_RTOL * max|ref| +
    BWD_ATOL, at the train pools' shapes (BEV 75x75x512, image 48x156x512),
    on two roi sets: 128 rois with a duplicate and the edge rois, and the
    stress rois; float32 and bf16, on distinct, post-ReLU sparse and
    few-level maps. dfeat's total equals the dy of the non-empty bins; on
    maps with ties, a replay that gives every tying cell the whole dy, and
    one that gives it to the first tying cell, both miss the tolerance.
    Then, on the 128 rois, the kernel alone (raw launches), the same
    without the six edge rois, the wrapper and the plain version."""
    worst = 0.0
    timing, parts = {}, {}
    for name, (shape, in_h, in_w) in BWD_VIEWS.items():
        x = torch.randn(shape, generator=gen).cuda()
        maps = {"distinct": x, "sparse": F.relu(x),
                "levels": (x * 2).round().clamp(0, 4) / 2}
        rois = make_rois(gen, 121, in_h, in_w, 1)
        rois = torch.cat([rois, rois[:1]])           # a duplicated roi
        for set_name, rs in (("rois=128", rois),
                             ("stress", stress_rois(in_h, in_w, 0))):
            hs, he, ws, we = bin_bounds(rs, 7, 1.0 / 8, *shape[:2]).unbind(1)
            nonempty = ((he > hs)[:, :, None] & (we > ws)[:, None, :])[..., None]
            for dtype in (torch.float32, torch.bfloat16):
                for kind, m in maps.items():
                    feat = m.to(dtype)
                    out = roi_pool_cuda(feat, rs)
                    dy = torch.rand(out.shape, generator=gen).cuda()
                    got = roi_pool_bwd_cuda(feat, rs, out, dy)
                    ref = roi_pool_bwd(feat, rs, out, dy)
                    torch.cuda.synchronize()
                    err = (got - ref).abs().max().item()
                    tol = BWD_RTOL * ref.abs().max().item() + BWD_ATOL
                    what = "roi_pool_bwd %s %s %s %s" % (name, set_name, dtype,
                                                         kind)
                    if not err <= tol:
                        raise AssertionError("%s: max |diff| %g > %g"
                                             % (what, err, tol))
                    mass = got.double().sum().item()
                    want = (dy.double() * nonempty).sum().item()
                    if not abs(mass - want) <= 1e-5 * abs(want):
                        raise AssertionError("%s: dfeat sums to %r, the "
                                             "non-empty bins' dy to %r"
                                             % (what, mass, want))
                    line = "%s: max |diff| %g <= %g, mass %.6f of %.6f" % (
                        what, err, tol, mass, want)
                    if kind != "distinct" or dtype == torch.bfloat16:
                        traps = {rule: (replay_trap(feat, rs, out, dy, rule)
                                        - ref).abs().max().item()
                                 for rule in ("all", "first")}
                        if not min(traps.values()) > tol:
                            raise AssertionError("%s: a wrong tie rule would "
                                                 "pass the check: %s"
                                                 % (what, traps))
                        line += ("; whole-dy replay off by %g, first-argmax "
                                 "by %g" % (traps["all"], traps["first"]))
                    worst = max(worst, err)
                    print(line)
                    if kind == "sparse" and rs is rois:
                        timing[(name, dtype)] = time_roi_bwd(feat, rois, out,
                                                             dy)
                        # a compare and, for a tie, an add per covered cell
                        parts[(name, dtype)] = (
                            nbytes(feat, rois, out, dy, got),
                            2 * bin_cells_total(rois, *shape[:2]) * shape[2])
    for (name, dtype), (k, k_core, wrapper, p, moved) in timing.items():
        print("roi_pool_bwd time %s %s rois=128: kernel alone %.4f ms (%.4f "
              "without the 6 edge rois), wrapper %.4f ms, plain %.4f ms; bins "
              "read, out, dy and dfeat %.1f MB, %.0f GB/s"
              % (name, dtype, k, k_core, wrapper, p, moved / 1e6,
                 moved / k / 1e6))
    f32 = [timing[(name, torch.float32)] for name in BWD_VIEWS]
    # no single PyTorch call replays the max and splits dy among ties
    return {"max_abs_err": worst, "ms": sum(t[0] for t in f32),
            "plain_ms": sum(t[3] for t in f32),
            **bound([parts[(name, torch.float32)] for name in BWD_VIEWS],
                    F32_PER_S), "library_ms": None}


def time_roi_bwd(feat, rois, out, dy):
    """(kernel alone, the same without make_rois' six edge rois (rows
    121-126 of the set), wrapper, plain ms, bytes moved) for one map."""
    scratch = torch.zeros(feat.shape, device=feat.device)
    k = cuda_ms(roi_bwd_entry(feat, rois, out, dy, scratch))
    keep = torch.cat([torch.arange(121), torch.arange(127, rois.shape[0])])
    keep = keep.cuda()
    k_core = cuda_ms(roi_bwd_entry(feat, rois[keep], out[keep], dy[keep],
                                   scratch))
    wrapper = cuda_ms(lambda: roi_pool_bwd_cuda(feat, rois, out, dy))
    p = cuda_ms(lambda: roi_pool_bwd(feat, rois, out, dy), iters=3, warmup=1)
    moved = (bin_cells_total(rois, *feat.shape[:2]) * feat.shape[2]
             * feat.element_size() + nbytes(out, dy, scratch))
    return k, k_core, wrapper, p, moved


def train_batch(rng):
    """One full-width training frame on the card: random BEV and image,
    the example calib, and MAX_GT gt rows of which 3-6 are cars, lidar boxes
    in BEV range with their BEV boxes and corners (class 1); padded rows as
    data/loader.py:pad_gt leaves them."""
    n = rng.randint(3, 7)
    box = torch.from_numpy(np.stack([
        rng.uniform(8, 52, n), rng.uniform(-25, 25, n), np.full(n, -0.95),
        rng.uniform(3.5, 4.5, n), rng.uniform(1.5, 1.9, n),
        rng.uniform(1.4, 1.7, n)], 1).astype(np.float32))
    bv = torch.zeros(MAX_GT, 5)
    b3 = torch.zeros(MAX_GT, 7)
    b3[:, 3:6] = 1.0
    cnr = torch.zeros(MAX_GT, 25)
    bv[:n, :4] = G.lidar_3d_to_bv(box)
    b3[:n, :6] = box
    cnr[:n, :24] = G.lidar_3d_to_corners(box)
    bv[:n, 4] = b3[:n, 6] = cnr[:n, 24] = 1.0
    batch = {"bev": torch.from_numpy(rng.rand(*TRAIN_BEV).astype(np.float32)),
             "image": torch.from_numpy(
                 (rng.rand(*TRAIN_IMAGE) * 255).astype(np.float32)),
             "calib": torch.from_numpy(profiling.example_calib()),
             "gt_boxes_bv": bv, "gt_boxes_3d": b3, "gt_boxes_corners": cnr,
             "gt_valid": torch.arange(MAX_GT) < n}
    return {k: v.cuda() for k, v in batch.items()}, n


def phase_train(np_params, smi):
    """The train path at full width, in float32 and in bf16, each from fresh
    He-scaled params with draws from a seeded generator: one warm-up step,
    TRAIN_STEPS timed steps, then one step with the proposal layer timed
    between synchronizes (kept out of the timed steps, whose clock the
    probe would perturb), then one under torch.profiler for its device busy
    time. Checks finite metrics and a positive loss on
    every step, moved rpn_conv/3x3 and fc6_1 weights, and the ROI launch
    counts (zeroed just before, read just after: 2 forward and 2 backward
    per step, no stem). Then, in float32, one step's loss and gradients
    through the kernel pair equal those through the plain pair. Returns
    the launch counts."""
    batch, n_gt = train_batch(np.random.RandomState(SEED + 2))
    n_anchors = FEAT * FEAT * 4
    draw_args = (n_anchors, TRAIN_POST_NMS + MAX_GT, TRAIN_ROIS, FC_DIM, 0.5,
                 "cuda")
    kw = dict(feat_h=FEAT, feat_w=FEAT, pre_nms_top_n=TRAIN_PRE_NMS,
              post_nms_top_n=TRAIN_POST_NMS, rois_per_image=TRAIN_ROIS)
    proposal_layer = train_mod.proposal_layer_3d
    proposal_ms = []

    def timed_proposals(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = proposal_layer(*args, **kwargs)
        torch.cuda.synchronize()
        proposal_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def checked_step(name, step, params, opt, gen):
        m, ms = timed(step, params, opt, batch, make_draws(gen, *draw_args))
        bad = [k for k, v in m.items() if not torch.isfinite(v)]
        if bad or not m["loss"].item() > 0:
            raise AssertionError("train %s: metrics %s" % (
                name, {k: v.item() for k, v in m.items()}))
        return m["loss"].item(), ms

    roi_pool_cuda.launches = roi_pool_bwd_cuda.launches = 0
    vgg_stem_cuda.launches = 0
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        step, make_opt = build_train_step(compute_dtype=dtype, **kw)
        params = params_from_jax(np_params, device="cuda")
        watch = {k: params[module_key(k)].weight.detach().clone()
                 for k in ("rpn_conv/3x3", "fc6_1")}
        opt = make_opt(params)
        gen = torch.Generator().manual_seed(SEED + 3)
        warm_loss, warm_ms = checked_step(name, step, params, opt, gen)
        losses, times = zip(*[checked_step(name, step, params, opt, gen)
                              for _ in range(TRAIN_STEPS)])
        del proposal_ms[:]
        train_mod.proposal_layer_3d = timed_proposals
        try:
            _, probed_ms = checked_step(name, step, params, opt, gen)
        finally:
            train_mod.proposal_layer_3d = proposal_layer
        traced = device_busy(lambda: checked_step(name, step, params, opt,
                                                  gen))
        still = [k for k, w in watch.items()
                 if torch.equal(params[module_key(k)].weight, w)]
        if still:
            raise AssertionError("train %s: %s did not move" % (name, still))
        p50 = float(np.median(times))
        print("train step %s: p50 %.3f ms/step over %d steps (%s) after a "
              "%.3f ms warm-up, loss %.5f then %s, %d gt cars; probed step "
              "%.3f ms, its proposal layer %.3f ms = %.3f of that step; "
              "a traced step: %s; on [%s]" % (
                  name, p50, TRAIN_STEPS, ", ".join("%.3f" % t for t in times),
                  warm_ms, warm_loss, ", ".join("%.5f" % v for v in losses),
                  n_gt, probed_ms, proposal_ms[0], proposal_ms[0] / probed_ms,
                  traced, smi))
        del params, opt, step
    launches = {"roi_pool": roi_pool_cuda.launches,
                "roi_pool_bwd": roi_pool_bwd_cuda.launches,
                "vgg_stem": vgg_stem_cuda.launches}
    # both dtypes; the warm-up, probed and traced steps
    steps = 2 * (TRAIN_STEPS + 3)
    expected = {"roi_pool": 2 * steps, "roi_pool_bwd": 2 * steps,
                "vgg_stem": 0}
    print("train-path launches: %s (expected %s)" % (launches, expected))
    if launches != expected:
        raise AssertionError("train launch counts %s != %s"
                             % (launches, expected))

    # f32: the kernel pair against the plain pair, same params and draws
    draws = make_draws(torch.Generator().manual_seed(SEED + 4), *draw_args)
    results = {}
    for name, pool in (("kernel", roi_pool_train),
                       ("plain", roi_pool_train_plain)):
        fwd = build_forward_losses(pool=pool, **kw)
        params = params_from_jax(np_params, device="cuda")
        m = fwd(params, batch, draws)
        m["loss"].backward()
        results[name] = (m["loss"].item(),
                         {k: p.grad for k, p in params.named_parameters()})
        del params
    (loss_k, g_k), (loss_p, g_p) = results["kernel"], results["plain"]
    if not abs(loss_k - loss_p) <= 1e-6 * abs(loss_p):
        raise AssertionError("f32 train loss: kernel pair %r, plain pair %r"
                             % (loss_k, loss_p))
    worst = 0.0
    for k, g in g_p.items():
        err = (g_k[k] - g).abs().max().item()
        scale = g.abs().max().item()
        if not err <= 1e-4 * scale:
            raise AssertionError("f32 train gradient of %s: max |diff| %g > "
                                 "1e-4 * %g" % (k, err, scale))
        worst = max(worst, err / scale if scale else 0.0)
    print("f32 train step through the kernel pair vs the plain pair: loss "
          "%.7f vs %.7f; worst gradient max |diff| / max |g| %.3g over %d "
          "tensors" % (loss_k, loss_p, worst, len(g_p)))
    return launches


def scan_traffic(rng, scans, n=SCAN_POINTS):
    """KITTI-scale scans (bench.py:164-176): x in [-10,70), y in [-40,40),
    z in [-3,1), reflectance in [0,1); about a third land in the crop."""
    pts = np.empty((scans, n, 4), np.float32)
    pts[..., 0] = rng.rand(scans, n) * 80 - 10
    pts[..., 1] = rng.rand(scans, n) * 80 - 40
    pts[..., 2] = rng.rand(scans, n) * 4 - 3
    pts[..., 3] = rng.rand(scans, n)
    return pts


def boundary_scan():
    """16 points at float32(h) and float32(h + 0.3) for the 8 slice starts
    h, each alone in its cell; two at y = +0.0 and y = -0.0."""
    pts = np.zeros((1, 16, 4), np.float32)
    for i, h in enumerate(bev.SLICE_STARTS):
        for j, z in enumerate((np.float32(h), np.float32(h + 0.3))):
            pts[0, 2 * i + j] = [10.05 + 2.0 * i + j, -5.05 + 10.0 * j, z,
                                 0.05 + 0.05 * (2 * i + j)]
    pts[0, 0, 1], pts[0, 1, 1] = 0.0, -0.0
    return pts, np.ones((1, 16), bool)


def check_twin(tops, pts, val, what):
    """Every raster equals the numpy twin of its scan bit for bit."""
    for b in range(pts.shape[0]):
        want = bev.point_cloud_2_top_np(pts[b][val[b]])
        if not np.array_equal(tops[b], want):
            raise AssertionError(
                "%s scan %d: %d raster entries differ from the numpy twin"
                % (what, b, np.count_nonzero(tops[b] != want)))


def division_rules():
    """Over every float32 v in (0, 60], the range of |x| and |y| in the
    crop: how many pixel coordinates trunc(v / RES) change when the
    division by a tensor (the front end's rule) is replaced by a division
    by a Python scalar or by a multiply by 10. Where they change, the
    tensor rule must give numpy's coordinate."""
    res = torch.tensor(0.1, device="cuda")
    last = int(np.array(60.0, np.float32).view(np.int32))
    moved = {"v / 0.1": [], "v * 10": []}
    for start in range(1, last + 1, 1 << 27):
        v = torch.arange(start, min(start + (1 << 27), last + 1),
                         dtype=torch.int32, device="cuda").view(torch.float32)
        ref = (v / res).to(torch.int32)
        moved["v / 0.1"].append(v[(v / 0.1).to(torch.int32) != ref])
        moved["v * 10"].append(v[(v * 10.0).to(torch.int32) != ref])
    moved = {k: torch.cat(vs) for k, vs in moved.items()}
    for vs in moved.values():
        want = (vs.cpu().numpy() / 0.1).astype(np.int32)
        if not np.array_equal((vs / res).to(torch.int32).cpu().numpy(), want):
            raise AssertionError("v / RES on the card differs from numpy")
    print("pixel coordinates moved against v / RES (a tensor, equal to "
          "numpy's there) over all %d float32 v in (0, 60]: %s; e.g. v = %s"
          % (last, {k: len(vs) for k, vs in moved.items()},
             moved["v / 0.1"][:3].tolist()))


def phase_bev_kernel(smi):
    """The placement kernel against its plain version (torch.equal) on the
    sorted KITTI-scale traffic, a heavy-duplicate batch, the 16 boundary
    points, an all-invalid scan, a scan with NaN rows, the chunk-edge scans
    of ops/bev.py:chunk_edge_points and a B=5 batch (scans 1-3 start off a
    16-byte line); the whole point_cloud_2_top_batch on the card against
    the numpy twin on every scan of those; then the kernel alone on
    chunk_edge_slots (the raster's first and last elements spliced in).
    Then at B=8: the kernel's and the plain placement's CUDA-event means, a
    torch.zeros of the raster alone (what the earlier design paid before
    its first winner), the bound, and the whole front end per scan."""
    rng = np.random.RandomState(SEED + 5)
    kitti = scan_traffic(rng, SCANS)
    dup = scan_traffic(rng, 2)
    half = SCAN_POINTS // 2
    dup[:, :half, 0] = 10.0 + rng.rand(2, half) * 0.5
    dup[:, :half, 1] = 5.0 + rng.rand(2, half) * 0.5
    nan = scan_traffic(rng, 1)
    nan[0, ::3, 0] = np.nan
    nan[0, 1::7, 1:3] = np.nan
    ones = lambda p: np.ones(p.shape[:2], bool)   # noqa: E731
    cases = {"kitti B=8": (kitti, ones(kitti)),
             "heavy duplicates": (dup, rng.rand(2, SCAN_POINTS) > 0.05),
             "slice boundaries": boundary_scan(),
             "all invalid": (kitti[:1], np.zeros((1, SCAN_POINTS), bool)),
             "NaN rows": (nan, ones(nan)),
             "chunk edges": bev.chunk_edge_points(),
             "B=5, scans off 16-byte lines": (kitti[:5], ones(kitti[:5]))}
    worst = 0.0

    def check(what, sorted_):
        got = bev_place_cuda(*sorted_)
        ref = bev_place_plain(*sorted_)
        if not torch.equal(got, ref):
            raise AssertionError("bev_place_cuda != plain on %s: %d entries "
                                 "differ" % (what, int((got != ref).sum())))
        return max_err(got, ref)

    for what, (pts, val) in cases.items():
        p, v = torch.from_numpy(pts).cuda(), torch.from_numpy(val).cuda()
        sorted_ = bev.sort_slots(p, v)
        worst = max(worst, check(what, sorted_))
        tops = bev.point_cloud_2_top_batch(p, v).cpu().numpy()
        check_twin(tops, pts, val, what)
        live = int((sorted_[0] < N_FLAT).sum())
        print("bev_place %s %s: bit-identical to plain; the front end equals "
              "the numpy twin on every scan (%d points placed, %d nonzero)"
              % (what, tuple(pts.shape[:2]), live, np.count_nonzero(tops)))
    edge = [t.cuda() for t in bev.chunk_edge_slots()]
    worst = max(worst, check("chunk-edge slots", edge))
    print("bev_place chunk-edge slots %s (slots 0 and N_FLAT - 2 spliced "
          "in, scan 1 empty): bit-identical to plain"
          % (tuple(edge[0].shape),))

    p = torch.from_numpy(kitti).cuda()
    v = torch.from_numpy(ones(kitti)).cuda()
    division_rules()
    seg_s, zs, rs = bev.sort_slots(p, v)
    ms = cuda_ms(lambda: bev_place_cuda(seg_s, zs, rs))
    plain_ms = cuda_ms(lambda: bev_place_plain(seg_s, zs, rs), iters=10)
    zeros_ms = cuda_ms(lambda: torch.zeros((SCANS, N_FLAT), device="cuda"))
    sort_ms = cuda_ms(lambda: bev.sort_slots(p, v), iters=10)
    front_ms = cuda_ms(lambda: bev.point_cloud_2_top_batch(p, v), iters=10)
    t0 = time.perf_counter()
    bev.point_cloud_2_top_batch(kitti, ones(kitti))
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    stats = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
             **bound([(nbytes(seg_s, zs, rs) + SCANS * N_FLAT * 4, 0)],
                     F32_PER_S),
             # no single PyTorch call finds the run ends and places them
             "library_ms": None}
    print("bev_place time B=%d N=%d: kernel %.4f ms (bound %.4f ms, %s, "
          "%.3f of it), plain %.4f ms; torch.zeros of the raster alone %.4f "
          "ms; %d cells a chunk; prep + stable sort %.4f ms; whole front end %.4f ms = %.4f ms/scan, "
          "%.1f scans/s on device-resident points; from numpy with the copy "
          "to the card %.3f ms; on [%s]" % (
              SCANS, SCAN_POINTS, ms, stats["bound_ms"], stats["bound_by"],
              stats["bound_ms"] / ms, plain_ms, zeros_ms,
              CHUNK_CELLS, sort_ms, front_ms, front_ms / SCANS,
              SCANS * 1e3 / front_ms, host_ms, smi))
    return stats


def phase_read_lidar(root, smi):
    """The read_lidar CLI on the card (no --device: the default) over
    CLI_SCANS scans of the traffic and boundary_scan() as the last,
    written as velodyne .bin files and read by the C++ loader; then again
    with --host, where the C++ raster writes lidar_bv. Every raster of both
    runs equals the numpy twin and the other run's bit for bit. Then the
    loader, numpy against C++, in turns (3 each) over the same files, and
    the host raster, numpy twin against C++, on the first scans. Returns
    the placement launches of the card run, zeroed just before and read
    just after it."""
    pts = scan_traffic(np.random.RandomState(SEED + 6), CLI_SCANS)
    vel = os.path.join(root, "velodyne")
    os.makedirs(vel)
    paths = [os.path.join(vel, "%06d.bin" % i) for i in range(CLI_SCANS + 1)]
    for i in range(CLI_SCANS):
        pts[i].tofile(paths[i])
    edge = boundary_scan()[0][0]
    edge.tofile(paths[-1])
    scans = [p for p in pts] + [edge]
    out_dir = os.path.join(root, "lidar_bv")

    def rasters():
        return [np.load(os.path.join(out_dir, "%06d.npy" % i))
                for i in range(len(scans))]

    bev_place_cuda.launches = 0
    read_lidar.main(["--root", root, "--batch", "8"])
    launches = bev_place_cuda.launches
    expected = -(-len(scans) // 8)
    print("read_lidar launches: %d (expected %d) on [%s]"
          % (launches, expected, smi))
    if launches != expected:
        raise AssertionError("read_lidar launched bev_place %d times, not %d"
                             % (launches, expected))
    on_card = rasters()
    shutil.rmtree(out_dir)
    bev_place_cuda.launches = 0
    read_lidar.main(["--root", root, "--batch", "8", "--host"])
    if bev_place_cuda.launches:
        raise AssertionError("read_lidar --host launched bev_place")
    for what, tops in (("read_lidar", on_card),
                       ("read_lidar --host (C++ raster)", rasters())):
        for i, (top, scan) in enumerate(zip(tops, scans)):
            if not (np.array_equal(top, bev.point_cloud_2_top_np(scan))
                    and np.array_equal(top, on_card[i])):
                raise AssertionError("%s raster %d differs from the numpy "
                                     "twin or the card's" % (what, i))
    print("read_lidar and read_lidar --host: %d rasters (the last "
          "boundary_scan()) equal the numpy twin and each other bit for bit"
          % len(scans))
    loaders = {"numpy": native.load_velodyne_batch_np,
               "C++": native.load_velodyne_batch}
    got = [f(paths) for f in loaders.values()]
    if not all(np.array_equal(a, b) for a, b in zip(*got)):
        raise AssertionError("the C++ loader differs from the numpy one")
    rates = {k: [] for k in loaders}
    for turn in range(3):
        for name in (("numpy", "C++") if turn % 2 == 0 else ("C++", "numpy")):
            t0 = time.perf_counter()
            loaders[name](paths)
            rates[name].append(len(paths) / (time.perf_counter() - t0))
    raster_ms = {}
    for name, fn in (("numpy twin", bev.point_cloud_2_top_np),
                     ("C++", native.point_cloud_2_top_host)):
        t0 = time.perf_counter()
        for scan in scans[:4]:
            fn(scan)
        raster_ms[name] = (time.perf_counter() - t0) * 1e3 / 4
    print("velodyne loader over %d files of %d points (page-cached), scans/s "
          "in turns: %s; host raster ms/scan: %s; on the host of [%s]"
          % (len(paths), SCAN_POINTS,
             {k: ["%.1f" % r for r in v] for k, v in rates.items()},
             {k: "%.3f" % v for k, v in raster_ms.items()}, smi))
    return launches


def phase_scan_detector(params, root, smi):
    """Scan -> raster -> detections, the composition of
    tools/demo_mv.py:81-98 without its drawings: four of the CLI's scans,
    rasterized on the card (make_bird_view; point_cloud_2_top_batch for
    the batch), through the single-frame detector in float32 and bf16 and
    the batched bf16 detector (B=4), then frame_detections. Checks the
    outputs and that make_bird_view gives the CLI's rasters. Returns the
    launch counts, zeroed just before and read just after."""
    frames = 4
    paths = [os.path.join(root, "velodyne", "%06d.bin" % i)
             for i in range(frames)]
    rng = np.random.RandomState(SEED + 7)
    image = torch.from_numpy(
        (rng.rand(frames, 384, 1248, 3) * 255).astype(np.float32)).cuda()
    calib = torch.from_numpy(np.stack([profiling.example_calib()] * frames)).cuda()
    kw = dict(pre_nms_top_n=PRE_NMS, post_nms_top_n=POST_NMS)
    runs = {"f32": build_detect_fn(**kw),
            "bf16": build_detect_fn(compute_dtype=torch.bfloat16, **kw)}
    detect_b = build_detect_batch_fn(compute_dtype=torch.bfloat16, **kw)
    roi_pool_cuda.launches = vgg_stem_cuda.launches = 0
    bev_place_cuda.launches = 0

    def single(detect, i):
        raster = make_bird_view(paths[i])
        out = detect(params, raster, image[i], calib[i])
        return raster, out, frame_detections(out)

    def batch():
        pts, val = zip(*[bev.pad_points(bev.load_velodyne(p)) for p in paths])
        rasters = bev.point_cloud_2_top_batch(np.stack(pts), np.stack(val))
        out = detect_b(params, rasters, image, calib)
        return out, [frame_detections({k: v[i] for k, v in out.items()})
                     for i in range(frames)]

    for name, detect in runs.items():
        timed(single, detect, 0)                                # warm-up
        times, n_det = [], []
        for i in range(frames):
            (raster, out, dets), ms = timed(single, detect, i)
            check_outputs(out, (POST_NMS,), "scan -> %s detector" % name)
            cli = np.load(os.path.join(root, "lidar_bv", "%06d.npy" % i))
            if not np.array_equal(raster.cpu().numpy(), cli):
                raise AssertionError("make_bird_view differs from the CLI's "
                                     "raster of scan %d" % i)
            times.append(ms)
            n_det.append(sum(len(d[0]) for d in dets.values()))
        print("scan -> detections %s single-frame: p50 %.3f ms/frame over %d "
              "frames (%s), detections %s, on [%s]" % (
                  name, float(np.median(times)), frames,
                  ", ".join("%.3f" % t for t in times), n_det, smi))
    batch_calls = 3
    timed(batch)                                                # warm-up
    times = []
    for _ in range(batch_calls):
        (out, dets), ms = timed(batch)
        check_outputs(out, (frames, POST_NMS), "scan -> bf16 batch")
        times.append(ms / frames)
    print("scan -> detections bf16 batch B=%d: p50 %.3f ms/frame over %d "
          "calls (%s), detections %s, on [%s]" % (
              frames, float(np.median(times)), batch_calls,
              ", ".join("%.3f" % t for t in times),
              [sum(len(d[0]) for d in f.values()) for f in dets], smi))
    launches = {"roi_pool": roi_pool_cuda.launches,
                "vgg_stem": vgg_stem_cuda.launches,
                "bev_place": bev_place_cuda.launches}
    singles, batches = frames + 1, batch_calls + 1
    expected = {"roi_pool": 2 * (2 * singles + batches),
                "vgg_stem": 2 * (singles + batches),
                "bev_place": 2 * singles + batches}
    print("scan-path launches: %s (expected %s)" % (launches, expected))
    if launches != expected:
        raise AssertionError("scan-path launch counts %s != %s"
                             % (launches, expected))
    return launches


def trunk_convs(H, W):
    """(count, H, W, C, N) of one view's s8 3x3 convs after its stem output
    (H, W): conv2_1 .. conv5_3."""
    return [(1, H, W, 64, 128), (1, H, W, 128, 128),
            (1, H // 2, W // 2, 128, 256), (2, H // 2, W // 2, 256, 256),
            (1, H // 4, W // 4, 256, 512), (5, H // 4, W // 4, 512, 512)]


def s8_case(gen, B, H, W, C, N, taps):
    """Random s8 conv operands on the card, drawn as tests/test_conv_s8.py
    draws them: post-ReLU codes, symmetric weights, k and b of a requant."""
    x = torch.randint(0, 128, (B, H, W, C), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (taps, taps, C, N), generator=gen,
                      device="cuda", dtype=torch.int8)
    k = torch.rand(N, generator=gen, device="cuda") * 2e-3 + 1e-4
    b = torch.rand(N, generator=gen, device="cuda") - 0.5
    return x, w, k, b


def conv_work(x, w, out):
    """(bytes read and written once, operations) of one s8 conv, at the
    real channel count."""
    taps2, C, N = w.shape[0] * w.shape[1], w.shape[2], w.shape[3]
    return (nbytes(x, w, out) + 8 * N, 2 * out.numel() * taps2 * C)


def check_conv(name, taps, x, w, k, b, out_dtype):
    """The s8 conv kernel against its plain version, torch.equal: a 3x3
    through both conv3x3_s8_nk_cuda (on the prepared weight) and
    conv3x3_s8_cuda, a 2x2 through both conv2x2_s8_nk_cuda and
    conv2x2_s8_cuda. Returns the kernel's output and the plain one."""
    if taps == 3:
        ref = S8.conv3x3_s8_plain(x, w, k, b, out_dtype)
        outs = {"conv3x3_s8_nk_cuda": conv3x3_s8_nk_cuda(
                    x, S8.prepare_s8_conv_weight(w), k, b, out_dtype),
                "conv3x3_s8_cuda": conv3x3_s8_cuda(x, w, k, b, out_dtype)}
    else:
        ref = S8.conv2x2_s8_plain(x, w, k, b, out_dtype)
        outs = {"conv2x2_s8_nk_cuda": conv2x2_s8_nk_cuda(
                    x, S8.prepare_s8_conv2x2_weight(w), k, b, out_dtype),
                "conv2x2_s8_cuda": conv2x2_s8_cuda(x, w, k, b, out_dtype)}
    for wrapper, got in outs.items():
        if got.dtype != out_dtype or not torch.equal(got, ref):
            raise AssertionError(
                "s8 conv %s %s through %s: kernel != plain (%s of %d differ)"
                % (name, out_dtype, wrapper,
                   int((got != ref).sum()) if got.shape == ref.shape
                   else "shape %s vs %s" % (tuple(got.shape),
                                            tuple(ref.shape)),
                   ref.numel()))
    return got, ref


def phase_conv_s8(smi):
    """The s8 conv kernels against their plain versions, torch.equal, at B=2
    at every shape of the int8 path: each view's trunk layers, its packed
    conv1_2, the RPN conv in float32 output; a ragged 3x3 (H odd, W no
    multiple of 8, C=96 padded to 128) in both outputs, a ragged 2x2 (C=96
    padded to 128, N=48 under one tile) in both, a 9-channel input; then
    an M below one 128-pixel tile, H = 1 and W = 1 maps and C = 192 (the
    kernel's 64-channel slabs at the 256-wide tile); for the 2x2, H = 2 and
    W = 2 maps (one output row, one column), an M below one tile and the
    tiny (1, 9, 9, 128) map of the CPU tests. Each case runs through both
    wrappers of its window (the prepared weight and the per-call one). A
    replay of the float32 epilogue with two roundings (acc * k, then + b)
    must differ from the kernel. Then kernel and plain times at B=8 per
    shape of one int8 detector call (TOP/s and the fraction of the bound)
    and summed over its convs, both windows on prepared weights; beside the
    2x2, torch._int_mm on its GEMM, from an im2col made outside the timed
    window; the cost of the zero-padded channels. Returns the 3x3 and 2x2
    stats."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    cases = []
    for view, (H, W) in S8_VIEWS.items():
        cases += [("%s conv %dx%dx%d->%d" % (view, h, w, c, n), 3, PLAIN_B,
                   h, w, c, n, torch.int8)
                  for _, h, w, c, n in trunk_convs(H, W)]
        cases.append(("%s packed conv1_2" % view, 2, PLAIN_B, H + 1, W + 1,
                      256, 256, torch.int8))
    cases += [("rpn conv", 3, PLAIN_B, 75, 75, 512, 512, torch.float32),
              ("ragged 3x3", 3, PLAIN_B, 37, 45, 96, 64, torch.int8),
              ("ragged 3x3", 3, PLAIN_B, 37, 45, 96, 64, torch.float32),
              ("ragged 2x2", 2, PLAIN_B, 38, 47, 96, 48, torch.int8),
              ("ragged 2x2", 2, PLAIN_B, 38, 47, 96, 48, torch.float32),
              ("H = 2 map", 2, PLAIN_B, 2, 301, 256, 256, torch.int8),
              ("W = 2 map", 2, PLAIN_B, 45, 2, 128, 128, torch.float32),
              ("M = 40, below one tile", 2, 1, 5, 11, 256, 256, torch.int8),
              ("(1, 9, 9, 128) map", 2, 1, 9, 9, 128, 128, torch.int8),
              ("9-channel input", 3, PLAIN_B, 41, 43, 9, 64, torch.int8),
              ("M = 126, below one tile", 3, PLAIN_B, 7, 9, 128, 256,
               torch.int8),
              ("M = 1 pixel", 3, 1, 1, 1, 64, 128, torch.float32),
              ("H = 1 map", 3, PLAIN_B, 1, 300, 64, 128, torch.int8),
              ("W = 1 map", 3, PLAIN_B, 45, 1, 256, 512, torch.int8),
              ("W = 1 map", 3, 3, 75, 1, 512, 256, torch.float32),
              ("C = 192", 3, PLAIN_B, 20, 30, 192, 256, torch.int8),
              ("C = 192", 3, PLAIN_B, 20, 30, 192, 256, torch.float32)]
    replay_seen = False
    worst = {3: 0.0, 2: 0.0}
    for name, taps, B, H, W, C, N, out_dtype in cases:
        x, w, k, b = s8_case(gen, B, H, W, C, N, taps)
        got, ref = check_conv(name, taps, x, w, k, b, out_dtype)
        worst[taps] = max(worst[taps], max_err(got, ref))
        line = ("conv_s8 %dx%d %s %s B=%d: bit-identical to plain through "
                "both wrappers" % (taps, taps, name,
                                   str(out_dtype).split(".")[-1], B))
        if out_dtype == torch.int8:
            inside = ((ref > 0) & (ref < 127)).float().mean().item()
            line += " (%.3f of codes inside (0, 127))" % inside
        else:
            acc = S8.conv_acc_plain(x, w, 1 if taps == 3 else 0)
            two = (acc.float() * k + b).clamp_min(0.0)
            moved = int((two != got).sum())
            if not moved and got.numel() > 1000:
                raise AssertionError("s8 conv %s: a two-rounding epilogue "
                                     "would pass the check" % name)
            replay_seen = replay_seen or moved > 0
            line += ("; a two-rounding epilogue differs in %d of %d values"
                     % (moved, got.numel()))
        print(line)
    if not replay_seen:
        raise AssertionError("no two-rounding replay ran")

    # one B=8 int8 detector call: 22 trunk convs and the RPN conv, two packed
    # conv1_2; each distinct shape timed once and weighted by its count. Both
    # windows run on prepared weights, as the detector's do.
    sums = {3: [0.0, 0.0, []], 2: [0.0, 0.0, []]}
    timed_cases = [(2, 1, H + 1, W + 1, 256, 256, torch.int8)
                   for H, W in S8_VIEWS.values()]
    for H, W in S8_VIEWS.values():
        timed_cases += [(3, n, h, w, c, m, torch.int8)
                        for n, h, w, c, m in trunk_convs(H, W)]
    timed_cases.append((3, 1, 75, 75, 512, 512, torch.float32))
    for taps, count, H, W, C, N, out_dtype in timed_cases:
        x, w, k, b = s8_case(gen, INT8_B, H, W, C, N, taps)
        if taps == 3:
            w_nk = S8.prepare_s8_conv_weight(w)
            kernel = lambda: conv3x3_s8_nk_cuda(  # noqa: E731
                x, w_nk, k, b, out_dtype)
            plain = lambda: S8.conv3x3_s8_plain(  # noqa: E731
                x, w, k, b, out_dtype)
        else:
            w_nk = S8.prepare_s8_conv2x2_weight(w)
            kernel = lambda: conv2x2_s8_nk_cuda(  # noqa: E731
                x, w_nk, k, b, out_dtype)
            plain = lambda: S8.conv2x2_s8_plain(  # noqa: E731
                x, w, k, b, out_dtype)
        out = kernel()
        km = cuda_ms(kernel, iters=5, warmup=1)
        pm = cuda_ms(plain, iters=1, warmup=1)
        work = conv_work(x, w, out)
        floor = bound([work], INT8_PER_S)["bound_ms"]
        sums[taps][0] += count * km
        sums[taps][1] += count * pm
        sums[taps][2] += [work] * count
        line = ("conv_s8 time %dx%d B=%d %dx%dx%d->%d %s x%d: kernel %.4f ms "
                "(%.1f TOP/s, %.3f of the bound %.4f ms), plain %.4f ms" % (
                    taps, taps, INT8_B, H, W, C, N,
                    str(out_dtype).split(".")[-1], count, km,
                    work[1] / km / 1e9, floor / km, floor, pm))
        if taps == 2:
            # the yardstick of the product alone: torch._int_mm on the
            # conv's GEMM (B*Ho*Wo, 4*C) x (4*C, N), the im2col made first;
            # the port never calls it, and it computes no conv
            cols, _ = S8._im2col(x, 2, 2, 0)
            w_cm = w.reshape(4 * C, N).t().contiguous().t()
            lm = cuda_ms(lambda: torch._int_mm(cols, w_cm), iters=5,
                         warmup=1)
            line += ("; torch._int_mm on its GEMM (%d, %d) x (%d, %d), "
                     "product only: %.4f ms (%.1f TOP/s)" % (
                         cols.shape[0], 4 * C, 4 * C, N, lm,
                         work[1] / lm / 1e9))
            del cols
        print(line)
        del x, w, out
    stats = {}
    for taps, (km, pm, parts) in sums.items():
        # PyTorch has no int8 convolution on CUDA
        stats[taps] = {"max_abs_err": worst[taps], "ms": km, "plain_ms": pm,
                       **bound(parts, INT8_PER_S), "library_ms": None}
        print("conv_s8 %dx%d: one B=%d detector call's %d convs: kernel %.4f "
              "ms, bound %.4f ms (%s, %.3f of it), plain %.4f ms, on [%s]" % (
                  taps, taps, INT8_B, len(parts), km,
                  stats[taps]["bound_ms"], stats[taps]["bound_by"],
                  stats[taps]["bound_ms"] / km, pm, smi))

    # channels the kernel pads: the "int8" stem's conv1_1 (9 and 3 channels
    # to 64) and a C = 96 map (to 128), each beside the same shape at the
    # padded C; and the one-time preparation of the largest weight
    for B, H, W, C, N in ((1, 601, 601, 9, 64), (1, 384, 1248, 3, 64),
                          (INT8_B, 150, 150, 96, 256)):
        times = []
        for c in (C, S8.conv_channels(C)):
            x, w, k, b = s8_case(gen, B, H, W, c, N, 3)
            w_nk = S8.prepare_s8_conv_weight(w)
            times.append(cuda_ms(lambda: conv3x3_s8_nk_cuda(x, w_nk, k, b),
                                 iters=5, warmup=1))
        print("conv_s8 padded channels %dx%dx%d->%d B=%d: kernel %.4f ms at "
              "C=%d, %.4f ms at C=%d; the padding multiplies the "
              "multiply-adds by %.2f" % (H, W, C, N, B, times[0], C,
                                         times[1], S8.conv_channels(C),
                                         S8.conv_channels(C) / C))
    w = s8_case(gen, 1, 1, 1, 512, 512, 3)[1]
    print("conv_s8: preparing a 3x3x512x512 weight, once per weight: %.4f ms"
          % cuda_ms(lambda: S8.prepare_s8_conv_weight(w), iters=3, warmup=1))
    probe = torch.randint(0, 128, (1, 8, 6, 6), dtype=torch.int8,
                          device="cuda")
    try:
        F.max_pool2d(probe, 2)
        verdict = "takes it"
    except RuntimeError as e:          # a probe of PyTorch, reported as found
        verdict = "refuses it (%s)" % str(e).splitlines()[0]
    print("F.max_pool2d on an int8 CUDA tensor %s; the port pools int8 maps "
          "as the max of four strided slices" % verdict)
    return stats[3], stats[2]


def phase_matmul_s8(smi):
    """The s8 GEMM kernel against its plain version, torch.equal, through
    the prepared-weight wrapper that the int8 head calls
    (matmul_s8_nk_cuda on prepare_s8_gemm_weight's (N, Kp) operand) and
    through the public matmul_s8_cuda, at the head's fc6 and fc7 shapes for
    B=8 (M = 2400 rois) and B=1 (M = 300), at 4096^3, at the ragged
    (37, 200, 40), at a K that is no multiple of the kernel's 128-byte K
    slab and at an N that is no multiple of its 160-column tile. Times of
    the kernel, the plain version and torch._int_mm on the same (N, K)
    bytes (the yardstick; the port never calls it), with TOP/s and the
    fraction of the bound; the one-time weight preparation apart. Stats
    for one B=8 detector call's four products."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    M = INT8_B * POST_NMS
    shapes = {"fc6": (M, 25088, 2048), "fc7": (M, 2048, 2048),
              "fc6 B=1": (POST_NMS, 25088, 2048),
              "fc7 B=1": (POST_NMS, 2048, 2048),
              "4096^3": (4096, 4096, 4096), "ragged": (37, 200, 40),
              "K off the slab": (300, 2000, 256),
              "N off the tile": (500, 512, 200)}
    ms = plain_ms = lib_ms = worst = 0.0
    parts = []
    for name, (m, kdim, n) in shapes.items():
        a = torch.randint(-128, 128, (m, kdim), generator=gen, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (kdim, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        bt = S8.prepare_s8_gemm_weight(b)
        got = matmul_s8_nk_cuda(a, bt)
        ref = S8.matmul_s8_plain(a, b)
        worst = max(worst, max_err(got, ref))
        if got.dtype != torch.int32 or not torch.equal(got, ref):
            raise AssertionError("matmul_s8 %s: kernel != plain (%d of %d "
                                 "differ)" % (name, int((got != ref).sum()),
                                              ref.numel()))
        if not torch.equal(matmul_s8_cuda(a, b), ref):
            raise AssertionError("matmul_s8 %s: matmul_s8_cuda != plain"
                                 % name)
        line = "matmul_s8 %s (%d,%d)@(%d,%d): bit-identical to plain" % (
            name, m, kdim, kdim, n)
        if name in ("fc6", "fc7", "fc6 B=1", "fc7 B=1", "4096^3"):
            ops = 2 * m * kdim * n
            work = (nbytes(a, bt, got), ops)
            floor = bound([work], INT8_PER_S)["bound_ms"]
            km = cuda_ms(lambda: matmul_s8_nk_cuda(a, bt), iters=10)
            pm = cuda_ms(lambda: S8.matmul_s8_plain(a, b), iters=2, warmup=1)
            b_cm = bt.t()          # (K, N) column-major: the same bytes
            lm = cuda_ms(lambda: torch._int_mm(a, b_cm), iters=10)
            same = torch.equal(torch._int_mm(a, b_cm), ref)
            prep = cuda_ms(lambda: S8.prepare_s8_gemm_weight(b), iters=3,
                           warmup=1)
            line += ("; kernel %.4f ms (%.1f TOP/s, %.3f of the bound %.4f "
                     "ms), plain %.4f ms, torch._int_mm %.4f ms (%.1f TOP/s, "
                     "%s the plain version), kernel / torch._int_mm %.3f; "
                     "weight preparation, once per weight, %.4f ms" % (
                         km, ops / km / 1e9, floor / km, floor, pm, lm,
                         ops / lm / 1e9,
                         "equal to" if same else "DIFFERENT from", km / lm,
                         prep))
            if name in ("fc6", "fc7"):   # two of each per detector call
                ms, plain_ms, lib_ms = (ms + 2 * km, plain_ms + 2 * pm,
                                        lib_ms + 2 * lm)
                parts += [work] * 2
        print(line)
    stats = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
             **bound(parts, INT8_PER_S), "library_ms": lib_ms}
    print("matmul_s8: one B=%d detector call's 4 products on prepared "
          "weights: kernel %.4f ms, bound %.4f ms (%s), plain %.4f ms, "
          "torch._int_mm %.4f ms on the same bytes, kernel / torch._int_mm "
          "%.3f, on [%s]" % (INT8_B, ms, stats["bound_ms"], stats["bound_by"],
                             plain_ms, lib_ms, ms / lib_ms, smi))
    return stats


class plain_routes:
    """Within the block, the int8 path's kernel wrappers run their plain
    versions on the card instead: for the kernel-vs-plain detector check."""

    SWAPS = ((conv_s8_cuda, "conv3x3_s8_nk_cuda",
              lambda x, w_nk, k, b, out_dtype=torch.int8:
              S8.conv3x3_s8_nk_plain(x, w_nk, k, b, out_dtype)),
             (conv_s8_cuda, "conv3x3_s8_cuda",
              lambda x, w, k, b, out_dtype=torch.int8:
              S8.conv3x3_s8_plain(x, w, k, b, out_dtype)),
             (conv_s8_cuda, "conv2x2_s8_cuda",
              lambda x, w, k, b, out_dtype=torch.int8:
              S8.conv2x2_s8_plain(x, w, k, b, out_dtype)),
             (conv_s8_cuda, "conv2x2_s8_nk_cuda",
              lambda x, w_nk, k, b, out_dtype=torch.int8:
              S8.conv2x2_s8_nk_plain(x, w_nk, k, b, out_dtype)),
             (conv_s8_cuda, "matmul_s8_nk_cuda", S8.matmul_s8_nk_plain),
             (roi_pool_cuda_mod, "roi_pool_cuda",
              lambda f, r, pooled=7, spatial_scale=1.0 / 8:
              roi_pool(f, r, pooled, spatial_scale)))

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name, _ in self.SWAPS]
        for mod, name, fn in self.SWAPS:
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.SWAPS, self.saved):
            setattr(mod, name, fn)


def path_launches():
    """Every kernel's count, for the paths that may reach any of them."""
    return {"roi_pool": roi_pool_cuda.launches,
            "vgg_stem": vgg_stem_cuda.launches,
            "conv_s8": conv3x3_s8_cuda.launches,
            "conv2x2_s8": conv2x2_s8_cuda.launches,
            "matmul_s8": matmul_s8_cuda.launches,
            "stem_s2d_fused": stem_s2d_fused_cuda.launches}


def zero_path_launches():
    for fn in (roi_pool_cuda, vgg_stem_cuda, conv3x3_s8_cuda,
               conv2x2_s8_cuda, matmul_s8_cuda, stem_s2d_fused_cuda):
        fn.launches = 0


def add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def device_busy(fn):
    """One call of fn under torch.profiler: the device kernels' count and
    summed time, and the idle share of the call's span that no kernel
    covers (tools/profiling.device_busy)."""
    return profiling.busy_line(fn, "cuda")


def stem_prep(params, state):
    """quant.prepare_s2d_stem_int8 for both views, the work that the built
    int8 detector's stem cache takes off each call: ms of its second run
    (the first warms the allocator), with a synchronize before and after,
    and a third run traced (device_busy)."""
    def prep():
        with torch.inference_mode():
            for key, suffix in (("trunk_bv", ""), ("trunk_img", "_2")):
                Q.prepare_s2d_stem_int8(params, state[key], suffix)

    prep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prep()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, device_busy(prep)


def int8_stages(params, state, bev, image, calib, stem="s2d_int8"):
    """One int8 detector call (eval._detect_int8 with the INT8_KW options,
    the stem named by ``stem``: "s2d_int8" or "s2d_fused"; trunk, head and
    s2d_int8 stem weights prepared once beforehand) with a synchronize
    after each stage: ms per stage. The s2d_int8 stem is split into its
    weights' lookup in the cache the built detector keeps
    (quant.s2d_stem_weights) and the stages of quant.s2d_stem_int8_stages,
    the generator the detector's stem runs, timed between its yields."""
    ms = {}
    # laid out once, as the built detector does
    trunk_w = {key: Q.prepare_trunk_weights(state[key])
               for key in ("trunk_bv", "trunk_img")}
    head_nk = Q.prepare_head_weights(state["head"])
    stem_cache = {"trunk_bv": {}, "trunk_img": {}}
    for key, suffix in (("trunk_bv", ""), ("trunk_img", "_2")):
        Q.s2d_stem_weights(stem_cache[key], params, state[key], suffix)

    def clock(stage, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        ms[stage] = ms.get(stage, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    def s2d_int8_stem(qtrunk, x, suffix, cache):
        sw = clock("s2d int8 stems: weight preparation", Q.s2d_stem_weights,
                   cache, params, qtrunk, suffix)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for stage, out in Q.s2d_stem_int8_stages(qtrunk, x, sw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            stage = "s2d int8 stems: " + stage
            ms[stage] = ms.get(stage, 0.0) + (t1 - t0) * 1e3
            t0 = t1
        return out

    with torch.inference_mode():
        bev, image, calib = clock("inputs", eval_mod._inputs, params, bev,
                                  image, calib)
        q_bv, q_im = state["trunk_bv"], state["trunk_img"]
        if stem == "s2d_int8":
            stem_bv = s2d_int8_stem(q_bv, bev, "", stem_cache["trunk_bv"])
            stem_im = s2d_int8_stem(q_im, image, "_2",
                                    stem_cache["trunk_img"])
            tail = Q.trunk_apply_int8_from_stem_q
        else:
            stem_bv = clock("s2d fused stems", Q._float_stem, params, bev, "",
                            stem)
            stem_im = clock("s2d fused stems", Q._float_stem, params, image,
                            "_2", stem)
            tail = Q.trunk_apply_int8_from_stem
        fbv, s_bv = clock("int8 trunk tails", tail, q_bv, stem_bv,
                          trunk_w["trunk_bv"])
        fim, s_im = clock("int8 trunk tails", tail, q_im, stem_im,
                          trunk_w["trunk_img"])
        rpn_cls, rpn_box = clock("int8 rpn head", Q.rpn_head_int8, params,
                                 fbv, s_bv)
        rois, flat_bv, flat_img = clock(
            "proposal layer", eval_mod.proposals, rpn_cls, rpn_box, calib,
            FEAT, FEAT, INT8_PRE_NMS, POST_NMS, 0.7, INT8_KW["nms_impl"])
        pooled_bv = clock("int8 roi pool", roi_pool_fast, fbv, flat_bv)
        pooled_im = clock("int8 roi pool", roi_pool_fast, fim, flat_img)
        _, cls_prob, bbox_pred = clock(
            "int8 fusion head", Q.fusion_head_int8, params, state["head"],
            pooled_bv, s_bv, pooled_im, s_im, head_nk)
        clock("corner decode", eval_mod._outputs, rois, cls_prob, bbox_pred)
    return ms


def phase_int8_detector(np_params, smi):
    """PTQ on the card (build_quant_state from CALIB_FRAMES He-scaled frames,
    the head calibrated on their pooled features), then the int8 detector of
    bench.py:201-205 at full shape, B=8: a warm-up and 3 timed calls, the
    output checks and nms_converged, the launch counts (zeroed just before,
    read just after); a stage split of one more call; the bf16 batched
    detector at the same options for comparison; and at B=2 the whole int8
    detector through the kernels against the same detector through the
    plain versions on the card, bit for bit. Returns the launch counts and
    the quant state."""
    params = params_from_jax(np_params, device="cuda")
    rng = np.random.RandomState(SEED + 11)
    means = torch.from_numpy(PIXEL_MEANS).cuda()

    def frames(n):
        bev_ = torch.from_numpy(rng.rand(n, 601, 601, 9).astype(np.float32))
        image = torch.from_numpy(
            (rng.rand(n, 384, 1248, 3) * 255).astype(np.float32))
        calib = torch.from_numpy(np.stack([profiling.example_calib()] * n))
        return bev_.cuda(), image.cuda(), calib.cuda()

    cbev, cimage, ccalib = frames(CALIB_FRAMES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pooled_bv, pooled_img = Q.calibrate_pooled_features(
        params, cbev, cimage - means, ccalib)
    state = Q.build_quant_state(params, cbev, cimage - means, pooled_bv,
                                pooled_img)
    torch.cuda.synchronize()
    print("int8 PTQ on the card: %d calibration frames, %d pooled rows, %.1f "
          "ms; conv5_3 scales bev %.6g image %.6g; head scales %s" % (
              CALIB_FRAMES, pooled_bv.shape[0],
              (time.perf_counter() - t0) * 1e3,
              state["trunk_bv"]["conv5_3"]["s_out"].item(),
              state["trunk_img"]["conv5_3"]["s_out"].item(),
              {k: round(v.item(), 6)
               for k, v in state["head"]["scales"].items()}))
    del cbev, cimage, ccalib, pooled_bv, pooled_img

    bev_, image, calib = frames(INT8_B)
    detect = build_detect_batch_fn(quant=state, **INT8_KW)
    calls = 3
    zero_path_launches()
    timed(detect, params, bev_, image, calib)                   # warm-up
    times = []
    for _ in range(calls):
        out, ms = timed(detect, params, bev_, image, calib)
        conv = out.pop("nms_converged")
        if tuple(conv.shape) != (INT8_B,) or not conv.all():
            raise AssertionError("int8 detector: nms_converged %s"
                                 % conv.tolist())
        check_outputs(out, (INT8_B, POST_NMS), "int8 batch")
        times.append(ms / INT8_B)
    launches = path_launches()
    per_call = {"roi_pool": 2, "vgg_stem": 0, "conv_s8": 23,
                "conv2x2_s8": 2, "matmul_s8": 4, "stem_s2d_fused": 0}
    expected = {k: v * (calls + 1) for k, v in per_call.items()}
    print("int8-path launches: %s (expected %s)" % (launches, expected))
    if launches != expected:
        raise AssertionError("int8 launch counts %s != %s"
                             % (launches, expected))
    p50 = float(np.median(times))
    print("detector int8 batch B=%d (s2d_int8 stem, int8 RPN, pool and head, "
          "pre-NMS %d): p50 %.3f ms/frame = %.1f frames/s over %d calls (%s); "
          "valid per frame %s; on [%s]" % (
              INT8_B, INT8_PRE_NMS, p50, 1e3 / p50, calls,
              ", ".join("%.3f" % t for t in times),
              out["valid"].sum(1).tolist(), smi))
    stages = int8_stages(params, state, bev_, image, calib)
    print("int8 stage split B=%d (a synchronize after each stage), ms: %s; "
          "total %.3f" % (INT8_B, ", ".join("%s %.3f" % kv
                                            for kv in stages.items()),
                          sum(stages.values())))
    print("s2d_int8 stem weights of both views prepared per call, as "
          "before the built detector kept them: %.3f ms (the split's weight "
          "preparation is the cache's lookup); traced: %s; on [%s]"
          % (*stem_prep(params, state), smi))
    print("int8 detector B=%d traced: %s" % (
        INT8_B, device_busy(lambda: detect(params, bev_, image, calib))))

    detect_bf16 = build_detect_batch_fn(
        compute_dtype=torch.bfloat16, nms_impl="blocked_fixed",
        pre_nms_top_n=INT8_PRE_NMS, post_nms_top_n=POST_NMS)
    timed(detect_bf16, params, bev_, image, calib)              # warm-up
    bf16_times = [timed(detect_bf16, params, bev_, image, calib)[1] / INT8_B
                  for _ in range(calls)]
    bf16_p50 = float(np.median(bf16_times))
    print("detector bf16 batch B=%d at the same options: p50 %.3f ms/frame "
          "(%s); int8 p50 / bf16 p50 = %.3f; on [%s]" % (
              INT8_B, bf16_p50, ", ".join("%.3f" % t for t in bf16_times),
              p50 / bf16_p50, smi))

    small = (bev_[:PLAIN_B], image[:PLAIN_B], calib[:PLAIN_B])
    kernel_out = detect(params, *small)
    with plain_routes():
        plain_out = detect(params, *small)
    torch.cuda.synchronize()
    differ = [k for k in kernel_out
              if not torch.equal(kernel_out[k], plain_out[k])]
    if differ:
        raise AssertionError("int8 detector B=%d: the kernel route differs "
                             "from the plain route in %s" % (PLAIN_B, differ))
    print("int8 detector B=%d: kernel route bit-identical to the plain route "
          "in all %d outputs (%d valid proposals)" % (
              PLAIN_B, len(kernel_out), int(kernel_out["valid"].sum())))
    return launches, state


def phase_s2d_fused_detectors(np_params, state, smi):
    """The detectors with stem_impl="s2d_fused" at full shape: the float
    batched detector in bf16 at B=4 with phase_detector's options, and the
    int8 detector at B=8 with INT8_KW's options and quant state but the
    fused s2d stem; a warm-up and 3 timed calls each, output checks and
    each detector's exact launch counts (zeroed just before it, read just
    after it); then each detector alternating with its usual stem on the
    same inputs (p50 and profile), and the stage split of one int8 call
    with each stem. Returns the summed launch counts."""
    params = params_from_jax(np_params, device="cuda")
    rng = np.random.RandomState(SEED + 13)

    def frames(n):
        bev_ = torch.from_numpy(rng.rand(n, 601, 601, 9).astype(np.float32))
        image = torch.from_numpy(
            (rng.rand(n, 384, 1248, 3) * 255).astype(np.float32))
        calib = torch.from_numpy(np.stack([profiling.example_calib()] * n))
        return bev_.cuda(), image.cuda(), calib.cuda()

    float_b = 4
    f_in, q_in = frames(float_b), frames(INT8_B)
    detect_f = build_detect_batch_fn(
        compute_dtype=torch.bfloat16, stem_impl="s2d_fused",
        pre_nms_top_n=PRE_NMS, post_nms_top_n=POST_NMS)
    detect_q = build_detect_batch_fn(quant=state,
                                     **dict(INT8_KW, stem_impl="s2d_fused"))
    calls = 3
    zero = dict.fromkeys(path_launches(), 0)
    per_call = {"bf16": dict(zero, roi_pool=2, stem_s2d_fused=2),
                "int8": dict(zero, roi_pool=2, conv_s8=23, matmul_s8=4,
                             stem_s2d_fused=2)}
    total = {}
    for name, detect, inputs, B in (("bf16", detect_f, f_in, float_b),
                                    ("int8", detect_q, q_in, INT8_B)):
        zero_path_launches()
        timed(detect, params, *inputs)                       # warm-up
        times = []
        for _ in range(calls):
            out, ms = timed(detect, params, *inputs)
            conv = out.pop("nms_converged", None)
            if conv is not None and not conv.all():
                raise AssertionError("s2d_fused %s detector: nms_converged %s"
                                     % (name, conv.tolist()))
            check_outputs(out, (B, POST_NMS), "s2d_fused %s batch" % name)
            times.append(ms / B)
        print("detector %s batch B=%d, s2d_fused stem: p50 %.3f ms/frame over "
              "%d calls (%s); valid per frame %s; on [%s]" % (
                  name, B, float(np.median(times)), calls,
                  ", ".join("%.3f" % t for t in times),
                  out["valid"].sum(1).tolist(), smi))
        launches = path_launches()
        expected = {k: v * (calls + 1) for k, v in per_call[name].items()}
        print("s2d_fused %s-path launches: %s (expected %s)"
              % (name, launches, expected))
        if launches != expected:
            raise AssertionError("s2d_fused %s launch counts %s != %s"
                                 % (name, launches, expected))
        add_launches(total, launches)
    # each detector with the s2d_fused stem and its usual stem on the same
    # inputs, alternating, so that host noise falls on both alike
    pairs = (("bf16", float_b, f_in, {
        "fused literal stem": build_detect_batch_fn(
            compute_dtype=torch.bfloat16, pre_nms_top_n=PRE_NMS,
            post_nms_top_n=POST_NMS),
        "s2d_fused stem": detect_f}),
        ("int8", INT8_B, q_in, {
            "s2d_int8 stem": build_detect_batch_fn(quant=state, **INT8_KW),
            "s2d_fused stem": detect_q}))
    for name, B, inputs, pair in pairs:
        ab = {k: [] for k in pair}
        for _ in range(calls):
            for k, detect in pair.items():
                ab[k].append(timed(detect, params, *inputs)[1] / B)
        for k, detect in pair.items():
            print("detector %s batch B=%d, %s, alternating: p50 %.3f "
                  "ms/frame (%s); traced: %s" % (
                      name, B, k, float(np.median(ab[k])),
                      ", ".join("%.3f" % t for t in ab[k]),
                      device_busy(lambda: detect(params, *inputs))))
    for stem in ("s2d_fused", "s2d_int8"):
        stages = int8_stages(params, state, *q_in, stem=stem)
        print("int8 stage split B=%d, %s stem (a synchronize after each "
              "stage), ms: %s; total %.3f" % (
                  INT8_B, stem, ", ".join("%s %.3f" % kv
                                          for kv in stages.items()),
                  sum(stages.values())))
    return total


def phase_eval_clis(np_params, smi):
    """The evaluation entry points on a synthetic KITTI tree that the port
    writes in a temp dir (EVAL_FRAMES frames, 8 train and 8 val), with the
    He weights as a reference-style .npy: tools/test_net over the val split
    in bf16, without and with --int8 --int8_stem s2d_int8, then
    tools/quant_check --stem s2d_fused with the int8 head and RPN,
    blocked_fixed NMS, pre-NMS 1024, 8 frames, 4 calibration frames, B=8.
    Each CLI's main(argv) runs in this process with the counts zeroed just
    before and read just after, against exact counts per batch. Checks the
    pickles, finite APs (with random weights they mean nothing) and
    nms_cert_failures 0. Returns the summed launch counts."""
    total = {}
    saved = cfg.ROOT_DIR, cfg.DATA_DIR
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = synthetic.generate(os.path.join(tmp, "kitti"),
                                  num_frames=EVAL_FRAMES, cars_per_frame=3,
                                  seed=SEED)
        weights = os.path.join(tmp, "he.npy")
        np.save(weights, np_params)
        print("synthetic KITTI tree: %d frames and the He weights written in "
              "%.2f s" % (EVAL_FRAMES, time.perf_counter() - t0))
        try:
            cfg.ROOT_DIR, cfg.DATA_DIR = tmp, os.path.join(tmp, "data")
            out_dir = os.path.join(tmp, "output", cfg.EXP_DIR, "kitti_val",
                                   "he")
            imdb = get_imdb("kitti_val", kitti_path=root)
            zero = dict.fromkeys(path_launches(), 0)
            # test_net runs one detector call per batch of 8 val frames; the
            # int8 run calibrates without the head (no launch), keeps the
            # RPN conv in bf16 (22 s8 3x3 convs) and the head in bf16
            batches = -(-imdb.num_images // 8)
            per_batch = {
                "bf16": dict(zero, vgg_stem=2, roi_pool=2),
                "int8 s2d_int8": dict(zero, conv_s8=22, conv2x2_s8=2,
                                      roi_pool=2)}
            for name, extra in (("bf16", []),
                                ("int8 s2d_int8",
                                 ["--int8", "--int8_stem", "s2d_int8"])):
                argv = ["--imdb", "kitti_val", "--kitti_path", root,
                        "--weights", weights, "--dtype", "bfloat16"] + extra
                zero_path_launches()
                t0 = time.perf_counter()
                all_boxes, all_cnr = test_net.main(argv)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                if name == "bf16":
                    official_native_check(imdb, all_boxes, all_cnr,
                                          "test_net's detections", smi)
                    official_native_check(imdb, *gt_detections(imdb),
                                          "jittered gt detections", smi)
                launches = path_launches()
                missing = [f for f in ("detections.pkl", "detections_cnr.pkl",
                                       "detections_cnr_r.pkl")
                           if not os.path.isfile(os.path.join(out_dir, f))]
                if missing:
                    raise AssertionError("test_net %s wrote no %s in %s"
                                         % (name, missing, out_dir))
                aps = [evaluate_kitti_bev(imdb, all_boxes, iou_thresh=t)["ap"]
                       for t in (0.5, 0.7)]
                if not np.isfinite(aps).all():
                    raise AssertionError("test_net %s: APs %s" % (name, aps))
                expected = {k: v * batches
                            for k, v in per_batch[name].items()}
                if launches != expected:
                    raise AssertionError("test_net %s launched %s != %s"
                                         % (name, launches, expected))
                print("tools/test_net %s over %d val frames: %.2f s, BEV AP "
                      "at 0.5/0.7 %s (random weights), launches %s, on [%s]"
                      % (name, imdb.num_images, secs, aps, launches, smi))
                add_launches(total, launches)
            argv = ["--kitti_path", root, "--model", weights,
                    "--stem", "s2d_fused", "--int8-head", "--int8-rpn",
                    "--nms", "blocked_fixed", "--pre-nms", str(INT8_PRE_NMS),
                    "--frames", "8", "--calib_frames", str(CALIB_FRAMES),
                    "--batch", str(INT8_B)]
            zero_path_launches()
            t0 = time.perf_counter()
            res = quant_check.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = path_launches()
            aps = [v for k, v in res.items() if k.startswith(("ap", "q3d",
                                                              "qbev"))]
            if res["nms_cert_failures"] != 0 or not np.isfinite(aps).all():
                raise AssertionError("quant_check: %s" % res)
            # the pooled-feature calibration (one pool pair), then per
            # batch the bf16 reference detector and the int8 detector
            batches = -(-res["frames"] // INT8_B)
            expected = dict(zero, roi_pool=2 + 4 * batches,
                            vgg_stem=2 * batches, conv_s8=23 * batches,
                            matmul_s8=4 * batches,
                            stem_s2d_fused=2 * batches)
            if launches != expected:
                raise AssertionError("quant_check launched %s != %s"
                                     % (launches, expected))
            print("tools/quant_check --stem s2d_fused over %d frames: %.2f s, "
                  "launches %s, on [%s]" % (res["frames"], secs, launches,
                                            smi))
            add_launches(total, launches)
        finally:
            cfg.ROOT_DIR, cfg.DATA_DIR = saved
    return total


def official_native_check(imdb, all_boxes, all_cnr, what, smi):
    """The official-protocol tables (legacy, proper projection, regressed
    corners from the corner sets) with the C++ matcher and with the numpy
    loop: every AP equal within 1e-9; the evaluation's host seconds both
    ways."""
    quiet = lambda *a: None   # noqa: E731
    kw = [{}, {"projection": "proper"},
          {"projection": "proper", "derive_bev_from_corners": True}]
    secs, tables = {True: [], False: []}, {}
    for use_native in (True, False, False, True):
        t0 = time.perf_counter()
        tables[use_native] = [evaluate_kitti_official(
            imdb, all_boxes, all_cnr, log=quiet, use_native=use_native, **k)
            for k in kw]
        secs[use_native].append(time.perf_counter() - t0)
    aps = [(t[m][d], u[m][d]) for t, u in zip(tables[True], tables[False])
           for m in t for d in t[m]]
    worst = max(abs(a - b) for a, b in aps)
    if not worst < 1e-9:
        raise AssertionError("official AP on %s: C++ against numpy differ "
                             "by %g" % (what, worst))
    print("official AP tables on %s (%d APs, max %.4f): C++ matcher equals "
          "the numpy loop (max |diff| %g); evaluation s in turns (C++, numpy, "
          "numpy, C++): C++ %s, numpy %s, on the host of [%s]" % (
              what, len(aps), max(a for a, _ in aps), worst,
              ["%.4f" % t for t in secs[True]],
              ["%.4f" % t for t in secs[False]], smi))


def gt_detections(imdb, seed=SEED):
    """all_boxes and all_boxes_cnr for class 1 from the imdb's own gt, each
    box jittered by up to 0.3 m with a random score, plus as many random
    boxes in range: APs that are neither 0 nor 1."""
    rng = np.random.RandomState(seed)
    n = imdb.num_images
    boxes = [[np.zeros((0, 5), np.float32)] * n for _ in range(2)]
    cnr = [[np.zeros((0, 25), np.float32)] * n for _ in range(2)]
    for i in range(n):
        gt = imdb.roidb[i]["boxes_3D"][imdb.roidb[i]["gt_classes"] == 1]
        fake = np.concatenate([gt, gt.copy()])
        fake[:len(gt), :3] += rng.uniform(-0.3, 0.3, (len(gt), 3))
        fake[len(gt):, :2] = rng.uniform([5, -20], [55, 20], (len(gt), 2))
        box = torch.from_numpy(fake[:, :6].astype(np.float32))
        score = rng.rand(len(fake), 1).astype(np.float32)
        boxes[1][i] = np.concatenate(
            [G.lidar_3d_to_bv(box).numpy(), score], 1)
        cnr[1][i] = np.concatenate(
            [G.lidar_3d_to_corners(box).numpy(), score], 1)
    return boxes, cnr


def capture_nms_inputs(args, kw):
    """One proposal_layer_3d call on the blocked route; returns the blocked
    NMS's inputs (score-ordered candidates of the layer's top-K)."""
    seen = []
    blocked = proposals_mod.nms_blocked

    def capture(bv, psc, valid, max_out, thresh, presorted):
        seen.append((bv, psc, valid, max_out, thresh))
        return blocked(bv, psc, valid, max_out, thresh, presorted=presorted)

    proposals_mod.nms_blocked = capture
    try:
        proposals_mod.proposal_layer_3d(*args, **kw)
    finally:
        proposals_mod.nms_blocked = blocked
    return seen[0]


class GreedyRoute:
    """The proposal layer with its blocked NMS swapped for the greedy loop:
    the route every post-NMS size took before the blocked scan was ported."""

    def __enter__(self):
        self.saved = proposals_mod.nms_blocked
        proposals_mod.nms_blocked = (
            lambda bv, psc, valid, max_out, thresh, presorted:
            nms(bv, psc, valid, max_out, thresh))

    def __exit__(self, *exc):
        proposals_mod.nms_blocked = self.saved


def nms_chain_case(gen, n=600, chain=40):
    """One frame of n score-ordered boxes whose first ``chain`` form a
    suppression chain (100 px wide, 12 px apart: neighbours at IoU 0.786,
    boxes two apart at 0.613), inside the first 512-block: the fixed
    variant's 16 rounds cannot reach its fixpoint."""
    xy = torch.rand(n, 2, generator=gen) * 500
    wh = 4 + torch.rand(n, 2, generator=gen) * 36
    boxes = torch.cat([xy, xy + wh], 1)
    x = 12.0 * torch.arange(chain, dtype=torch.float32)
    boxes[:chain] = torch.stack([x, torch.full_like(x, 700.0), x + 99.0,
                                 torch.full_like(x, 799.0)], 1)
    scores = torch.linspace(1.0, 0.0, n)
    return (boxes[None].cuda(), scores[None].cuda(),
            torch.ones(1, n, dtype=torch.bool, device="cuda"))


def phase_nms_blocked(np_params, smi):
    """The blocked NMS on the card, on the proposal layer's own candidates:
    at the train step's shape (one frame's RPN output from the He weights
    in bf16, pre-NMS 12000, post-NMS 2000) and at test_net's (B=8, the TEST
    config's pre/post-NMS), nms_blocked and nms_blocked_fixed give the
    greedy nms's keep_idx and keep_valid, the fixed one certified; a
    40-box chain in one block leaves the certificate False while the exact
    variant still equals the greedy loop. Then the proposal layer's time on
    the greedy route against the blocked route, alternating (greedy,
    blocked, blocked, greedy after a warm-up of each), at both shapes, with
    equal outputs."""
    params = params_from_jax(np_params, device="cuda")
    rng = np.random.RandomState(SEED + 7)
    train_frame, _ = train_batch(rng)
    frames = {"train step (B=1)": (
        train_frame["bev"][None], train_frame["image"][None],
        train_frame["calib"], TRAIN_PRE_NMS, TRAIN_POST_NMS)}
    B = 8
    frames["test_net batch (B=8)"] = (
        torch.from_numpy(rng.rand(B, *TRAIN_BEV).astype(np.float32)).cuda(),
        torch.from_numpy((rng.rand(B, *TRAIN_IMAGE) * 255).astype(
            np.float32)).cuda(),
        torch.from_numpy(np.stack([profiling.example_calib()] * B)).cuda(),
        cfg.TEST.RPN_PRE_NMS_TOP_N, cfg.TEST.RPN_POST_NMS_TOP_N)
    mean = torch.from_numpy(PIXEL_MEANS).cuda()
    for name, (bev_in, image_in, calib, pre, post) in frames.items():
        with torch.inference_mode():
            c5, _ = mv3d.extract_features(params, bev_in, image_in - mean,
                                          dtype=torch.bfloat16)
            rpn_cls, rpn_box = mv3d.rpn_head(params, c5, dtype=torch.bfloat16)
            args = (mv3d.rpn_probs(rpn_cls), rpn_box.float(), calib, FEAT,
                    FEAT)
            kw = dict(pre_nms_top_n=pre, post_nms_top_n=post)
            bv, psc, valid, P, thr = capture_nms_inputs(args, kw)
            want_idx, want_val = nms(bv, psc, valid, P, thr)
            got = {"nms_blocked": nms_blocked(bv, psc, valid, P, thr,
                                              presorted=True),
                   "nms_blocked_fixed": nms_blocked_fixed(
                       bv, psc, valid, P, thr, presorted=True)}
            for impl, res in got.items():
                if not (torch.equal(res[0], want_idx)
                        and torch.equal(res[1], want_val)):
                    raise AssertionError("%s at the %s: keep set differs "
                                         "from the greedy nms" % (impl, name))
            conv = got["nms_blocked_fixed"][2]
            if not conv.all():
                raise AssertionError("nms_blocked_fixed at the %s: not "
                                     "certified: %s" % (name, conv.tolist()))
            nms_ms = {}
            for impl, fn in (("greedy nms", lambda: nms(bv, psc, valid, P,
                                                        thr)),
                             ("nms_blocked", lambda: nms_blocked(
                                 bv, psc, valid, P, thr, presorted=True)),
                             ("nms_blocked_fixed", lambda: nms_blocked_fixed(
                                 bv, psc, valid, P, thr, presorted=True))):
                nms_ms[impl] = timed(fn)[1]
            layer = {"greedy": [], "blocked": []}
            outs = {}

            def run(route):
                with (GreedyRoute() if route == "greedy"
                      else contextlib.nullcontext()):
                    out, ms = timed(lambda: proposals_mod.proposal_layer_3d(
                        *args, **kw))
                outs[route] = out
                return ms

            run("greedy")
            run("blocked")
            for route in ("greedy", "blocked", "blocked", "greedy"):
                layer[route].append(run(route))
            bad = [k for k in outs["greedy"]
                   if not torch.equal(outs["greedy"][k], outs["blocked"][k])]
            if bad:
                raise AssertionError("proposal layer at the %s: greedy and "
                                     "blocked routes differ in %s" % (name,
                                                                      bad))
        print("blocked NMS at the %s: %d candidates a frame, %d kept of "
              "post-NMS %d, keep sets equal to the greedy nms, certified %s; "
              "NMS alone ms: %s; proposal layer ms, greedy route %s, blocked "
              "route %s (alternating), on [%s]" % (
                  name, bv.shape[-2], int(want_val.sum()), P, conv.tolist(),
                  ", ".join("%s %.3f" % kv for kv in nms_ms.items()),
                  ", ".join("%.3f" % t for t in layer["greedy"]),
                  ", ".join("%.3f" % t for t in layer["blocked"]), smi))
    del params
    boxes, scores, valid = nms_chain_case(torch.Generator().manual_seed(SEED))
    idx, val = nms(boxes, scores, valid, 300, 0.7)
    e_idx, e_val = nms_blocked(boxes, scores, valid, 300, 0.7, presorted=True)
    f_idx, f_val, conv = nms_blocked_fixed(boxes, scores, valid, 300, 0.7,
                                           presorted=True)
    if conv.item() or not (torch.equal(e_idx, idx) and torch.equal(e_val,
                                                                   val)):
        raise AssertionError("40-box chain: certified %s, exact variant "
                             "equal to greedy %s" % (
                                 conv.item(), torch.equal(e_idx, idx)))
    print("40-box chain in one block: nms_blocked_fixed certificate False "
          "(its keep set %s the greedy one), nms_blocked equal to the greedy "
          "nms" % ("equals" if torch.equal(f_idx, idx) else "differs from"))


def printed_lines(fn, *args, **kwargs):
    """fn's result and printed lines; echoes them but the config dump (its
    lines start with "{" or a space) and the weight loader's line per
    tensor."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    lines = buf.getvalue().splitlines()
    for line in lines:
        if line and not line.startswith(("{", " ", "assign pretrain model")):
            print(line)
    return out, lines


def check_train_log(lines, what):
    losses = [float(re.search(r"total loss: (\S+),", line).group(1))
              for line in lines if line.startswith("iter: ")]
    if not losses or not np.isfinite(losses).all():
        raise AssertionError("%s: losses %s" % (what, losses))
    return [float(re.search(r"speed: (\S+)s", line).group(1))
            for line in lines if line.startswith("speed: ")]


def phase_train_net(np_params, root, weights, smi):
    """solver.train_net on the synthetic tree's 8 train frames in bf16 from
    the He weights, on the device dataset: 6 iterations with SNAPSHOT_ITERS
    4, DISPLAY 2 and DEBUG_TIMELINE on (a trace of iterations 2-4), then
    tools.train_net.main(argv) --resume to 8; then 2 iterations on the host
    feed (the device-data budget set to 0). Checks finite losses, the
    snapshots _iter_4/6/8.pt, the trace file, the resume at 6, Adam's step
    count 8, and 2 forward and 2 backward ROI launches an iteration (counts
    zeroed just before each run, read just after). Returns the counts."""
    keys = ("SNAPSHOT_ITERS", "DISPLAY", "DEBUG_TIMELINE")
    saved = ([getattr(cfg.TRAIN, k) for k in keys], cfg.ROOT_DIR,
             cfg.DATA_DIR, cfg.TPU.TRAIN_DATA_HBM_GB)
    total = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg.ROOT_DIR, cfg.DATA_DIR = tmp, os.path.join(tmp, "data")
            cfg.TRAIN.SNAPSHOT_ITERS, cfg.TRAIN.DISPLAY = 4, 2
            cfg.TRAIN.DEBUG_TIMELINE = True
            imdb = get_imdb("kitti_train", kitti_path=root)
            roidb = prepare_roidb(imdb)
            out_dir = get_output_dir(imdb, None)

            def counted(name, iters, fn, *args, **kwargs):
                roi_pool_cuda.launches = roi_pool_bwd_cuda.launches = 0
                vgg_stem_cuda.launches = 0
                t0 = time.perf_counter()
                _, lines = printed_lines(fn, *args, **kwargs)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launches = {"roi_pool": roi_pool_cuda.launches,
                            "roi_pool_bwd": roi_pool_bwd_cuda.launches,
                            "vgg_stem": vgg_stem_cuda.launches}
                want = {"roi_pool": 2 * iters, "roi_pool_bwd": 2 * iters,
                        "vgg_stem": 0}
                if launches != want:
                    raise AssertionError("%s launched %s != %s"
                                         % (name, launches, want))
                add_launches(total, launches)
                speeds = check_train_log(lines, name)
                print("%s: %d iterations in %.2f s (setup included), speed "
                      "lines %s s/iter, launches %s, on [%s]" % (
                          name, iters, secs, speeds, launches, smi))
                return lines

            counted("train_net bf16, device dataset", 6, solver_mod.train_net,
                    imdb, roidb, out_dir, pretrained_model=weights,
                    max_iters=6, compute_dtype=torch.bfloat16)
            traces = os.listdir(os.path.join(out_dir, "traces"))
            if traces != ["trace_iter_2_4.json"] or not os.path.getsize(
                    os.path.join(out_dir, "traces", traces[0])):
                raise AssertionError("trace files %s" % traces)
            cfg.TRAIN.DEBUG_TIMELINE = False
            lines = counted(
                "tools.train_net --resume to 8, device dataset", 2,
                train_net_cli.main,
                ["--imdb", "kitti_train", "--kitti_path", root, "--iters",
                 "8", "--weights", weights, "--resume", "--set", "ROOT_DIR",
                 tmp, "DATA_DIR", os.path.join(tmp, "data"),
                 "TRAIN.SNAPSHOT_ITERS", "4", "TRAIN.DISPLAY", "2"])
            if not any(line.startswith("Resumed from") and line.endswith(
                    "_iter_6.pt (iter 6)") for line in lines):
                raise AssertionError("the CLI did not resume at 6")
            snaps = sorted(n for n in os.listdir(out_dir)
                           if n.endswith(".pt"))
            want = ["VGGnet_fast_rcnn_iter_%d.pt" % i for i in (4, 6, 8)]
            if snaps != want:
                raise AssertionError("snapshots %s != %s" % (snaps, want))
            blob = torch.load(os.path.join(out_dir, want[-1]),
                              map_location="cpu", weights_only=True)
            steps = {int(st["step"]) for st in blob["opt"]["state"].values()}
            if steps != {8}:
                raise AssertionError("Adam step counts %s != {8}" % steps)
            del blob
            for name in snaps:
                os.remove(os.path.join(out_dir, name))
            cfg.TPU.TRAIN_DATA_HBM_GB = 0.0
            cfg.TRAIN.DISPLAY = 1
            counted("train_net bf16, host feed", 2, solver_mod.train_net,
                    imdb, roidb, out_dir, pretrained_model=weights,
                    max_iters=2, compute_dtype=torch.bfloat16)
    finally:
        ([cfg.TRAIN.SNAPSHOT_ITERS, cfg.TRAIN.DISPLAY,
          cfg.TRAIN.DEBUG_TIMELINE], cfg.ROOT_DIR, cfg.DATA_DIR,
         cfg.TPU.TRAIN_DATA_HBM_GB) = saved
    return total


def phase_demo(root, weights, smi):
    """tools.demo_mv.main on frame 000000 of the synthetic tree (bf16, the
    He weights): with its lidar_bv raster, then from a copy of the frame
    without it, where the scan is rasterized by the BEV placement kernel
    (one launch). Each run writes non-empty _img, _bev and _3d PNGs; its
    detector launches 2 stems and 2 ROI pools. Returns the counts."""
    total = {}
    obj = os.path.join(root, "object", "training")
    with tempfile.TemporaryDirectory() as tmp:
        bare = os.path.join(tmp, "object", "training")
        for sub, ext in (("image_2", ".png"), ("velodyne", ".bin"),
                         ("calib", ".txt")):
            os.makedirs(os.path.join(bare, sub))
            shutil.copy(os.path.join(obj, sub, "000000" + ext),
                        os.path.join(bare, sub))
        for name, src, rasters in (("with lidar_bv", obj, 0),
                                   ("from the scan", bare, 1)):
            zero_path_launches()
            bev_place_cuda.launches = 0
            t0 = time.perf_counter()
            written, _ = printed_lines(
                demo_mv.main, ["--root", src, "--index", "000000",
                               "--weights", weights, "--out",
                               os.path.join(tmp, "out", str(rasters))])
            secs = time.perf_counter() - t0
            launches = dict(path_launches(),
                            bev_place=bev_place_cuda.launches)
            want = dict(dict.fromkeys(launches, 0), roi_pool=2, vgg_stem=2,
                        bev_place=rasters)
            if launches != want:
                raise AssertionError("demo %s launched %s != %s"
                                     % (name, launches, want))
            kinds = sorted(os.path.basename(p).rsplit("_", 1)[1]
                           for p in written)
            sizes = [os.path.getsize(p) for p in written]
            if kinds != ["3d.png", "bev.png", "img.png"] or min(sizes) < 1000:
                raise AssertionError("demo %s wrote %s" % (name, written))
            add_launches(total, launches)
            print("tools.demo_mv %s: %.2f s, PNGs %s bytes, launches %s, on "
                  "[%s]" % (name, secs, sizes, launches, smi))
    return total


def all_launches():
    """Every kernel's count, the train path's gradient and the placement
    included."""
    return dict(path_launches(), roi_pool_bwd=roi_pool_bwd_cuda.launches,
                bev_place=bev_place_cuda.launches)


def zero_all_launches():
    zero_path_launches()
    roi_pool_bwd_cuda.launches = bev_place_cuda.launches = 0


@contextlib.contextmanager
def saved_cfg(tmp):
    """The whole config, restored on exit (tools.accuracy_eval merges the
    end2end yml into it), with ROOT_DIR and DATA_DIR in tmp meanwhile."""
    saved = copy.deepcopy(dict(cfg))
    cfg.ROOT_DIR, cfg.DATA_DIR = tmp, os.path.join(tmp, "data")
    try:
        yield
    finally:
        cfg.clear()
        cfg.update(saved)


def phase_accuracy_eval(root, smi):
    """tools.accuracy_eval on the train_net phase's synthetic tree (8 train,
    8 val frames), bf16, --lr-decay --stepsize 2, evaluating every 2: 4
    iterations (evaluations at 0, 2, 4), then --resume to 6 (one more).
    Checks the trajectory's evaluations and keys, its finite losses, and
    the launches of each run (zeroed just before, read just after: per
    iteration 2 forward and 2 backward ROI launches, per evaluation of the
    8 val frames one bf16 detector call: 2 stems, 2 pools). Then
    solver.train_net --resume with cfg.TRAIN.LR_DECAY off refuses the
    decayed snapshot (ValueError naming LR_DECAY). Returns the counts."""
    total = {}
    with tempfile.TemporaryDirectory() as tmp, saved_cfg(tmp):
        out = os.path.join(tmp, "accuracy")
        common = ["--data", root, "--out", out, "--dtype", "bf16",
                  "--eval-every", "2", "--lr-decay", "--stepsize", "2"]
        for extra, iters, evals in ((["--iters", "4"], 4, 3),
                                    (["--iters", "6", "--resume"], 2, 1)):
            zero_all_launches()
            t0 = time.perf_counter()
            traj = accuracy_eval.main(common + extra)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = all_launches()
            want = dict(dict.fromkeys(launches, 0), roi_pool=2 * (iters + evals),
                        roi_pool_bwd=2 * iters, vgg_stem=2 * evals)
            if launches != want:
                raise AssertionError("accuracy_eval %s launched %s != %s"
                                     % (extra, launches, want))
            add_launches(total, launches)
            print("tools.accuracy_eval %s: %.2f s (evaluations %s s), "
                  "launches %s, on [%s]" % (
                      " ".join(extra), secs,
                      [e["eval_seconds"] for e in traj["evals"][-evals:]],
                      {k: v for k, v in launches.items() if v}, smi))
        with open(os.path.join(out, "accuracy_trajectory.json")) as f:
            traj = json.load(f)
        tags = [e["tag"] for e in traj["evals"]]
        losses = [float(re.search(r"total loss: (\S+),", line).group(1))
                  for line in traj["losses"]]
        keys = {"tag", "bev_ap@0.5", "bev_ap@0.7", "official",
                "official_proper_projection", "official_quality_regressed",
                "eval_seconds"}
        if (tags != ["iter0", "iter2", "iter4", "iter6"]
                or any(set(e) != keys for e in traj["evals"])
                or len(losses) != 3 or not np.isfinite(losses).all()):
            raise AssertionError("accuracy trajectory: tags %s, losses %s, "
                                 "keys %s" % (tags, losses,
                                              [sorted(e) for e in
                                               traj["evals"]]))
        print("accuracy trajectory: %s, losses %s, BEV AP@0.5 %s (random "
              "VGG-style weights, 6 iterations)" % (
                  tags, losses, [e["bev_ap@0.5"] for e in traj["evals"]]))
        imdb = get_imdb("kitti_train", kitti_path=root)
        roidb = prepare_roidb(imdb)
        cfg.TRAIN.LR_DECAY = False
        try:
            printed_lines(solver_mod.train_net, imdb, roidb, out,
                          max_iters=8, compute_dtype=torch.bfloat16,
                          resume=True)
        except ValueError as e:
            if "LR_DECAY" not in str(e):
                raise
            print("a constant-lr resume of the decayed snapshot raised: %s"
                  % str(e).replace(tmp, "<tmp>"))
        else:
            raise AssertionError("train_net resumed a decayed snapshot with "
                                 "LR_DECAY off")
    return total


# the hand kernel each wrapper's count stands for, as a trace names it
KERNEL_SYMBOL = {"roi_pool": "roi_pool_kernel",
                 "roi_pool_bwd": "roi_pool_bwd_kernel",
                 "vgg_stem": "stem_s2d_bf16_kernel",
                 "stem_s2d_fused": "stem_s2d_bf16_kernel",
                 "bev_place": "bev_place_chunks",
                 "conv_s8": "conv_s8_wgmma", "conv2x2_s8": "conv_s8_wgmma",
                 "matmul_s8": "matmul_s8_wgmma"}


def raw_sequence(root, raw_root, seq):
    """A KITTI-raw sequence from the synthetic tree's train frames: a
    tracklet XML of their cars (one pose each, box bottom at the lidar box's
    floor, no yaw) through tools.tracklet2label into gt_boxes3d/, each
    frame's image, raster and scan, and frame 0's calib as calib.txt."""
    imdb = get_imdb("kitti_train", kitti_path=root)
    obj = os.path.join(root, "object", "training")
    seq_dir = os.path.join(raw_root, seq)
    items = []
    for i, index in enumerate(imdb.image_index):
        for x, y, z, l, w, h in imdb.roidb[i]["boxes_3D"]:
            items.append(
                "<item><objectType>Car</objectType><h>%r</h><w>%r</w>"
                "<l>%r</l><first_frame>%d</first_frame><poses><count>1"
                "</count><item><tx>%r</tx><ty>%r</ty><tz>%r</tz><rz>0</rz>"
                "</item></poses></item>" % (float(h), float(w), float(l), i,
                                            float(x), float(y),
                                            float(z - h / 2)))
        for sub, ext in (("image_2", ".png"), ("lidar_bv", ".npy"),
                         ("velodyne", ".bin")):
            os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)
            shutil.copy(os.path.join(obj, sub, index + ext),
                        os.path.join(seq_dir, sub, "%010d%s" % (i, ext)))
    xml = os.path.join(raw_root, "tracklet_labels.xml")
    with open(xml, "w") as f:
        f.write("<?xml version=\"1.0\"?><boost_serialization><tracklets>"
                "<count>%d</count>%s</tracklets></boost_serialization>"
                % (len(items), "".join(items)))
    tracklet2label.main(["--xml", xml, "--out",
                         os.path.join(seq_dir, "gt_boxes3d")])
    shutil.copy(os.path.join(obj, "calib", imdb.image_index[0] + ".txt"),
                os.path.join(seq_dir, "calib.txt"))
    return imdb.num_images, len(items)


def phase_tools(np_params, root, weights, smi):
    """The trace and profile tools on the card at the reference shapes, each
    main(argv) with the counts zeroed just before and read just after, the
    He weights standing in for profiling.he_params: trace_detect (bf16 B=4;
    int8 B=8 with the s2d_int8 stem, int8 head and RPN, blocked_fixed NMS,
    pre-NMS 1024), trace_train (bf16), profile_stages (B=4), profile_bev
    (B=8 x 131072) and profile_train (full and plain_pool), 2 steps each.
    Each must launch its hand kernels, and a trace tool must name them in
    its table. Then tools.tracklet2label on an XML of the tree's train
    cars, a kitti_raw_<seq> imdb through get_imdb, and 2 solver.train_net
    iterations on it (bf16, device dataset). Returns the counts."""
    total = {}
    he = profiling.he_params
    profiling.he_params = lambda device, seed=0: params_from_jax(
        np_params, device=device)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            runs = (
                ("trace_detect bf16 B=4", trace_detect.main,
                 ["--batch", "4", "--steps", "2", "--top", "12"],
                 ("vgg_stem", "roi_pool")),
                ("trace_detect int8 B=8 --stem s2d_int8", trace_detect.main,
                 ["--batch", "8", "--steps", "2", "--top", "12", "--int8",
                  "--stem", "s2d_int8", "--int8-head", "--int8-rpn",
                  "--nms", "blocked_fixed", "--pre-nms", "1024"],
                 ("conv_s8", "conv2x2_s8", "matmul_s8", "roi_pool")),
                ("trace_train bf16", trace_train.main,
                 ["--steps", "2", "--top", "12"],
                 ("roi_pool", "roi_pool_bwd")),
                ("profile_stages B=4", profile_stages.main,
                 ["--batch", "4", "--iters", "2"], ("vgg_stem", "roi_pool")),
                ("profile_bev B=8", profile_bev.main,
                 ["--batch", "8", "--iters", "2"], ("bev_place",)),
                ("profile_train full, plain_pool", profile_train.main,
                 ["--iters", "2", "--variants", "full", "plain_pool"],
                 ("roi_pool", "roi_pool_bwd")))
            for i, (name, fn, argv, want) in enumerate(runs):
                if fn in (trace_detect.main, trace_train.main):
                    argv = argv + ["--out", os.path.join(tmp, str(i))]
                zero_all_launches()
                t0 = time.perf_counter()
                res = fn(argv)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launches = all_launches()
                missing = [k for k in want if not launches[k]]
                if missing:
                    raise AssertionError("%s launched no %s: %s"
                                         % (name, missing, launches))
                if fn in (trace_detect.main, trace_train.main):
                    named = {trace_detect.function_of(n) for n in res["hand"]}
                    unnamed = {KERNEL_SYMBOL[k] for k in want} - named
                    if res["lane"] != "device" or unnamed:
                        raise AssertionError("%s: the trace's table does not "
                                             "name %s" % (name, unnamed))
                    print("%s: busy %.3f of %.3f ms traced, idle share %.3f; "
                          "top ops (ms over the trace) %s; hand kernels %s" % (
                              name, res["busy_ms"], res["span_ms"],
                              res["idle_share"],
                              [(n[:40], round(ms, 4), c)
                               for n, ms, c in res["ops"][:5]],
                              {n: (round(ms, 4), c)
                               for n, (ms, c) in res["hand"].items()}))
                add_launches(total, launches)
                print("tools.%s: %.2f s, launches %s, on [%s]" % (
                    name, secs, {k: v for k, v in launches.items() if v},
                    smi))
        with tempfile.TemporaryDirectory() as tmp, saved_cfg(tmp):
            seq = "2011_09_26_drive_0001"
            frames, cars = raw_sequence(root, os.path.join(tmp, "raw"), seq)
            imdb = get_imdb("kitti_raw_" + seq,
                            kitti_path=os.path.join(tmp, "raw"))
            roidb = prepare_roidb(imdb)
            n_gt = sum(len(r["gt_classes"]) for r in roidb)
            if not isinstance(imdb, KittiRaw) or imdb.num_images != frames \
                    or n_gt != cars:
                raise AssertionError("kitti_raw_%s: %d frames, %d gt"
                                     % (seq, imdb.num_images, n_gt))
            zero_all_launches()
            t0 = time.perf_counter()
            _, lines = printed_lines(
                solver_mod.train_net, imdb, roidb,
                get_output_dir(imdb, None), pretrained_model=weights,
                max_iters=2, compute_dtype=torch.bfloat16, display=1)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = all_launches()
            want = dict(dict.fromkeys(launches, 0), roi_pool=4,
                        roi_pool_bwd=4)
            if launches != want:
                raise AssertionError("train_net on kitti_raw launched %s != %s"
                                     % (launches, want))
            add_launches(total, launches)
            print("tools.tracklet2label -> kitti_raw_%s (%d frames, %d gt "
                  "cars) -> train_net bf16, 2 iterations: %.2f s, speed lines "
                  "%s s/iter, launches %s, on [%s]" % (
                      seq, frames, cars, secs, check_train_log(lines, seq),
                      {k: v for k, v in launches.items() if v}, smi))
    finally:
        profiling.he_params = he
    return total


# the legacy 2D Faster R-CNN (VGG16, stride 16, fc 4096, 21 classes): the
# solver's bucket and conv5_3, the demo's bucket, the pool's scale
BUCKET_2D, DEMO_BUCKET_2D = (608, 1024), (608, 800)
FEAT_2D = (BUCKET_2D[0] // 16, BUCKET_2D[1] // 16)        # 38 x 64
SCALE_2D = 1.0 / 16
ROIS_2D, TRAIN_ROIS_2D, GT_2D = 2000, 128, 32
IM_INFO_2D = np.array([600.0, 1000.0, 1.6], np.float32)
DETECT_2D_CALLS, TRAIN_2D_STEPS = 10, 3
BF16_2D_RTOL = 2 ** -6   # bf16 detector outputs, relative to each max


def phase_roi_2d(gen, smi):
    """Both ROI kernels at the 2D path's shapes against their plain
    versions: the forward over 2000 rois (make_rois' random and edge rois
    in a 608x1024 image) on a 38x64x512 conv5_3 at 1/16, float32 and bf16,
    on a distinct and a post-ReLU map, bit for bit; the gradient over 128
    rois within BWD_RTOL * max + BWD_ATOL. Checks that C = 512 meets the
    16-byte path's condition (C a multiple of the pack, both pointers
    16-byte aligned) and that the set holds bins 10 cells wide (a whole-map
    roi's 64 columns in 7 bins). Prints the kernels' times (raw launches of
    the C entry) beside the plain versions' and the bound."""
    H, W = FEAT_2D
    x = torch.randn((H, W, 512), generator=gen).cuda()
    rois = make_rois(gen, ROIS_2D - 6, *BUCKET_2D, 1)
    hs, he, ws, we = bin_bounds(rois, 7, SCALE_2D, H, W).unbind(1)
    widest, tallest = int((we - ws).max()), int((he - hs).max())
    if widest < 10:
        raise AssertionError("2D roi set: widest bin %d cells < 10" % widest)
    brois = make_rois(gen, TRAIN_ROIS_2D - 6, *BUCKET_2D, 1)
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        for kind, m in (("distinct", x), ("sparse", F.relu(x))):
            feat = m.to(dtype)
            out = roi_pool_cuda(feat, rois, 7, SCALE_2D)
            ref = roi_pool(feat, rois, 7, SCALE_2D)
            if not torch.equal(out, ref):
                raise AssertionError("roi_pool 2D %s %s: kernel != plain, max "
                                     "|diff| %g" % (dtype, kind,
                                                    max_err(out, ref)))
            pack = 16 // feat.element_size()
            if not (512 % pack == 0 and feat.data_ptr() % 16 == 0
                    and out.data_ptr() % 16 == 0):
                raise AssertionError("roi_pool 2D %s: not on the 16-byte path"
                                     % dtype)
            bout = roi_pool_cuda(feat, brois, 7, SCALE_2D)
            dy = torch.rand(bout.shape, generator=gen).cuda()
            got = roi_pool_bwd_cuda(feat, brois, bout, dy, 7, SCALE_2D)
            want = roi_pool_bwd(feat, brois, bout, dy, 7, SCALE_2D)
            err = max_err(got, want)
            tol = BWD_RTOL * want.abs().max().item() + BWD_ATOL
            if not err <= tol:
                raise AssertionError("roi_pool_bwd 2D %s %s: max |diff| %g > "
                                     "%g" % (dtype, kind, err, tol))
            print("roi_pool 2D %s %s (38,64,512) rois=%d: bit-identical to "
                  "plain, 16-byte path; roi_pool_bwd rois=%d: max |diff| %g "
                  "<= %g" % (dtype, kind, rois.shape[0], brois.shape[0], err,
                             tol))
            if kind == "sparse":
                times[dtype] = (feat, out, bout, dy)
    for dtype, (feat, out, bout, dy) in times.items():
        k = cuda_ms(roi_entry(feat[None], rois, out, SCALE_2D))
        p = cuda_ms(lambda: roi_pool(feat, rois, 7, SCALE_2D), iters=3,
                    warmup=1)
        fb = bound([(nbytes(feat, rois, out),
                     bin_cells_total(rois, H, W, SCALE_2D) * 512)], F32_PER_S)
        scratch = torch.zeros(feat.shape, device="cuda")
        kb = cuda_ms(roi_bwd_entry(feat, brois, bout, dy, scratch, SCALE_2D))
        pb = cuda_ms(lambda: roi_pool_bwd(feat, brois, bout, dy, 7, SCALE_2D),
                     iters=3, warmup=1)
        bb = bound([(nbytes(feat, brois, bout, dy, scratch),
                     2 * bin_cells_total(brois, H, W, SCALE_2D) * 512)],
                   F32_PER_S)
        print("roi_pool 2D time %s (38,64,512) rois=%d: kernel alone %.4f ms, "
              "plain %.4f ms, bound %.4f ms (%s); roi_pool_bwd rois=%d: "
              "kernel alone %.4f ms, plain %.4f ms, bound %.4f ms (%s); "
              "bins up to %dx%d cells; on [%s]" % (
                  dtype, rois.shape[0], k, p, fb["bound_ms"], fb["bound_by"],
                  brois.shape[0], kb, pb, bb["bound_ms"], bb["bound_by"],
                  tallest, widest, smi))


def nms_matrix_rounds(boxes, scores, valid, thr):
    """The fixpoint rounds nms_matrix takes on these candidates (its loop,
    counted), and the candidates' stable score order."""
    order = torch.sort(torch.where(valid, scores, -1e30), descending=True,
                       stable=True)[1]
    b, v = boxes[order], valid[order]
    sup = ((bbox_overlaps(b, b) >= thr).triu(1) & v[:, None]
           & v[None, :]).float()
    kept, rounds = v, 0
    while True:
        rounds += 1
        new = v & (kept.float() @ sup < 0.5)
        if torch.equal(new, kept):
            return rounds, order
        kept = new


def check_nms_matrix(seen, what):
    """nms_matrix's keep set on one call's candidates against the host
    greedy loop nms_np over the same boxes in the layer's stable score
    order (strictly decreasing stand-in scores, so the loop keeps that
    order). Returns (fixpoint rounds, kept, candidates)."""
    boxes, scores, valid, max_out, thr, keep_idx, keep_valid = seen
    rounds, order = nms_matrix_rounds(boxes, scores, valid, thr)
    order = order[valid[order]].cpu().numpy()
    b = boxes.cpu().numpy()[order]
    dets = np.hstack([b, (len(b) - np.arange(len(b), dtype=np.float32))[
        :, None]]).astype(np.float32)
    want = order[nms_np(dets, thr)[:max_out]]
    got = keep_idx[keep_valid].cpu().numpy()
    if not np.array_equal(got, want):
        raise AssertionError("%s: nms_matrix kept %d boxes, nms_np %d; first "
                             "difference at %s" % (
                                 what, len(got), len(want),
                                 int(np.argmax(got[:len(want)]
                                               != want[:len(got)]))))
    return rounds, len(got), len(order)


class CaptureNmsMatrix:
    """faster_rcnn_2d's nms_matrix, recording each call's inputs and
    outputs while active."""

    def __enter__(self):
        self.seen, self.saved = [], F2.nms_matrix

        def capture(boxes, scores, valid, max_out, thr):
            keep = self.saved(boxes, scores, valid, max_out, thr)
            self.seen.append((boxes, scores, valid, max_out, thr) + keep)
            return keep

        F2.nms_matrix = capture
        return self.seen

    def __exit__(self, *exc):
        F2.nms_matrix = self.saved


def phase_detect_2d(np2d, smi):
    """faster_rcnn_2d.build_im_detect_2d at full width on a 608x1024 image
    (im_info 600x1000 at 1.6) with test_net's proposal budget (pre-NMS
    12000, post-NMS 2000), float32 and bf16: a warm-up then DETECT_2D_CALLS
    timed calls, one ROI kernel launch each (counts zeroed just before,
    read just after). Then the same call through the plain pool: rois and
    keep set equal, scores and boxes bit for bit in float32 and within
    BF16_2D_RTOL of each max in bf16; and nms_matrix's keep set on the
    call's own candidates equal to nms_np's. Returns the launch counts."""
    params = params_from_jax(np2d, device="cuda")
    rng = np.random.RandomState(SEED + 7)
    image = torch.from_numpy((rng.rand(*BUCKET_2D, 3) * 255 - PIXEL_MEANS)
                             .astype(np.float32)).cuda()
    im_info = torch.from_numpy(IM_INFO_2D).cuda()
    kw = dict(pre_nms_top_n=cfg.TEST.RPN_PRE_NMS_TOP_N,
              post_nms_top_n=cfg.TEST.RPN_POST_NMS_TOP_N)
    total = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        detect = F2.build_im_detect_2d(*FEAT_2D, compute_dtype=dtype, **kw)
        zero_all_launches()
        with CaptureNmsMatrix() as seen:
            out, warm_ms = timed(detect, params, image, im_info)
        times = [timed(detect, params, image, im_info)[1]
                 for _ in range(DETECT_2D_CALLS)]
        launches = all_launches()
        want = dict(dict.fromkeys(launches, 0), roi_pool=1 + DETECT_2D_CALLS)
        if launches != want:
            raise AssertionError("im_detect_2d %s launched %s != %s"
                                 % (name, launches, want))
        add_launches(total, launches)
        n_valid = int(out["valid"].sum())
        ok = (torch.isfinite(out["scores"]).all()
              and torch.isfinite(out["boxes"]).all() and n_valid > 0
              and torch.allclose(out["scores"][out["valid"]].sum(1),
                                 torch.ones(n_valid, device="cuda")))
        if not ok:
            raise AssertionError("im_detect_2d %s: outputs" % name)
        ref = F2.build_im_detect_2d(*FEAT_2D, compute_dtype=dtype,
                                    pool=roi_pool, **kw)(params, image,
                                                         im_info)
        for k in ("rois", "valid"):
            if not torch.equal(out[k], ref[k]):
                raise AssertionError("im_detect_2d %s: %s differ from the "
                                     "plain pool's" % (name, k))
        errs = {k: max_err(out[k], ref[k]) for k in ("scores", "boxes")}
        for k, e in errs.items():
            tol = 0.0 if dtype is None else (
                BF16_2D_RTOL * ref[k].abs().max().item())
            if not e <= tol:
                raise AssertionError("im_detect_2d %s: %s max |diff| %g > %g "
                                     "against the plain pool" % (name, k, e,
                                                                 tol))
        rounds, kept, cands = check_nms_matrix(seen[0], "im_detect_2d " + name)
        nms_ms = timed(nms_matrix, *seen[0][:5])[1]
        print("im_detect_2d %s 608x1024 (pre-NMS %d, post-NMS %d): p50 %.3f "
              "ms over %d calls (%s) after a %.3f ms warm-up; %d valid rois; "
              "vs the plain pool: rois and keep set equal, scores/boxes max "
              "|diff| %s; nms_matrix on %d candidates: %d kept = nms_np's, "
              "%d fixpoint rounds, %.3f ms; launches %s; on [%s]" % (
                  name, kw["pre_nms_top_n"], kw["post_nms_top_n"],
                  float(np.median(times)), DETECT_2D_CALLS,
                  ", ".join("%.3f" % t for t in times), warm_ms, n_valid,
                  errs, cands, kept, rounds, nms_ms,
                  {k: v for k, v in launches.items() if v}, smi))
    return total


def train_batch_2d(rng, n_gt=5):
    """One 608x1024 training image (mean-subtracted noise, im_info 600x1000
    at 1.6) with n_gt gt boxes of VOC classes, padded to GT_2D rows."""
    gt = np.zeros((GT_2D, 5), np.float32)
    xy = rng.uniform(0, 700, (n_gt, 2)) * [1.0, 0.6]
    wh = rng.uniform(80, 300, (n_gt, 2))
    gt[:n_gt, :4] = np.concatenate([xy, np.minimum(xy + wh, [999, 599])], 1)
    gt[:n_gt, 4] = rng.randint(1, 21, n_gt)
    return {"image": torch.from_numpy(
                (rng.rand(*BUCKET_2D, 3) * 255 - PIXEL_MEANS)
                .astype(np.float32)).cuda(),
            "im_info": torch.from_numpy(IM_INFO_2D).cuda(),
            "gt_boxes": torch.from_numpy(gt).cuda(),
            "gt_valid": (torch.arange(GT_2D) < n_gt).cuda()}


def phase_train_2d(np2d, smi):
    """faster_rcnn_2d.build_train_step_2d at full width (pre-NMS 12000,
    post-NMS 2000, 128 rois, momentum SGD) on a 608x1024 image, float32 and
    bf16, fresh params each: a warm-up and TRAIN_2D_STEPS timed steps.
    Checks finite metrics and a positive loss every step, conv1/conv2 bit
    for bit unchanged, fc6 and conv3_1 moved, and one forward and one
    backward ROI launch a step (counts zeroed just before, read just
    after). Then, in float32, one forward and backward through the kernel
    pair against the plain pair on the same draws: the loss within 1e-6
    and every gradient within 1e-4 of its max. Returns the counts."""
    batch = train_batch_2d(np.random.RandomState(SEED + 8))
    kw = dict(pre_nms_top_n=TRAIN_PRE_NMS, post_nms_top_n=TRAIN_POST_NMS,
              rois_per_image=TRAIN_ROIS_2D)
    draw_args = (FEAT_2D[0] * FEAT_2D[1] * 9, TRAIN_POST_NMS + GT_2D,
                 TRAIN_ROIS_2D, 4096, 0.5, "cuda")
    zero_all_launches()
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        params = params_from_jax(np2d, device="cuda")
        frozen = {k: [t.detach().clone() for t in params[k].parameters()]
                  for k in ("conv1_1", "conv1_2", "conv2_1", "conv2_2")}
        watch = {k: params[k].weight.detach().clone()
                 for k in ("conv3_1", "fc6")}
        step, make_opt = F2.build_train_step_2d(*FEAT_2D, compute_dtype=dtype,
                                                **kw)
        opt, sched = make_opt(params)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
        results = []
        for _ in range(1 + TRAIN_2D_STEPS):
            m, ms = timed(step, params, opt, sched, batch,
                          F2.make_draws_2d(gen, *draw_args))
            if not (all(torch.isfinite(v) for v in m.values())
                    and m["loss"].item() > 0):
                raise AssertionError("train 2D %s: metrics %s" % (
                    name, {k: v.item() for k, v in m.items()}))
            results.append((m["loss"].item(), ms))
        moved = [k for k in frozen if not all(
            torch.equal(a, b) for a, b in zip(params[k].parameters(),
                                              frozen[k]))]
        still = [k for k, w in watch.items()
                 if torch.equal(params[k].weight, w)]
        if moved or still:
            raise AssertionError("train 2D %s: frozen layers moved %s, "
                                 "trained layers still %s" % (name, moved,
                                                              still))
        times = [ms for _, ms in results[1:]]
        print("train step 2D %s 608x1024: p50 %.3f ms/step over %d steps (%s) "
              "after a %.3f ms warm-up; losses %s; conv1/conv2 bit for bit "
              "unchanged; on [%s]" % (
                  name, float(np.median(times)), TRAIN_2D_STEPS,
                  ", ".join("%.3f" % t for t in times), results[0][1],
                  ", ".join("%.4f" % v for v, _ in results), smi))
        del params, opt, step
    launches = all_launches()
    steps = 2 * (1 + TRAIN_2D_STEPS)
    want = dict(dict.fromkeys(launches, 0), roi_pool=steps,
                roi_pool_bwd=steps)
    if launches != want:
        raise AssertionError("train 2D launched %s != %s" % (launches, want))

    draws = F2.make_draws_2d(torch.Generator(device="cuda").manual_seed(1),
                             *draw_args)
    grads = {}
    for name, pool in (("kernel", roi_pool_train),
                       ("plain", roi_pool_train_plain)):
        params = params_from_jax(np2d, device="cuda")
        loss = F2.build_forward_losses_2d(*FEAT_2D, pool=pool, **kw)(
            params, batch, draws)["loss"]
        loss.backward()
        grads[name] = (loss.item(), {k: p.grad for k, p in
                                     params.named_parameters()})
        del params
    (loss_k, g_k), (loss_p, g_p) = grads["kernel"], grads["plain"]
    if not abs(loss_k - loss_p) <= 1e-6 * abs(loss_p):
        raise AssertionError("train 2D loss: kernel pair %r, plain pair %r"
                             % (loss_k, loss_p))
    worst = 0.0
    for k, g in g_p.items():
        err, scale = max_err(g_k[k], g), g.abs().max().item()
        if not err <= 1e-4 * scale:
            raise AssertionError("train 2D gradient of %s: max |diff| %g > "
                                 "1e-4 * %g" % (k, err, scale))
        worst = max(worst, err / scale if scale else 0.0)
    print("f32 2D train step through the kernel pair vs the plain pair: loss "
          "%.7f vs %.7f; worst gradient max |diff| / max |g| %.3g over %d "
          "tensors; train-path launches %s" % (
              loss_k, loss_p, worst, len(g_p),
              {k: v for k, v in launches.items() if v}))
    return launches


def phase_clis_2d(smi):
    """The 2D CLIs on a synthetic VOC tree of 4 375x500 JPEGs
    (data/synthetic.generate_voc), at full width in bf16 (their default):
    tools.train_net --network VGGnet_train for 2 iterations with
    TRAIN.HAS_RPN on through a cfg file (one snapshot), tools.test_net
    --network VGGnet_test on that snapshot over the test split (the VOC AP
    table), and tools.demo on one image (its PNG). Each run's launches are
    zeroed just before and read just after: 1 forward and 1 backward an
    iteration, 1 forward an image. Returns the counts."""
    total = {}
    with tempfile.TemporaryDirectory() as tmp, saved_cfg(tmp):
        devkit = synthetic.generate_voc(os.path.join(tmp, "VOCdevkit"),
                                        num_images=4, seed=SEED)
        yml = os.path.join(tmp, "end2end.yml")
        with open(yml, "w") as f:
            f.write("TRAIN:\n  HAS_RPN: True\n")
        where = ["--devkit_path", devkit, "--set", "ROOT_DIR", tmp,
                 "DATA_DIR", os.path.join(tmp, "data")]
        snap = os.path.join(tmp, "output", "default", "voc_2007_trainval",
                            "VGGnet_fast_rcnn_iter_2.pt")
        jpg = os.path.join(devkit, "VOC2007", "JPEGImages", "000001.jpg")
        runs = (("tools.train_net VGGnet_train, 2 iterations",
                 train_net_cli.main,
                 ["--network", "VGGnet_train", "--imdb", "voc_2007_trainval",
                  "--iters", "2", "--cfg", yml] + where + ["TRAIN.DISPLAY",
                                                           "1"],
                 dict(roi_pool=2, roi_pool_bwd=2)),
                ("tools.test_net VGGnet_test, 4 images", test_net.main,
                 ["--network", "VGGnet_test", "--imdb", "voc_2007_test",
                  "--weights", snap] + where, dict(roi_pool=4)),
                ("tools.demo, 1 image", demo_2d.main,
                 ["--image", jpg, "--weights", snap, "--out",
                  os.path.join(tmp, "demo")], dict(roi_pool=1)))
        for name, fn, argv, counts in runs:
            zero_all_launches()
            t0 = time.perf_counter()
            res, lines = printed_lines(fn, argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = all_launches()
            want = dict(dict.fromkeys(launches, 0), **counts)
            if launches != want:
                raise AssertionError("%s launched %s != %s"
                                     % (name, launches, want))
            add_launches(total, launches)
            if fn is train_net_cli.main:
                losses = [float(re.search(r"total loss: (\S+) ", line)
                                .group(1)) for line in lines
                          if line.startswith("iter: ")]
                if len(losses) != 2 or not np.isfinite(losses).all() \
                        or not os.path.getsize(snap):
                    raise AssertionError("%s: losses %s" % (name, losses))
                what = "losses %s, snapshot %.0f MB" % (
                    losses, os.path.getsize(snap) / 1e6)
            elif fn is test_net.main:
                if len(res) != 20 or not all(0.0 <= v <= 1.0
                                             for v in res.values()):
                    raise AssertionError("%s: APs %s" % (name, res))
                what = "VOC mean AP %.4f (random weights)" % np.mean(
                    list(res.values()))
            else:
                path, dets = res
                if os.path.getsize(path) < 1000:
                    raise AssertionError("%s wrote %s" % (name, path))
                what = "PNG %d bytes, %d detections" % (
                    os.path.getsize(path), sum(dets.values()))
            print("%s: %.2f s, %s, launches %s, on [%s]" % (
                name, secs, what, {k: v for k, v in launches.items() if v},
                smi))
    return total


# the Fast R-CNN step over precomputed proposals (cfg.TRAIN.HAS_RPN off):
# 2 images a batch, 128 rois, at SCALES_BASE (1.0,) (2 levels) and at
# kitti_rcnn.yml's [1, 2, 3, 4] with IS_MULTISCALE (8 levels)
FAST_RCNN_IMS, FAST_RCNN_STEPS, BATCHED_LEVELS = 2, 3, 8
KITTI_RCNN_YML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "experiments", "cfgs", "kitti_rcnn.yml")


def batched_bwd_rois(gen, levels):
    """(rois, check set) on `levels` frames of the 2D map: 128 rois
    (make_rois' random and edge rois) dealt across the frames in random
    order; the check set adds rois whose frame column truncates (2.7) or
    lies past the last frame (levels, levels + 3.5: clamped to it) and the
    stress rois, at 1/16, on the last frame."""
    rois = make_rois(gen, TRAIN_ROIS_2D - 6, *BUCKET_2D, levels)
    rois = rois[torch.randperm(rois.shape[0], generator=gen).cuda()]
    odd = rois[:3].clone()
    odd[:, 0] = torch.tensor([2.7, levels, levels + 3.5])
    # stress_rois at 1/8 of half the image: doubled, the same cells at 1/16
    stress = stress_rois(BUCKET_2D[0] // 2, BUCKET_2D[1] // 2, levels - 1)
    stress[:, 1:] *= 2
    return rois, torch.cat([rois, odd, stress])


def phase_roi_bwd_batched(gen, smi):
    """The backward kernel over a batched map, the Fast R-CNN step's pyramid:
    BATCHED_LEVELS levels of 38x64x512 at 1/16, the rois of every level in
    one call (batched_bwd_rois), against the batched plain version within
    BWD_RTOL * max|ref| + BWD_ATOL, float32 and bf16, on a post-ReLU and a
    few-level (tied) map; dfeat's total equals the non-empty bins' dy.
    Then the 3-D call, the launch with B = 1: on phase_roi_bwd's BEV map
    (75x75x512) 25 rois of 14x14 cells tile the map, so no two bins share
    a cell and every sum is exact; the 3-D call, the 4-D call with B = 1
    and the plain version give the same dfeat bit for bit, with the rois'
    frame column at 5 (clamped to 0), in both dtypes and on both maps.
    Prints the times at 128 rois (kernel alone, wrapper, plain) beside the
    bound; returns the float32 numbers."""
    H, W = FEAT_2D
    L = BATCHED_LEVELS
    x = torch.randn((L, H, W, 512), generator=gen).cuda()
    maps = {"sparse": F.relu(x), "levels": (x * 2).round().clamp(0, 4) / 2}
    rois, check = batched_bwd_rois(gen, L)
    frames = sorted(set(check[:, 0].int().clamp(0, L - 1).tolist()))
    if frames != list(range(L)):
        raise AssertionError("batched rois reach frames %s" % frames)
    hs, he, ws, we = bin_bounds(check, 7, SCALE_2D, H, W).unbind(1)
    nonempty = ((he > hs)[:, :, None] & (we > ws)[:, None, :])[..., None]
    stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        for kind, m in maps.items():
            feat = m.to(dtype)
            out = roi_pool_cuda(feat, check, 7, SCALE_2D)
            if not torch.equal(out, roi_pool(feat, check, 7, SCALE_2D)):
                raise AssertionError("roi_pool batched %s %s: kernel != plain"
                                     % (dtype, kind))
            dy = torch.rand(out.shape, generator=gen).cuda()
            got = roi_pool_bwd_cuda(feat, check, out, dy, 7, SCALE_2D)
            ref = roi_pool_bwd(feat, check, out, dy, 7, SCALE_2D)
            err = max_err(got, ref)
            tol = BWD_RTOL * ref.abs().max().item() + BWD_ATOL
            what = "roi_pool_bwd batched (%d,38,64,512) %s %s rois=%d" % (
                L, dtype, kind, check.shape[0])
            if got.shape != feat.shape or not err <= tol:
                raise AssertionError("%s: max |diff| %g > %g" % (what, err,
                                                                 tol))
            mass = got.double().sum().item()
            want = (dy.double() * nonempty).sum().item()
            if not abs(mass - want) <= 1e-5 * abs(want):
                raise AssertionError("%s: dfeat sums to %r, the non-empty "
                                     "bins' dy to %r" % (what, mass, want))
            print("%s: max |diff| %g <= %g, mass %.6f of %.6f"
                  % (what, err, tol, mass, want))
            if kind != "sparse":
                continue
            o = roi_pool_cuda(feat, rois, 7, SCALE_2D)
            d = torch.rand(o.shape, generator=gen).cuda()
            scratch = torch.zeros(feat.shape, device="cuda")
            k = cuda_ms(roi_bwd_entry(feat, rois, o, d, scratch, SCALE_2D))
            w = cuda_ms(lambda: roi_pool_bwd_cuda(feat, rois, o, d, 7,
                                                  SCALE_2D))
            p = cuda_ms(lambda: roi_pool_bwd(feat, rois, o, d, 7, SCALE_2D),
                        iters=3, warmup=1)
            b = bound([(nbytes(feat, rois, o, d, scratch),
                        2 * bin_cells_total(rois, H, W, SCALE_2D) * 512)],
                      F32_PER_S)
            stats[dtype] = dict(ms=k, wrapper_ms=w, plain_ms=p, **b)
            print("roi_pool_bwd batched time %s (%d,38,64,512) rois=128: "
                  "kernel alone %.4f ms, wrapper %.4f ms (with its dfeat "
                  "torch.zeros), plain %.4f ms, bound %.4f ms (%s); on [%s]"
                  % (dtype, L, k, w, p, b["bound_ms"], b["bound_by"], smi))
    shape = BWD_VIEWS["bev"][0]
    x3 = torch.randn(shape, generator=gen).cuda()
    tiles = torch.tensor([[5.0, 112 * i, 112 * j, 112 * i + 104,
                           112 * j + 104] for i in range(5) for j in range(5)],
                         device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for kind, m in (("sparse", F.relu(x3)),
                        ("levels", (x3 * 2).round().clamp(0, 4) / 2)):
            feat = m.to(dtype)
            out = roi_pool_cuda(feat, tiles)
            dy = torch.rand(out.shape, generator=gen).cuda()
            ref = roi_pool_bwd(feat, tiles, out, dy)
            three = roi_pool_bwd_cuda(feat, tiles, out, dy)
            one = roi_pool_bwd_cuda(feat[None], tiles, out, dy)
            if not (torch.equal(three, ref) and torch.equal(one[0], ref)):
                raise AssertionError(
                    "roi_pool_bwd 3-D %s %s: 3-D %g, B=1 %g off the plain "
                    "version" % (dtype, kind, max_err(three, ref),
                                 max_err(one[0], ref)))
    print("roi_pool_bwd 3-D call (75,75,512), 25 disjoint 14x14-cell rois "
          "with frame column 5: the 3-D call, the B=1 call and the plain "
          "version bit for bit, f32 and bf16, sparse and tied maps")
    return stats[torch.float32]


def fast_rcnn_roidb(tmp):
    """A synthetic VOC tree (4 375x500 JPEGs) and PascalVOC's region-proposal
    roidb over it, from RPN proposal files of each gt box jittered 16 times
    and 48 random boxes, with max_classes and max_overlaps."""
    devkit = synthetic.generate_voc(os.path.join(tmp, "VOCdevkit"),
                                    num_images=4, seed=SEED + 13)
    imdb = PascalVOC("trainval", "2007", devkit)
    rng = np.random.RandomState(SEED + 14)
    d = os.path.join(devkit, "region_proposals", "RPN", "training")
    os.makedirs(d)
    for index in imdb.image_index:
        gt = imdb._load_pascal_annotation(index)["boxes"].astype(np.float64)
        xy = rng.uniform(0, 400, (48, 2))
        boxes = np.vstack([g + rng.uniform(-12, 12, (16, 4)) for g in gt]
                          + [np.hstack([xy, xy + rng.uniform(16, 200,
                                                             (48, 2))])])
        boxes = np.clip(boxes, 0, [499, 374, 499, 374])
        np.savetxt(os.path.join(d, index + ".txt"),
                   np.hstack([boxes, rng.rand(len(boxes), 1)]))
    imdb.roidb_handler = imdb.region_proposal_roidb
    roidb = imdb.roidb
    for i, e in enumerate(roidb):
        e["image_path"] = imdb.image_path_at(i)
        e["max_classes"] = e["gt_overlaps"].argmax(axis=1)
        e["max_overlaps"] = e["gt_overlaps"].max(axis=1)
    return roidb


def phase_fast_rcnn(np2d, smi):
    """faster_rcnn_2d.build_fast_rcnn_train_step at full width (VGG16, fc
    4096, 21 classes, 2 images of 128 rois a batch, 608x1024 bucket) over
    fast_rcnn_roidb's proposals, the batches built on the host by
    data/multiscale (get_minibatch_multiscale, pad_minibatch_multiscale):
    at SCALES_BASE (1.0,) (2 levels) and under kitti_rcnn.yml (IS_MULTISCALE,
    SCALES_BASE [1, 2, 3, 4]: 8 levels), float32 and bf16, fresh params
    each: a warm-up and FAST_RCNN_STEPS timed steps, finite metrics and a
    positive loss every step, conv1/conv2 bit for bit unchanged and fc6
    and conv3_1 moved, one forward and one backward ROI launch a step
    (counts zeroed just before, read just after). Then per pyramid, in
    float32, one forward and backward through the kernel pair against the
    plain pair on the same draws: the loss within 1e-6 and every gradient
    within 1e-4 of its max. Each run starts from a device copy of one
    conversion of np2d. Returns (launches, {(levels, dtype): p50})."""
    total, p50 = {}, {}
    start = params_from_jax(np2d, device="cuda")
    with tempfile.TemporaryDirectory() as tmp, saved_cfg(tmp):
        roidb = fast_rcnn_roidb(tmp)
        for yml in (None, KITTI_RCNN_YML):
            if yml:
                cfg_from_file(yml)
            levels = len(cfg.TRAIN.SCALES_BASE) * FAST_RCNN_IMS
            MS.add_bbox_regression_targets(roidb, 21)
            rng = np.random.RandomState(SEED + 15)
            batches = []
            for i in range(1 + FAST_RCNN_STEPS):
                entries = [roidb[(FAST_RCNN_IMS * i + j) % len(roidb)]
                           for j in range(FAST_RCNN_IMS)]
                blobs = MS.get_minibatch_multiscale(entries, 21, rng=rng)
                batches.append({k: torch.from_numpy(v).cuda() for k, v in
                                MS.pad_minibatch_multiscale(
                                    blobs, BUCKET_2D,
                                    cfg.TRAIN.BATCH_SIZE).items()})
            b0 = batches[0]
            used = sorted(set(b0["rois"][b0["roi_valid"], 0].int().tolist()))
            if b0["data"].shape != (levels, *BUCKET_2D, 3) or \
                    not (b0["labels"] > 0).any():
                raise AssertionError("fast rcnn %d levels: batch %s, %d fg"
                                     % (levels, tuple(b0["data"].shape),
                                        int((b0["labels"] > 0).sum())))
            draw_args = (cfg.TRAIN.BATCH_SIZE, 4096, 0.5, "cuda")
            for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
                params = copy.deepcopy(start)
                frozen = {k: [t.detach().clone()
                              for t in params[k].parameters()]
                          for k in ("conv1_1", "conv1_2", "conv2_1",
                                    "conv2_2")}
                watch = {k: params[k].weight.detach().clone()
                         for k in ("conv3_1", "fc6")}
                step, make_opt = F2.build_fast_rcnn_train_step(
                    lr=cfg.TRAIN.LEARNING_RATE, momentum=cfg.TRAIN.MOMENTUM,
                    stepsize=cfg.TRAIN.STEPSIZE, gamma=cfg.TRAIN.GAMMA,
                    compute_dtype=dtype)
                opt, sched = make_opt(params)
                gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
                zero_all_launches()
                results = []
                for batch in batches:
                    m, ms = timed(step, params, opt, sched, batch,
                                  F2.make_draws_fast_rcnn(gen, *draw_args))
                    if not (all(torch.isfinite(v) for v in m.values())
                            and m["loss"].item() > 0):
                        raise AssertionError("fast rcnn %d levels %s: "
                                             "metrics %s" % (
                                                 levels, name,
                                                 {k: v.item() for k, v
                                                  in m.items()}))
                    results.append((m["loss"].item(), ms))
                launches = all_launches()
                want = dict(dict.fromkeys(launches, 0),
                            roi_pool=len(batches), roi_pool_bwd=len(batches))
                if launches != want:
                    raise AssertionError("fast rcnn %d levels %s launched %s "
                                         "!= %s" % (levels, name, launches,
                                                    want))
                add_launches(total, launches)
                moved = [k for k in frozen if not all(
                    torch.equal(a, b) for a, b in zip(params[k].parameters(),
                                                      frozen[k]))]
                still = [k for k, w in watch.items()
                         if torch.equal(params[k].weight, w)]
                if moved or still:
                    raise AssertionError("fast rcnn %s: frozen layers moved "
                                         "%s, trained layers still %s"
                                         % (name, moved, still))
                times = [ms for _, ms in results[1:]]
                p50[(levels, name)] = float(np.median(times))
                print("fast rcnn step %d levels %s 608x1024 (rois of levels "
                      "%s): p50 %.3f ms/step over %d steps (%s) after a %.3f "
                      "ms warm-up; losses %s; conv1/conv2 bit for bit "
                      "unchanged; on [%s]" % (
                          levels, name, used, p50[(levels, name)],
                          FAST_RCNN_STEPS, ", ".join("%.3f" % t
                                                     for t in times),
                          results[0][1],
                          ", ".join("%.4f" % v for v, _ in results), smi))
                del params, opt, step
            draws = F2.make_draws_fast_rcnn(
                torch.Generator(device="cuda").manual_seed(1), *draw_args)
            grads = {}
            for name, pool in (("kernel", roi_pool_train),
                               ("plain", roi_pool_train_plain)):
                params = copy.deepcopy(start)
                loss = F2.build_fast_rcnn_forward_losses(pool=pool)(
                    params, b0, draws)["loss"]
                loss.backward()
                grads[name] = (loss.item(), {
                    k: p.grad for k, p in params.named_parameters()
                    if p.grad is not None})
                del params, loss
            (loss_k, g_k), (loss_p, g_p) = grads["kernel"], grads["plain"]
            if not abs(loss_k - loss_p) <= 1e-6 * abs(loss_p) \
                    or set(g_k) != set(g_p):
                raise AssertionError("fast rcnn %d levels loss: kernel pair "
                                     "%r, plain pair %r" % (levels, loss_k,
                                                            loss_p))
            worst = 0.0
            for k, g in g_p.items():
                err, scale = max_err(g_k[k], g), g.abs().max().item()
                if not err <= 1e-4 * scale:
                    raise AssertionError("fast rcnn %d levels gradient of %s: "
                                         "max |diff| %g > 1e-4 * %g"
                                         % (levels, k, err, scale))
                worst = max(worst, err / scale if scale else 0.0)
            print("f32 fast rcnn step %d levels through the kernel pair vs "
                  "the plain pair: loss %.7f vs %.7f; worst gradient max "
                  "|diff| / max |g| %.3g over %d tensors" % (
                      levels, loss_k, loss_p, worst, len(g_p)))
            del grads
    return total, p50


_ALT_OPT_TRAIN = """
import json, sys
import chip_smoke as C
from mv3d_tf_tpu_torch.data.kitti import get_imdb
from mv3d_tf_tpu_torch.tools import train_net
devkit, tmp = sys.argv[1:3]
# the proposal roidb, picked as the JAX package's tests pick it
imdb = get_imdb("voc_2007_trainval", devkit_path=devkit)
imdb.roidb_handler = imdb.region_proposal_roidb
C.zero_all_launches()
train_net.main(["--network", "VGGnet_train", "--imdb", "voc_2007_trainval",
                "--devkit_path", devkit, "--iters", "2", "--set", "ROOT_DIR",
                tmp, "DATA_DIR", tmp + "/data", "TRAIN.DISPLAY", "1"])
launches = C.all_launches()
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "mv3d_tf_tpu")]
assert not bad, "loaded: %s" % bad
print("launches " + json.dumps(launches))
"""


def phase_alt_opt(np2d, smi):
    """The alternating-optimisation flow on a synthetic VOC tree (4 375x500
    JPEGs) at full width: rpn_generate.imdb_proposals_det over the
    trainval split (bf16 RPN, He weights) writes one proposal file an
    image; in a subprocess that loads nothing of jax or the JAX package,
    PascalVOC.region_proposal_roidb reads them (set as the imdb's
    roidb_handler) and tools.train_net --network VGGnet_train trains Fast
    R-CNN 2 iterations with the shipped config (TRAIN.HAS_RPN off, bf16),
    writing a snapshot; tools.test_net --network VGGnet_test evaluates that
    snapshot over the test split. Each run's launches are zeroed just
    before and read just after (in the subprocess by itself): none for the
    proposals, 1 forward and 1 backward an iteration, 1 forward an image.
    Returns the counts."""
    total = {}
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp, saved_cfg(tmp):
        devkit = synthetic.generate_voc(os.path.join(tmp, "VOCdevkit"),
                                        num_images=4, seed=SEED + 17)
        imdb = PascalVOC("trainval", "2007", devkit)
        params = params_from_jax(np2d, device="cuda")
        zero_all_launches()
        t0 = time.perf_counter()
        dets = rpn_generate.imdb_proposals_det(params, imdb, log=None,
                                               compute_dtype=torch.bfloat16)
        secs = time.perf_counter() - t0
        launches = all_launches()
        if any(launches.values()):
            raise AssertionError("rpn_generate launched %s" % launches)
        del params
        d = os.path.join(devkit, "region_proposals", "RPN", "training")
        os.makedirs(d)
        for index, rows in zip(imdb.image_index, dets):
            if not (len(rows) and np.isfinite(rows).all()):
                raise AssertionError("proposals of %s: %s" % (index,
                                                               rows.shape))
            np.savetxt(os.path.join(d, index + ".txt"), rows)
        print("rpn_generate.imdb_proposals_det bf16: %d images, %s proposals "
              "each, %.2f s" % (len(dets), [len(r) for r in dets], secs))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _ALT_OPT_TRAIN, devkit, tmp], cwd=tmp,
            env=dict(os.environ, PYTHONPATH=here), capture_output=True,
            text=True, timeout=600)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError("alt-opt train_net subprocess failed:\n%s"
                                 % proc.stderr[-4000:])
        lines = proc.stdout.splitlines()
        for line in lines:
            if line.startswith(("iter: ", "Wrote snapshot", "Loaded dataset")) \
                    or line.endswith("roidb entries"):
                print(line)
        launches = json.loads(lines[-1][len("launches "):])
        want = dict(dict.fromkeys(launches, 0), roi_pool=2, roi_pool_bwd=2)
        if launches != want:
            raise AssertionError("alt-opt train_net launched %s != %s"
                                 % (launches, want))
        add_launches(total, launches)
        losses = [float(re.search(r"total loss: (\S+) ", line).group(1))
                  for line in lines if line.startswith("iter: ")]
        snap = os.path.join(tmp, "output", "default", "voc_2007_trainval",
                            "VGGnet_fast_rcnn_iter_2.pt")
        if len(losses) != 2 or not np.isfinite(losses).all() \
                or not os.path.getsize(snap):
            raise AssertionError("alt-opt train_net: losses %s" % losses)
        print("tools.train_net VGGnet_train over region proposals, HAS_RPN "
              "off, 2 iterations (subprocess, no jax): %.2f s, losses %s, "
              "snapshot %.0f MB, launches %s, on [%s]" % (
                  secs, losses, os.path.getsize(snap) / 1e6,
                  {k: v for k, v in launches.items() if v}, smi))
        zero_all_launches()
        t0 = time.perf_counter()
        aps, _ = printed_lines(test_net.main, [
            "--network", "VGGnet_test", "--imdb", "voc_2007_test",
            "--weights", snap, "--devkit_path", devkit])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = all_launches()
        want = dict(dict.fromkeys(launches, 0), roi_pool=4)
        if launches != want or len(aps) != 20 or not all(
                0.0 <= v <= 1.0 for v in aps.values()):
            raise AssertionError("alt-opt test_net: launches %s, APs %s"
                                 % (launches, aps))
        add_launches(total, launches)
        print("tools.test_net VGGnet_test on the Fast R-CNN snapshot, 4 "
              "images: %.2f s, VOC mean AP %.4f (random weights), launches "
              "%s, on [%s]" % (secs, np.mean(list(aps.values())),
                               {k: v for k, v in launches.items() if v}, smi))
    return total



# --------------------------------------------------------------------------
# The multi-device layer and the last MV3D tools
# --------------------------------------------------------------------------

# after one Adam step from equal params (lr 1e-5): a parameter moves by +-lr
# wherever its gradient is not noise, so two runs whose gradients differ in
# rounding can differ by 2 lr where a gradient is noise (ROADMAP.md), plus
# the rounding of the parameter itself. No gradient can miss this bound, so
# it stands only beside the gradients' own
ADAM_NOISE = 2 * 1e-5 * (1 + 1e-3)

# the all-reduced gradients against the mean-loss gradients taken frame by
# frame apart from parallel/mesh.py, of each leaf's largest: f32 as
# tests/test_torch_train.py holds the port's to JAX's; bf16 four bf16 ulps
# (cuDNN's weight gradients and the ROI gradient's float atomics are not
# reproducible run to run). Dropping a rank's frame or taking the sum as
# the mean is off by 0.5 or more
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -5}

# a bf16 trunk's conv5_3 against the same trunk on other shapes (cuDNN's
# algorithms round differently): 13 convs of bf16 rounding, of the max
TRUNK_BF16_RTOL = 2 ** -6

# the bf16 row-sharded detector's valid BEV boxes within 1 pixel of one of
# the single-frame detector's, at the least
BF16_SET_MATCH = 0.9


def set_match(got, ref, px=1.0):
    """How many of got's valid BEV boxes (class 1) lie within px of one of
    ref's."""
    g = got["boxes_bv"][got["valid"]][:, 4:8].float().cpu()
    r = ref["boxes_bv"][ref["valid"]][:, 4:8].float().cpu()
    if not len(g) or not len(r):
        return 0
    return int(((g[:, None] - r[None]).abs().amax(-1).amin(1) <= px).sum())


def close_dets(got, ref, tol, keys=("scores", "boxes_bv", "boxes_cnr_r")):
    """(valid equal, worst max |got - ref| / max |ref| over keys)."""
    same_valid = torch.equal(got["valid"].cpu(), ref["valid"].cpu())
    worst = max(max_err(got[k].float().cpu(), ref[k].float().cpu())
                / max(ref[k].float().abs().max().item(), 1e-6) for k in keys)
    return same_valid and worst <= tol, worst


def full_frames(rng, n):
    bev = rng.rand(n, 601, 601, 9).astype(np.float32)
    image = (rng.rand(n, 384, 1248, 3) * 255).astype(np.float32)
    return bev, image, np.stack([profiling.example_calib()] * n)


def mean_step(base, mesh, kw, batch, draws):
    """One mean-gradient step over the frames from a copy of the params
    base on the card: parallel/mesh.build_parallel_train_step on mesh
    (None: one process, no group). Returns (params on the CPU, their
    gradients, metrics, ms)."""
    params = copy.deepcopy(base)
    step, make_opt = PM.build_parallel_train_step(mesh, **kw)
    opt = make_opt(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(params, opt, batch, draws)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    out = {k: {"weight": m.weight.detach().cpu(), "bias": m.bias.detach().cpu()}
           for k, m in params.items()}
    grads = {k: {"weight": m.weight.grad.cpu(), "bias": m.bias.grad.cpu()}
             for k, m in params.items()}
    return out, grads, {k: v.item() for k, v in metrics.items()}, ms


def frame_grads(base, kw, batch, draws):
    """The mean-loss gradients over the frames of batch, frame by frame
    through train.build_forward_losses and torch.autograd.grad on the
    card: a reference apart from parallel/mesh.py. {layer: {"weight",
    "bias"}} on the CPU, zeros where a leaf gets no gradient."""
    forward_losses = build_forward_losses(**kw)
    names = [(k, s) for k in base for s in ("weight", "bias")]
    leaves = [getattr(base[k], s) for k, s in names]
    total = [torch.zeros_like(t) for t in leaves]
    n = len(draws)
    for i in range(n):
        f = forward_losses(base, {k: v[i] for k, v in batch.items()},
                           draws[i])
        for t, g in zip(total, torch.autograd.grad(
                f["loss"] / n, leaves, allow_unused=True)):
            if g is not None:
                t += g
    out = {k: {} for k in base}
    for (k, s), t in zip(names, total):
        out[k][s] = t.cpu()
    return out


def grad_diff(got, ref):
    """The worst leaf's max |got - ref| over its largest |ref| (a None
    gradient a zero one), and that leaf."""
    worst = (0.0, None)
    for k in ref:
        for s, r in ref[k].items():
            g = got[k][s]
            g = torch.zeros_like(r) if g is None else g
            err = max_err(g, r) / max(r.abs().max().item(), 1e-30)
            worst = max(worst, (err, k + "." + s), key=lambda e: e[0])
    return worst


def params_diff(a, b):
    return max(max_err(a[k][s], b[k][s]) for k in a for s in ("weight", "bias"))


def stem_band_rows(params, x, sfx):
    """The bf16 literal stem kernel on each two-rank band's input rows
    (PM.band_slice) against the kernel on the whole frame, on the rows
    that see no cut edge (two stem rows in from a cut): the number of
    rows compared and whether every one is equal bit for bit."""
    p = (*layer(params, "conv1_1" + sfx), *layer(params, "conv1_2" + sfx))
    h = x.shape[1]
    whole = vgg_stem_cuda(x, *p)
    rows, same = 0, True
    for band in PM.row_bands(PM.feature_rows(h), 2):
        start, stop = PM.band_slice(band, h)
        y = vgg_stem_cuda(x[:, start:stop].contiguous(), *p)
        lo = 2 if start > 0 else 0
        hi = y.shape[1] - (2 if stop < h else 0)
        off = start // 2
        same = same and torch.equal(y[:, lo:hi],
                                    whole[:, off + lo:off + hi])
        rows += hi - lo
    return rows, same


def phase_parallel(np_params, smi):
    """parallel/mesh.py at full width on two ranks sharing cuda:0 over gloo
    (NCCL refuses two ranks on one GPU), one spawn: first
    parallel/dryrun.dryrun_multidevice(2)'s own spec and checks, then this
    phase's parallel/dryrun.run_checks spec on the same ranks. The
    data-parallel train step (one full-width frame a rank, 3-6 gt cars,
    pre-NMS 12000, post-NMS 2000, 128 rois, Adam lr 1e-5) in f32 and bf16:
    its all-reduced gradients held to the mean-loss gradients taken frame
    by frame apart from parallel/mesh.py (GRAD_RTOL), its metrics within
    1e-5 of the total, its parameters after Adam within 2 lr of the
    one-process mean-gradient step's; the frame-parallel bf16 detector
    over B=4 frames held per frame to the one-process batched detector on
    the same two-frame halves (valid equal, within STEM_TOL of each max);
    the row-sharded detector on one frame in f32 and bf16, both stems' and
    the ROI kernels on band shapes, held to the single-frame detector: f32
    valid equal and within 1e-5 of each max; bf16 valid equal, the stem
    kernel's band rows bit for bit the whole frame's, the banded conv5_3
    maps within TRUNK_BF16_RTOL, the head on them bit for bit, and at least
    BF16_SET_MATCH of the boxes within 1 pixel of the single frame's. Then
    one rank with NCCL, held to the reference gradients and the
    one-process step as the two gloo ranks are. Returns the ranks' (both
    specs') launches and the NCCL run's."""
    rng = np.random.RandomState(SEED + 14)
    frames = [train_batch(rng)[0] for _ in range(2)]
    batch = {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
    gen = torch.Generator().manual_seed(SEED + 14)
    draws = [make_draws(gen, FEAT * FEAT * 4, TRAIN_POST_NMS + MAX_GT,
                        TRAIN_ROIS, FC_DIM, 0.5, "cpu") for _ in range(2)]
    train_kw = dict(pre_nms_top_n=TRAIN_PRE_NMS, post_nms_top_n=TRAIN_POST_NMS,
                    rois_per_image=TRAIN_ROIS)
    det_kw = dict(pre_nms_top_n=PRE_NMS, post_nms_top_n=POST_NMS)
    bev, image, calib = full_frames(rng, 4)
    dtypes = ((torch.float32, None), (torch.bfloat16, torch.bfloat16))
    spec = {"seed": SEED, "fc_dim": FC_DIM, "return_params": True,
            "train": [{"batch": {k: v.cpu() for k, v in batch.items()},
                       "draws": draws, "timed_steps": 2,
                       "kwargs": dict(train_kw, compute_dtype=dt)}
                      for _, dt in dtypes],
            "detect": {"bev": bev, "image": image, "calib": calib,
                       "timed_calls": 2,
                       "kwargs": dict(det_kw, compute_dtype=torch.bfloat16)},
            "spatial": [{"bev": bev[0], "image": image[0], "calib": calib[0],
                         "timed_calls": 2,
                         "kwargs": dict(det_kw, compute_dtype=dt)}
                        for _, dt in dtypes]}
    t0 = time.perf_counter()
    dry, ranks = PD.dryrun_multidevice(2, device="cuda", backend="gloo",
                                       extra=[spec])
    total, dry_launches = {}, {}
    for r in dry:
        for part in r["train"] + [r["detect"]] + r["spatial"]:
            add_launches(dry_launches, part["launches"])
    if not (dry_launches.get("roi_pool") and dry_launches.get("roi_pool_bwd")):
        raise AssertionError("the dry run launched %s" % dry_launches)
    add_launches(total, dry_launches)
    print("parallel: 2 ranks on cuda:0 over gloo, one spawn for the dry run "
          "(fc 2048, launches %s) and this phase: %.1f s; replicate (one "
          "broadcast of %d parameters) %.1f / %.1f ms"
          % (dry_launches, time.perf_counter() - t0,
             sum(v["weights"].size + v["biases"].size
                 for v in np_params.values()),
             ranks[0]["broadcast_ms"], ranks[1]["broadcast_ms"]))
    for r in ranks:
        for part in r["train"] + [r["detect"]] + r["spatial"]:
            add_launches(total, part["launches"])
    dev_draws = [PD._draws_to(d, "cuda") for d in draws]
    base = params_from_jax(np_params, device="cuda")
    for (name, dt), res in zip(dtypes, ranks[0]["train"]):
        kw = dict(train_kw, compute_dtype=dt)
        tol = GRAD_RTOL[name]
        grads_ref = frame_grads(base, kw, batch, dev_draws)
        grads_noise, _ = grad_diff(frame_grads(base, kw, batch, dev_draws),
                                   grads_ref)
        ref, _, ref_m, ref_ms = mean_step(base, None, kw, batch, dev_draws)
        loss = abs(ref_m["loss"])
        worst_m = max(abs(res["metrics"][k] - v) for k, v in ref_m.items())
        worst_g, leaf = grad_diff(res["grads"], grads_ref)
        # the check can fail: rank 0's frame alone in place of the sum
        half = frame_grads(base, kw, {k: v[:1] for k, v in batch.items()},
                           dev_draws[:1])
        dropped, _ = grad_diff({k: {s: v / 2 for s, v in d.items()}
                                for k, d in half.items()}, grads_ref)
        worst_p = params_diff(res["params"], ref)
        if (worst_m > 1e-5 * loss or not worst_g <= tol or dropped <= tol
                or worst_p > ADAM_NOISE):
            raise AssertionError(
                "parallel train %s: metrics off by %.3g (loss %.4f), "
                "gradients by %.3g at %s (tolerance %.3g; rank 0's frame "
                "alone %.3g), params by %.3g (bound 2 lr)"
                % (name, worst_m, loss, worst_g, leaf, tol, dropped, worst_p))
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            tempfile.mkdtemp(), "store"), rank=0, world_size=1)
        try:
            zero_all_launches()
            nccl, nccl_g, nccl_m, nccl_ms = mean_step(
                base, PM.make_mesh(device="cuda"), kw, batch, dev_draws)
            add_launches(total, {k: v for k, v in all_launches().items()
                                 if k in ("roi_pool", "roi_pool_bwd")})
        finally:
            dist.destroy_process_group()
        worst_n = params_diff(nccl, ref)
        worst_ng, _ = grad_diff(nccl_g, grads_ref)
        off_m = max(abs(nccl_m[k] - v) for k, v in ref_m.items())
        if (not worst_ng <= tol or worst_n > ADAM_NOISE
                or off_m > 1e-5 * loss):
            raise AssertionError(
                "parallel train %s, one NCCL rank: gradients off by %.3g "
                "(tolerance %.3g), params by %.3g, metrics %s vs %s"
                % (name, worst_ng, tol, worst_n, nccl_m, ref_m))
        print("parallel train step %s, 2 gloo ranks x 1 frame: %s ms "
              "(first, then warm), loss %.6f; all-reduced gradients within "
              "%.3g of each leaf's max (worst %s; tolerance %.3g) of the "
              "frame-by-frame reference, which differs from itself run "
              "twice by %.3g, and from rank 0's frame alone by %.3g; "
              "metrics within %.2g; after Adam, params within %.3g (bound "
              "2 lr) of the one-process mean step over the 2 frames (%.1f "
              "ms); 1 NCCL rank over both frames %.1f ms, gradients within "
              "%.3g, params within %.3g; on [%s]"
              % (name, ", ".join("%.1f" % t for t in res["ms"]),
                 res["metrics"]["loss"], worst_g, leaf, tol, grads_noise,
                 dropped, worst_m, worst_p, ref_ms, nccl_ms, worst_ng,
                 worst_n, smi))
    del ranks[0]["train"], ranks[1]["train"]

    params = base
    det = ranks[0]["detect"]
    batched = build_detect_batch_fn(compute_dtype=torch.bfloat16, **det_kw)
    worst = 0.0
    for half in (0, 2):
        ref = batched(params, *(torch.from_numpy(a[half:half + 2]).cuda()
                                for a in (bev, image, calib)))
        for i in range(2):
            ok, err = close_dets({k: v[half + i] for k, v in det["out"].items()},
                                 {k: v[i] for k, v in ref.items()}, STEM_TOL)
            worst = max(worst, err)
            if not ok:
                raise AssertionError("frame-parallel detect frame %d: valid "
                                     "differs or off by %.3g" % (half + i, err))
    single = {}
    for name, dt in dtypes:
        detect = build_detect_fn(compute_dtype=dt, **det_kw)
        args = [torch.from_numpy(a[0]).cuda() for a in (bev, image, calib)]
        timed(detect, params, *args)
        single[name] = [timed(detect, params, *args) for _ in range(2)]
    print("frame-parallel detect bf16 B=4 over 2 ranks: %s ms a call (first, "
          "then warm); each frame within %.3g of the one-process B=2 call on "
          "its half, valid equal; on [%s]"
          % (", ".join("%.1f" % t for t in det["ms"]), worst, smi))
    frame = [torch.from_numpy(a[:1]).cuda() for a in (bev, image, calib)]
    frame[1] = frame[1] - torch.from_numpy(PIXEL_MEANS).cuda()
    for (name, dt), sp in zip(dtypes, ranks[0]["spatial"]):
        ref = single[name][-1][0]
        n_got, n_ref = int(sp["out"]["valid"].sum()), int(ref["valid"].sum())
        ok, err = close_dets(sp["out"], ref, 1e-5)
        line = ("row-sharded detect %s, one frame over 2 ranks (bands of %s "
                "feature rows, halo %d input rows): %s ms vs the single-frame "
                "detector's %s ms; valid %d vs %d"
                % (name, [b - a for a, b in PM.row_bands(75, 2)],
                   PM.trunk_geometry()[1],
                   ", ".join("%.1f" % t for t in sp["ms"]),
                   ", ".join("%.1f" % t for _, t in single[name]), n_got,
                   n_ref))
        if dt is None:
            if n_got != n_ref or not ok:
                raise AssertionError("%s: off by %.3g of the max" % (line, err))
            print("%s, within %.3g of each max (%s); on [%s]" % (
                line, err, "bit-identical" if err == 0 else "not bit for bit",
                smi))
            continue
        # bf16: the trunks on band shapes round as cuDNN picks for those
        # shapes, and the random weights' near-flat RPN scores then reorder
        # the NMS (ROADMAP Queue 3). Held: the stem kernel's band rows to the
        # whole frame's bit for bit, the banded maps to the whole frame's
        # within bf16 rounding, the dict to the head on the banded maps bit
        # for bit, and the boxes to the single frame's as a set
        with torch.inference_mode():
            maps, worst, stem_rows, stem_same = [], 0.0, 0, True
            for x, sfx in ((frame[0], ""), (frame[1], "_2")):
                rows, same = stem_band_rows(params, x, sfx)
                stem_rows, stem_same = stem_rows + rows, stem_same and same
                banded = torch.cat([
                    PM.band_trunk(params, x, band, sfx, dt, "fused")
                    for band in PM.row_bands(PM.feature_rows(x.shape[1]), 2)],
                    1)
                whole = trunk_apply(params, x, sfx, dt, "fused")
                worst = max(worst, max_err(banded, whole)
                            / whole.float().abs().max().item())
                maps.append(banded)
            head = detect_from_features(params, *maps, frame[2],
                                        compute_dtype=dt, **det_kw)
        same = [k for k in sp["out"] if k != "rois_img"
                and not torch.equal(sp["out"][k], head[k][0].cpu())]
        near = set_match(sp["out"], ref)
        if (n_got != n_ref or same or not stem_same
                or worst > TRUNK_BF16_RTOL or near < BF16_SET_MATCH * n_got):
            raise AssertionError(
                "%s; the stem's band rows equal the whole frame's: %s; the "
                "head on the banded maps differs in %s; the banded maps off "
                "by %.3g of the max (tolerance %.3g); %d of %d boxes within "
                "1 pixel of the single frame's (at least %.2g)"
                % (line, stem_same, same, worst, TRUNK_BF16_RTOL, near,
                   n_got, BF16_SET_MATCH))
        print("%s; the stem kernel's band rows bit-identical to the whole "
              "frame's (%d rows); the dict bit-identical to the head on the "
              "banded trunks' maps, which are within %.3g of the whole "
              "frame's (bf16 rounding of cuDNN's band-shaped convs); %d of "
              "%d valid boxes within 1 pixel of one of the single-frame "
              "detector's; on [%s]"
              % (line, stem_rows, worst, near, n_got, smi))
    missing = [k for k in ("roi_pool", "roi_pool_bwd", "vgg_stem")
               if not total.get(k)]
    if missing:
        raise AssertionError("the parallel paths launched no %s: %s"
                             % (missing, total))
    print("parallel paths' launches (both ranks, the dry run's and the NCCL "
          "rank): %s" % total)
    return total


_SHARD_RUN = """
import json, sys
import chip_smoke as C
from mv3d_tf_tpu_torch.tools import test_net
root, weights, tmp, host = sys.argv[1:5]
C.zero_all_launches()
test_net.main(["--imdb", "kitti_val", "--kitti_path", root, "--weights",
               weights, "--dtype", "bfloat16", "--host_id", host,
               "--host_count", "2", "--set", "ROOT_DIR", tmp, "DATA_DIR",
               tmp + "/data"])
launches = C.all_launches()
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "mv3d_tf_tpu")]
assert not bad, "loaded: %s" % bad
print("launches " + json.dumps(launches))
"""


def phase_multihost(root, weights, smi):
    """Multi-host tools.test_net on the tree's 8 val frames in bf16: the
    plain run here, then --host_id 0 and 1 --host_count 2 in two processes
    at once (no jax), then --merge_shards here; the merged detections.pkl
    and detections_cnr.pkl must equal the plain run's byte for byte. Each
    shard's frame sits in its row of the plain run's batch of 8
    (solver._batch_slots: cuDNN's bf16 conv4_2 on the image view rounds by
    row). Returns the launches (the plain run's and the shards')."""
    total = {}
    here = os.path.dirname(os.path.abspath(__file__))
    names = ("detections.pkl", "detections_cnr.pkl")
    with tempfile.TemporaryDirectory() as tmp, saved_cfg(tmp):
        argv = ["--imdb", "kitti_val", "--kitti_path", root, "--weights",
                weights, "--dtype", "bfloat16"]
        out_dir = os.path.join(tmp, "output", cfg.EXP_DIR, "kitti_val", "he")
        zero_all_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            test_net.main(argv)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        add_launches(total, all_launches())
        plain = {}
        for n in names:
            with open(os.path.join(out_dir, n), "rb") as f:
                plain[n] = f.read()
            os.remove(os.path.join(out_dir, n))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", _SHARD_RUN, root, weights, tmp, str(h)],
            cwd=tmp, env=dict(os.environ, PYTHONPATH=here),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for h in range(2)]
        shard_launches = []
        for h, p in enumerate(procs):
            out, err = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError("test_net --host_id %d failed:\n%s"
                                     % (h, err[-4000:]))
            shard_launches.append(json.loads(
                out.splitlines()[-1][len("launches "):]))
            add_launches(total, shard_launches[-1])
        shards_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            test_net.main(argv + ["--host_count", "2", "--merge_shards"])
        merge_s = time.perf_counter() - t0
        differ = []
        for n in names:
            with open(os.path.join(out_dir, n), "rb") as f:
                if f.read() != plain[n]:
                    differ.append(n)
        if differ:
            with open(os.path.join(out_dir, names[0]), "rb") as f:
                merged = pickle.loads(f.read())
            single = pickle.loads(plain[names[0]])
            frames = [i for i in range(len(single[1]))
                      if not np.array_equal(single[1][i], merged[1][i])]
            raise AssertionError("merged %s differ from the plain run's "
                                 "(frames %s)" % (differ, frames))
        want = dict.fromkeys(shard_launches[0], 0)
        want.update(roi_pool=2, vgg_stem=2)
        if any(s != want for s in shard_launches):
            raise AssertionError("shard launches %s != %s each"
                                 % (shard_launches, want))
        print("multi-host tools.test_net bf16 over 8 val frames: plain run "
              "%.2f s; 2 shard processes at once %.2f s (launches %s each); "
              "merge %.2f s; detections.pkl and detections_cnr.pkl equal to "
              "the plain run's byte for byte; on [%s]"
              % (plain_s, shards_s, {k: v for k, v in want.items() if v},
                 merge_s, smi))
    return total


def phase_selfcheck(smi):
    """tools.gpu_selfcheck in a process of its own: every check [ok], exit
    0. Its launches compare kernels with plain versions and are not
    counted."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mv3d_tf_tpu_torch.tools.gpu_selfcheck"],
        cwd=here, env=dict(os.environ, PYTHONPATH=here), capture_output=True,
        text=True, timeout=600)
    for line in proc.stdout.splitlines():
        print("gpu_selfcheck: " + line)
    if proc.returncode != 0:
        raise AssertionError("gpu_selfcheck exited %d:\n%s"
                             % (proc.returncode, proc.stderr[-4000:]))
    print("gpu_selfcheck: exit 0 in %.1f s on [%s]"
          % (time.perf_counter() - t0, smi))


def tool_json(fn, argv):
    """fn(argv) with its stdout captured; its last line parsed as JSON."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return json.loads(buf.getvalue().splitlines()[-1])


def phase_new_tools(root, weights, smi):
    """The last MV3D tools, one short run each with its launches zeroed
    just before and read just after, each required to launch its hand
    kernels: bench_ab (bf16 B=8 detect, 3 iterations; --train, 2),
    microbench_int8 (3 iterations), prenms_knee (the tree's 8 val frames,
    K 6000 and 1024), profile_detect and profile_loo (B=8, 2 iterations,
    three variants). Returns the summed launches."""
    total = {}
    runs = (
        ("bench_ab detect", bench_ab.main, ["--batch", "8", "--iters", "3"],
         ("roi_pool", "vgg_stem")),
        ("bench_ab --train", bench_ab.main, ["--train", "--iters", "2"],
         ("roi_pool", "roi_pool_bwd")),
        ("microbench_int8", microbench_int8.main, ["--iters", "3"],
         ("conv_s8", "matmul_s8")),
        ("prenms_knee", prenms_knee.main,
         ["--kitti_path", root, "--model", weights, "--frames", "8",
          "--ks", "6000", "1024"], ("roi_pool", "vgg_stem")),
        ("profile_detect", profile_detect.main,
         ["--batch", "8", "--iters", "2"], ("roi_pool", "conv_s8",
                                            "vgg_stem")),
        ("profile_loo", profile_loo.main,
         ["--batch", "8", "--iters", "2", "--variants",
          "base,no roi pool,no proposal"], ("roi_pool", "vgg_stem")),
    )
    for name, fn, argv, need in runs:
        zero_all_launches()
        t0 = time.perf_counter()
        res = tool_json(fn, argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = all_launches()
        missing = [k for k in need if not launches[k]]
        if missing:
            raise AssertionError("%s launched no %s: %s"
                                 % (name, missing, launches))
        add_launches(total, launches)
        print("%s (%.1f s, launches %s) on [%s]: %s"
              % (name, secs, {k: v for k, v in launches.items() if v}, smi,
                 json.dumps(res)))
    return total


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this run needs an NVIDIA GPU")
    smi = phase_environment()
    gen = torch.Generator().manual_seed(SEED)
    roi = phase_roi_pool(gen)
    np_params = he_normal_params(SEED)
    params = params_from_jax(np_params, device="cuda")
    stem = phase_stem(params, smi)
    t0 = time.perf_counter()
    s2d = phase_stem_s2d_fused(params, smi)
    new_phases_s = time.perf_counter() - t0
    launches = phase_detector(params, smi)
    del params
    bwd = phase_roi_bwd(gen)
    train_launches = phase_train(np_params, smi)
    bev_stats = phase_bev_kernel(smi)
    with tempfile.TemporaryDirectory() as root:
        cli_launches = phase_read_lidar(root, smi)
        params = params_from_jax(np_params, device="cuda")
        scan_launches = phase_scan_detector(params, root, smi)
        del params
    conv_stats, conv2x2_stats = phase_conv_s8(smi)
    matmul_stats = phase_matmul_s8(smi)
    int8, state = phase_int8_detector(np_params, smi)
    t0 = time.perf_counter()
    fused = phase_s2d_fused_detectors(np_params, state, smi)
    del state
    clis = phase_eval_clis(np_params, smi)
    new_phases_s += time.perf_counter() - t0
    print("the fused s2d stem's phases (kernel check, detectors, CLIs): "
          "%.1f s" % new_phases_s)
    t0 = time.perf_counter()
    phase_nms_blocked(np_params, smi)
    with tempfile.TemporaryDirectory() as tmp:
        root = synthetic.generate(os.path.join(tmp, "kitti"),
                                  num_frames=TRAIN_FRAMES * 2,
                                  cars_per_frame=3, seed=SEED)
        weights = os.path.join(tmp, "he.npy")
        np.save(weights, np_params)
        trained = phase_train_net(np_params, root, weights, smi)
        demo = phase_demo(root, weights, smi)
        print("the blocked NMS, train_net and demo phases: %.1f s"
              % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        accuracy = phase_accuracy_eval(root, smi)
        tools = phase_tools(np_params, root, weights, smi)
        print("the accuracy_eval and tools phases: %.1f s"
              % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        multihost = phase_multihost(root, weights, smi)
        new_tools = phase_new_tools(root, weights, smi)
        multi_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_roi_2d(gen, smi)
    np2d = he_normal_params_2d(SEED)
    detect_2d = phase_detect_2d(np2d, smi)
    train_2d = phase_train_2d(np2d, smi)
    del np2d
    clis_2d = phase_clis_2d(smi)
    print("the legacy 2D phases: %.1f s" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    phase_roi_bwd_batched(gen, smi)
    t1 = time.perf_counter()
    np2d = he_normal_params_2d(SEED)
    fast_rcnn, _ = phase_fast_rcnn(np2d, smi)
    t2 = time.perf_counter()
    alt_opt = phase_alt_opt(np2d, smi)
    del np2d
    t3 = time.perf_counter()
    print("the Fast R-CNN phases: %.1f s (the batched gradient %.1f, the "
          "steps %.1f, the alternating-optimisation flow %.1f)"
          % (t3 - t0, t1 - t0, t2 - t1, t3 - t2))
    t0 = time.perf_counter()
    parallel = phase_parallel(np_params, smi)
    phase_selfcheck(smi)
    print("the multi-device and last tools' phases: %.1f s (multi-host "
          "test_net and the tools %.1f, the parallel paths with the dry run, "
          "and gpu_selfcheck %.1f)" % (multi_s + time.perf_counter() - t0,
                                       multi_s, time.perf_counter() - t0))
    new_paths = {}
    for counts in (fused, clis, trained, demo, accuracy, tools, detect_2d,
                   train_2d, clis_2d, fast_rcnn, alt_opt, multihost,
                   new_tools, parallel):
        add_launches(new_paths, counts)
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "mv3d_tf_tpu")]
    if loaded:
        raise AssertionError("modules of jax or the JAX package were "
                             "imported: %s" % loaded)
    # launches on the main paths: the detector's run, the train run, the
    # read_lidar run, the scan-to-detections run, the int8 detector's run,
    # the s2d_fused detectors' run, the evaluation CLIs' runs, the
    # train_net runs, the demo's runs, the accuracy_eval and tools runs,
    # the 2D detector's, train step's and CLIs' runs, the Fast R-CNN
    # steps' and the alternating-optimisation flow's runs, and the
    # multi-host test_net's, the last tools', the parallel paths' (their
    # ranks' counts) and the dry run's
    print(json.dumps({"kernels": [
        {"name": "roi_pool", "route": "cuda", "source": ROI_SOURCE,
         "replaces": "mv3d_tf_tpu/ops/roi_pool_pallas.py:71",
         "launches": launches["roi_pool"] + train_launches["roi_pool"]
         + scan_launches["roi_pool"] + int8["roi_pool"]
         + new_paths["roi_pool"], **roi},
        {"name": "vgg_stem", "route": "cuda", "source": S2D_SOURCE,
         "replaces": "mv3d_tf_tpu/ops/vgg_stem_pallas.py:106",
         "launches": launches["vgg_stem"] + scan_launches["vgg_stem"]
         + new_paths["vgg_stem"], **stem},
        {"name": "roi_pool_bwd", "route": "cuda", "source": BWD_SOURCE,
         "replaces": "mv3d_tf_tpu/ops/roi_pool_pallas.py:333",
         "launches": train_launches["roi_pool_bwd"]
         + new_paths["roi_pool_bwd"], **bwd},
        {"name": "bev_place", "route": "cuda", "source": BEV_SOURCE,
         "replaces": "mv3d_tf_tpu/ops/bev_pallas.py:58",
         "launches": cli_launches + scan_launches["bev_place"]
         + new_paths["bev_place"], **bev_stats},
        {"name": "conv_s8", "route": "cuda", "source": CONV_S8_SOURCE,
         "replaces": "mv3d_tf_tpu/ops/conv_s8_pallas.py:46,155",
         "launches": int8["conv_s8"] + new_paths["conv_s8"], **conv_stats},
        {"name": "conv2x2_s8", "route": "cuda", "source": CONV_S8_SOURCE,
         "replaces": "mv3d_tf_tpu/ops/conv_s8_pallas.py:260",
         "launches": int8["conv2x2_s8"] + new_paths["conv2x2_s8"],
         **conv2x2_stats},
        {"name": "matmul_s8", "route": "cuda", "source": MATMUL_S8_SOURCE,
         "replaces": "mv3d_tf_tpu/ops/conv_s8_pallas.py:376",
         "launches": int8["matmul_s8"] + new_paths["matmul_s8"],
         **matmul_stats},
        {"name": "stem_s2d_fused", "route": "cuda", "source": S2D_SOURCE,
         "replaces": "mv3d_tf_tpu/ops/stem_s2d_pallas.py:124",
         "launches": new_paths["stem_s2d_fused"], **s2d},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
