"""Wrapper of the multi-level RoIAlign kernel (csrc/roi_align.cu), the
card's route of ops/roi_align.py:roi_align_fast. No TPU kernel stands
behind it: the JAX package pools by max only. Its plain version is
ops/roi_align.py:roi_align.

The kernel picks each roi's level and computes its bins from the (R, 5)
rois itself, so a call allocates the pooled maps and the levels and makes
one launch, whatever the number of rois and levels.
"""

import ctypes

import torch

from mv3d_tf_tpu_torch import kernels

_ENTRY = {torch.float32: "mv3d_roi_align_f32",
          torch.bfloat16: "mv3d_roi_align_bf16"}
MAX_LEVELS = 4


def roi_align_cuda(maps, rois, pooled, k_min=2):
    """RoIAlign on the card. maps: 1 to 4 NHWC maps (H_l, W_l, C) or (B,
    H_l, W_l, C), level k_min + l at stride 2^(k_min + l), one dtype
    (float32 or bfloat16), C a multiple of 4, contiguous; rois (R, 5)
    float32 [frame, x1, y1, x2, y2] on the same device. Returns ((R, pooled,
    pooled, C) in the maps' dtype, levels (R,) int32)."""
    dev = rois.device
    if not (rois.is_cuda and all(m.is_cuda and m.device == dev
                                 for m in maps)):
        raise ValueError("roi_align_cuda: maps and rois must be on one CUDA "
                         "device")
    if not 1 <= len(maps) <= MAX_LEVELS:
        raise ValueError("roi_align_cuda: 1 to %d levels, got %d"
                         % (MAX_LEVELS, len(maps)))
    dtype = maps[0].dtype
    if dtype not in _ENTRY or any(m.dtype != dtype for m in maps):
        raise TypeError("roi_align_cuda: the maps must share a dtype in %s"
                        % list(_ENTRY))
    if rois.dtype != torch.float32 or rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError("roi_align_cuda: rois must be (R,5) float32")
    if any(m.dim() not in (3, 4) for m in maps):
        raise ValueError("roi_align_cuda: maps must be (H,W,C) or (B,H,W,C)")
    C = maps[0].shape[-1]
    if C % 4 or any(m.shape[-1] != C for m in maps):
        raise ValueError("roi_align_cuda: the maps' channels must agree and "
                         "be a multiple of 4")
    if not (rois.is_contiguous() and all(m.is_contiguous() for m in maps)):
        raise ValueError("roi_align_cuda: inputs must be contiguous")
    R = rois.shape[0]
    out = torch.empty((R, pooled, pooled, C), dtype=dtype, device=dev)
    levels = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return out, levels
    hw = (ctypes.c_int * (2 * MAX_LEVELS))(
        *[int(v) for m in maps for v in m.shape[-3:-1]],
        *([0] * (2 * (MAX_LEVELS - len(maps)))))
    ptrs = [m.data_ptr() for m in maps] + [None] * (MAX_LEVELS - len(maps))
    hw = ctypes.cast(hw, ctypes.c_void_p)
    lib = kernels.library()
    with torch.cuda.device(dev):
        roi_align_cuda.launches += 1
        err = getattr(lib, _ENTRY[dtype])(
            *ptrs, hw, len(maps), k_min, C, rois.data_ptr(), R, pooled,
            out.data_ptr(), levels.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "roi_align_cuda")
    return out, levels


roi_align_cuda.launches = 0   # kernel launches: one a call
