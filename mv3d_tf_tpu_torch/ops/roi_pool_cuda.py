"""Wrappers of the CUDA ROI-pool kernels, the Hopper replacements of
mv3d_tf_tpu/ops/roi_pool_pallas.py: the forward (csrc/roi_pool.cu,
roi_pool_pallas) and its gradient (csrc/roi_pool_bwd.cu,
roi_pool_pallas_bwd).

The plain PyTorch versions are ops/roi_pool.py:roi_pool and roi_pool_bwd;
kernels and plain versions take their bin bounds from
ops/roi_pool.py:bin_bounds.
"""

import torch

from mv3d_tf_tpu_torch import kernels
from mv3d_tf_tpu_torch.ops.roi_pool import _as_batch, bin_bounds

_ENTRY = {torch.float32: "mv3d_roi_pool_f32",
          torch.bfloat16: "mv3d_roi_pool_bf16"}


def roi_pool_cuda(feat, rois, pooled=7, spatial_scale=1.0 / 8):
    """ROI max-pool on the card. feat (H,W,C) or (B,H,W,C) float32/bfloat16,
    contiguous NHWC; rois (R,5) float32 on the same device, column 0 the
    frame. Returns (R, pooled, pooled, C) in feat's dtype."""
    if not (feat.is_cuda and rois.device == feat.device):
        raise ValueError("roi_pool_cuda: feat and rois must be on one CUDA "
                         "device, got %s and %s" % (feat.device, rois.device))
    if feat.dtype not in _ENTRY:
        raise TypeError("roi_pool_cuda: unsupported dtype %s" % feat.dtype)
    if rois.dtype != torch.float32 or rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError("roi_pool_cuda: rois must be (R,5) float32")
    if feat.dim() not in (3, 4):
        raise ValueError("roi_pool_cuda: feat must be (H,W,C) or (B,H,W,C)")
    if not (feat.is_contiguous() and rois.is_contiguous()):
        raise ValueError("roi_pool_cuda: inputs must be contiguous")
    f, frame = _as_batch(feat, rois)
    _, H, W, C = f.shape
    R = rois.shape[0]
    bounds = bin_bounds(rois, pooled, spatial_scale, H, W).contiguous()
    out = torch.empty((R, pooled, pooled, C), dtype=feat.dtype,
                      device=feat.device)
    if R == 0 or C == 0:
        return out
    lib = kernels.library()
    with torch.cuda.device(feat.device):
        roi_pool_cuda.launches += 1
        err = getattr(lib, _ENTRY[feat.dtype])(
            f.data_ptr(), bounds.data_ptr(), frame.data_ptr(), out.data_ptr(),
            H, W, C, R, pooled, torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "roi_pool_cuda")
    return out


roi_pool_cuda.launches = 0

_BWD_ENTRY = {torch.float32: "mv3d_roi_pool_bwd_f32",
              torch.bfloat16: "mv3d_roi_pool_bwd_bf16"}


def roi_pool_bwd_cuda(feat, rois, out, dy, pooled=7, spatial_scale=1.0 / 8):
    """Gradient of the ROI max-pool on the card (csrc/roi_pool_bwd.cu), the
    Hopper replacement of roi_pool_pallas.py:roi_pool_pallas_bwd.

    feat (H,W,C) float32/bfloat16, rois (R,5) float32, out (R,P,P,C) the
    forward's output in feat's dtype, dy (R,P,P,C) float32, all contiguous
    on one CUDA device. Returns dfeat (H,W,C) float32. The plain version is
    ops/roi_pool.py:roi_pool_bwd."""
    tensors = (feat, rois, out, dy)
    if not all(t.is_cuda and t.device == feat.device for t in tensors):
        raise ValueError("roi_pool_bwd_cuda: inputs must be on one CUDA "
                         "device")
    if feat.dtype not in _BWD_ENTRY or out.dtype != feat.dtype:
        raise TypeError("roi_pool_bwd_cuda: feat and out must share a dtype "
                        "in %s, got %s and %s" % (list(_BWD_ENTRY),
                                                  feat.dtype, out.dtype))
    if rois.dtype != torch.float32 or dy.dtype != torch.float32:
        raise TypeError("roi_pool_bwd_cuda: rois and dy must be float32")
    if feat.dim() != 3 or rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError("roi_pool_bwd_cuda: feat must be (H,W,C) and rois "
                         "(R,5)")
    H, W, C = feat.shape
    R = rois.shape[0]
    shape = (R, pooled, pooled, C)
    if tuple(out.shape) != shape or tuple(dy.shape) != shape:
        raise ValueError("roi_pool_bwd_cuda: out and dy must be %s, got %s "
                         "and %s" % (shape, tuple(out.shape),
                                     tuple(dy.shape)))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("roi_pool_bwd_cuda: inputs must be contiguous")
    bounds = bin_bounds(rois, pooled, spatial_scale, H, W).contiguous()
    dfeat = torch.zeros((H, W, C), dtype=torch.float32, device=feat.device)
    if R == 0 or C == 0:
        return dfeat
    lib = kernels.library()
    with torch.cuda.device(feat.device):
        roi_pool_bwd_cuda.launches += 1
        err = getattr(lib, _BWD_ENTRY[feat.dtype])(
            feat.data_ptr(), bounds.data_ptr(), out.data_ptr(), dy.data_ptr(),
            dfeat.data_ptr(), W, C, R, pooled,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "roi_pool_bwd_cuda")
    return dfeat


roi_pool_bwd_cuda.launches = 0
