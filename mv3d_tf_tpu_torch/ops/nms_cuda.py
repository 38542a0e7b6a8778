"""Greedy NMS on the card: the wrapper of csrc/nms.cu, which stands for
the JAX package's fori_loop greedy NMS (mv3d_tf_tpu/ops/nms.py:224-260)
and replaces no Pallas kernel. ops/nms.py:nms dispatches to it for CUDA
tensors; ops/nms.py:nms_plain, the loop, is its plain version.

Two launches a call, whatever the number of frames, and no host sync: the
(B, N, ceil(N/64)) uint64 suppression mask of the boxes in score order
(bit j of row i: j >= i and IoU(i, j) >= the threshold), then one block a
frame walks the candidates in that order and writes the first max_out
keeps into their slots. Boxes that are not in score order are sorted once
(stable, descending, as the loop's first-argmax takes them) and the kept
indices mapped back through the order inside the scan.
"""

import math

import torch

from mv3d_tf_tpu_torch import kernels

WORD = 64              # candidates a mask word covers
# the scan keeps a frame's words in 48 KB of shared memory (csrc/nms.cu)
MAX_CANDIDATES = 48 * 1024 // 8 * WORD


def nms_greedy_cuda(boxes, scores, valid, max_out, iou_threshold=0.7,
                    presorted=False):
    """ops/nms.py:nms_plain's keep set on the card. boxes (..., N, 4)
    float32, scores (..., N) float32 and valid (..., N) bool, contiguous, on
    one CUDA device; leading dims are independent frames. presorted=True
    promises the live candidates (valid, finite score above ops/nms.py's
    NEG_INF) in descending score order, ties by index, and skips the sort.
    Returns keep_idx (..., max_out) int64, 0 in unused slots, and
    keep_valid (..., max_out) bool. The threshold must be positive."""
    if not iou_threshold > 0:
        raise ValueError("nms_greedy_cuda: the IoU threshold must be "
                         "positive, got %r" % (iou_threshold,))
    if not all(t.is_cuda and t.device == boxes.device
               for t in (boxes, scores, valid)):
        raise ValueError("nms_greedy_cuda: inputs must be on one CUDA "
                         "device")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32 \
            or valid.dtype != torch.bool:
        raise TypeError("nms_greedy_cuda: boxes and scores must be float32 "
                        "and valid bool, got %s, %s, %s"
                        % (boxes.dtype, scores.dtype, valid.dtype))
    lead = scores.shape[:-1]
    if boxes.dim() < 2 or boxes.shape[-1] != 4 \
            or boxes.shape[:-1] != scores.shape or valid.shape != scores.shape:
        raise ValueError("nms_greedy_cuda: boxes (..., N, 4), scores and "
                         "valid (..., N), got %s, %s, %s"
                         % (tuple(boxes.shape), tuple(scores.shape),
                            tuple(valid.shape)))
    if not all(t.is_contiguous() for t in (boxes, scores, valid)):
        raise ValueError("nms_greedy_cuda: inputs must be contiguous")
    n, B = scores.shape[-1], math.prod(lead)
    if n > MAX_CANDIDATES or B > 65535 or max_out < 0:
        raise ValueError("nms_greedy_cuda: %d frames of %d candidates and "
                         "max_out %d; the kernel takes up to 65535 frames of "
                         "%d" % (B, n, max_out, MAX_CANDIDATES))
    dev = boxes.device
    keep_idx = torch.empty(*lead, max_out, dtype=torch.int64, device=dev)
    keep_valid = torch.empty(*lead, max_out, dtype=torch.bool, device=dev)
    if keep_idx.numel() == 0:
        return keep_idx, keep_valid
    order = None
    if not presorted:
        masked = torch.where(valid & torch.isfinite(scores), scores,
                             float("-inf"))
        scores, order = torch.sort(masked, dim=-1, descending=True,
                                   stable=True)
        boxes = boxes.gather(-2, order[..., None].expand(boxes.shape))
        valid = None      # the sorted scores are -inf where not valid
    words = -(-n // WORD)
    mask = torch.empty(B * n * words, dtype=torch.int64, device=dev)
    lib = kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if n:
            nms_greedy_cuda.launches += 1
            err = lib.mv3d_nms_mask_f32(boxes.data_ptr(), mask.data_ptr(), B,
                                        n, float(iou_threshold), stream)
            kernels.check(err, "nms_greedy_cuda (mask)")
        nms_greedy_cuda.launches += 1
        err = lib.mv3d_nms_scan(
            mask.data_ptr(), scores.data_ptr(),
            None if valid is None else valid.data_ptr(),
            None if order is None else order.data_ptr(), keep_idx.data_ptr(),
            keep_valid.data_ptr(), B, n, max_out, stream)
        kernels.check(err, "nms_greedy_cuda (scan)")
    return keep_idx, keep_valid


nms_greedy_cuda.launches = 0   # kernel launches: two a call
