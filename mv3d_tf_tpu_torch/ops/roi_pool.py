"""ROI max-pooling: the plain PyTorch version and the dispatch to the CUDA
kernel (mv3d_tf_tpu/ops/roi_pool.py).

Forward semantics of the reference's ROIPoolForward, as the JAX package
defines them:
  * roi corners scaled by spatial_scale, then C round() (half away from
    zero); malformed rois are forced to 1x1;
  * bin [start, end) bounds in exact integer arithmetic, clipped to the
    feature extent (``bin_bounds``; the kernels carry the same formula in
    csrc/roi_bin.cuh, held to this one on the card by chip_smoke.py);
  * empty bins give 0.
A batched feature map (B,H,W,C) is indexed by each roi's frame column.
``boundary_rois`` gives rois on every rounding and clipping case of the
formula: the CPU tests hold ``bin_bounds`` and the plain pool to the JAX
package on them, chip_smoke.py the kernels to the plain versions.

The train path's pool (``roi_pool_train``) takes a single or batched map
(the Fast R-CNN step pools an image pyramid), and its gradient is the TPU
kernel's even-split equality replay (``roi_pool_bwd``). ``roi_pool_np`` is
the numpy transliteration of the reference's CUDA loops, one roi and bin at
a time: the host oracle of the same bounds.
"""

import numpy as np
import torch

_NEG = float("-inf")
_CHUNK = 128   # rois per block of the plain version: bounds its memory


def _c_round(x):
    """C round(): half away from zero. ``torch.round`` rounds half to even."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def bin_bounds(rois, pooled, spatial_scale, H, W):
    """Integer-exact bin bounds (ops/roi_pool.py:79-100).

    rois (R,5) float32 [frame, x1, y1, x2, y2] in input pixels. Returns
    (R, 4, pooled) int32 rows hstart, hend, wstart, wend, clipped to
    [0,H] / [0,W]: floor(p*n/P) == (p*n)//P, ceil((p+1)*n/P) ==
    ((p+1)*n+P-1)//P.
    """
    xs, ys, xe, ye = _c_round(rois[:, 1:5] * spatial_scale).to(
        torch.int32).unbind(1)
    roi_w = (xe - xs + 1).clamp(min=1)[:, None]
    roi_h = (ye - ys + 1).clamp(min=1)[:, None]
    p = torch.arange(pooled, dtype=torch.int32, device=rois.device)
    return torch.stack([
        ((p * roi_h) // pooled + ys[:, None]).clamp(0, H),
        (((p + 1) * roi_h + pooled - 1) // pooled + ys[:, None]).clamp(0, H),
        ((p * roi_w) // pooled + xs[:, None]).clamp(0, W),
        (((p + 1) * roi_w + pooled - 1) // pooled + xs[:, None]).clamp(0, W),
    ], dim=1)


def boundary_rois(in_h, in_w, frames=1):
    """(R,5) float32 rois, on the CPU, for a map of in_h x in_w input pixels
    at the 1/8 scale: corners on exact +-k.5 cells (round half away from
    zero) and just off them, whole-map and beyond-map rois, rois wholly
    outside the map, malformed rois (x2 < x1, y2 < y1) and 1-cell rois.
    With frames > 1 the frame columns cycle through 0.9, 1.0, 2.7 and
    `frames` (one past the last frame), which truncate and clamp."""
    w, h = float(in_w), float(in_h)
    rows = [[8 * k + 4, 8 * k - 4, 8 * k + 108, 8 * k + 156]
            for k in (-3, -1, 0, 2, 5)]                  # corners at k.5
    rows += [[8 * k + 3.99, 8 * k - 4.01, 8 * k + 107.9, 8 * k + 156.1]
             for k in (-1, 2)]                           # just off k.5
    rows += [[0, 0, w - 1, h - 1], [0, 0, w, h], [4, 4, w - 4, h - 4],
             [-40, -40, w + 40, h + 40], [-1000, -1000, w + 1000, h + 1000],
             [w - 20, h - 20, w + 60, h + 60],           # beyond the map
             [w + 100, h + 100, w + 300, h + 300], [-300, -300, -100, -100],
             [w / 2, h / 4, w / 4, h / 2], [w / 4, h / 2, w / 2, h / 4],
             [20, 20, 20, 20], [20, 20, 23, 23], [-4, -4, -4, -4],
             [w - 1, h - 1, w - 1, h - 1]]               # 1 cell or none
    rois = torch.tensor(rows, dtype=torch.float32)
    cycle = torch.tensor([0.9, 1.0, 2.7, frames])
    frame = (cycle[torch.arange(len(rows)) % 4] if frames > 1
             else torch.zeros(len(rows)))
    return torch.cat([frame[:, None], rois], 1)


def _as_batch(feat, rois):
    """(feat (B,H,W,C), frame (R,) int32) for a single or batched map; a
    roi's frame is its column 0, truncated and clamped to the batch."""
    if feat.dim() == 3:
        return feat[None], torch.zeros(rois.shape[0], dtype=torch.int32,
                                       device=rois.device)
    return feat, rois[:, 0].to(torch.int32).clamp(0, feat.shape[0] - 1)


def roi_pool(feat, rois, pooled=7, spatial_scale=1.0 / 8):
    """Plain PyTorch ROI max-pool, the reference for the CUDA kernel.

    feat (H,W,C) or (B,H,W,C) float or int8; rois (R,5) float32. Returns
    (R, pooled, pooled, C) in feat's dtype. A separable masked max: rows of
    each bin first, then columns, over _CHUNK rois at a time to bound the
    (_CHUNK, pooled, W, C) intermediate.
    """
    f, frame = _as_batch(feat, rois)
    B, H, W, C = f.shape
    bounds = bin_bounds(rois, pooled, spatial_scale, H, W).long()
    frame = frame.long()
    outs = [_pool_block(f, bounds[i:i + _CHUNK], frame[i:i + _CHUNK], pooled)
            for i in range(0, rois.shape[0], _CHUNK)]
    if not outs:
        return f.new_zeros((0, pooled, pooled, C))
    return torch.cat(outs)


def _pool_block(f, bounds, frame, P):
    B, H, W, C = f.shape
    r = bounds.shape[0]
    hs, he, ws, we = bounds.unbind(1)                   # (r, P) each
    # the max's start: -inf, or an integer type's least value
    low = _NEG if f.is_floating_point() else torch.iinfo(f.dtype).min
    m1 = f.new_full((r, P, W, C), low)
    hlen = he - hs
    for k in range(int(hlen.max().clamp(min=0))):
        rows = f[frame[:, None], (hs + k).clamp(max=H - 1)]      # (r,P,W,C)
        ok = (k < hlen)[:, :, None, None]
        m1 = torch.where(ok, torch.maximum(m1, rows), m1)
    out = f.new_full((r, P, P, C), low)
    wlen = we - ws
    for k in range(int(wlen.max().clamp(min=0))):
        idx = (ws + k).clamp(max=W - 1)[:, None, :, None].expand(r, P, P, C)
        cols = torch.gather(m1, 2, idx)                 # (r, ph, pw, C)
        ok = (k < wlen)[:, None, :, None]
        out = torch.where(ok, torch.maximum(out, cols), out)
    empty = (he <= hs)[:, :, None] | (we <= ws)[:, None, :]
    return out.masked_fill(empty[..., None], 0)


def roi_pool_fast(feat, rois, pooled=7, spatial_scale=1.0 / 8):
    """Inference dispatch: a CUDA tensor goes to the hand-written kernel,
    a CPU tensor to the plain version; any other device raises."""
    if feat.is_cuda:
        from mv3d_tf_tpu_torch.ops.roi_pool_cuda import roi_pool_cuda
        return roi_pool_cuda(feat.contiguous(), rois.contiguous(), pooled,
                             spatial_scale)
    if feat.device.type == "cpu":
        return roi_pool(feat, rois, pooled, spatial_scale)
    raise ValueError("roi_pool_fast: no ROI pool for device "
                     + str(feat.device))


def bin_cells(feat, bounds, frame=None):
    """Every cell of every bin of a block of rois, one (kh, kw) offset into
    the bins at a time. feat (H,W,C), or (B,H,W,C) with frame (r,) the
    rois' frames (from _as_batch); bounds (r, 4, P) from bin_bounds.
    Yields (cell (r,P,P) flat index into the (B*H*W) cells, values
    (r,P,P,C), inside (r,P,P): whether the offset lies inside that bin),
    offsets in row-major order."""
    if bounds.shape[0] == 0:
        return
    f = feat if feat.dim() == 4 else feat[None]
    B, H, W, C = f.shape
    hs, he, ws, we = bounds.long().unbind(1)              # (r, P) each
    hlen, wlen = he - hs, we - ws
    flat = f.reshape(B * H * W, C)
    base = 0 if frame is None else frame.long()[:, None, None] * (H * W)
    for kh in range(int(hlen.max().clamp(min=0))):
        rows = base + (hs + kh).clamp(max=H - 1)[:, :, None] * W
        for kw in range(int(wlen.max().clamp(min=0))):
            cell = rows + (ws + kw).clamp(max=W - 1)[:, None, :]
            inside = (kh < hlen)[:, :, None] & (kw < wlen)[:, None, :]
            yield cell, flat[cell], inside


def roi_pool_bwd(feat, rois, out, dy, pooled=7, spatial_scale=1.0 / 8):
    """Gradient of the ROI max-pool w.r.t. a single or batched map, the
    plain version of kernel csrc/roi_pool_bwd.cu (roi_pool_pallas.py:
    333-467, which takes one frame).

    Equality replay with an even split: the cells of bin (r,ph,pw) whose
    value equals out[r,ph,pw,c] (compared in float32) share
    dy[r,ph,pw,c] * (1 / count) each; overlapping bins and rois add; empty
    bins, and a NaN max (equal to no cell), give nothing. feat (H,W,C) or
    (B,H,W,C) float32/bfloat16, a roi's frame its column 0 truncated and
    clamped to [0, B-1] as in the forward (_as_batch); rois (R,5), out
    (R,P,P,C) the forward's output, dy (R,P,P,C). Returns dfeat in feat's
    shape, float32. Rois go in blocks of _CHUNK.
    """
    f, frame = _as_batch(feat, rois)
    B, H, W, C = f.shape
    bounds = bin_bounds(rois, pooled, spatial_scale, H, W)
    dfeat = torch.zeros((B * H * W, C), dtype=torch.float32,
                        device=feat.device)
    for i in range(0, rois.shape[0], _CHUNK):
        b, fr = bounds[i:i + _CHUNK], frame[i:i + _CHUNK]
        o = out[i:i + _CHUNK].float()
        cnt = torch.zeros_like(o)
        for _, cells, inside in bin_cells(f, b, fr):
            cnt += (inside[..., None] & (cells.float() == o)).float()
        share = dy[i:i + _CHUNK].float() * (1.0 / cnt.clamp(min=1.0))
        for cell, cells, inside in bin_cells(f, b, fr):
            hit = inside[..., None] & (cells.float() == o)
            dfeat.index_add_(0, cell.reshape(-1),
                             torch.where(hit, share, 0.0).reshape(-1, C))
    return dfeat.reshape(feat.shape)


class RoIPoolTrain(torch.autograd.Function):
    """Differentiable ROI pool of a single or batched map. On a CUDA tensor
    the forward is the ROI kernel and the backward the backward kernel; on
    a CPU tensor both are the plain versions. rois get no gradient."""

    @staticmethod
    def forward(ctx, feat, rois, pooled, spatial_scale):
        if feat.is_cuda:
            from mv3d_tf_tpu_torch.ops.roi_pool_cuda import roi_pool_cuda
            out = roi_pool_cuda(feat, rois, pooled, spatial_scale)
        else:
            out = roi_pool(feat, rois, pooled, spatial_scale)
        ctx.save_for_backward(feat, rois, out)
        ctx.pooled, ctx.spatial_scale = pooled, spatial_scale
        return out

    @staticmethod
    def backward(ctx, dy):
        feat, rois, out = ctx.saved_tensors
        dy = dy.float().contiguous()
        if feat.is_cuda:
            from mv3d_tf_tpu_torch.ops.roi_pool_cuda import roi_pool_bwd_cuda
            dfeat = roi_pool_bwd_cuda(feat, rois, out, dy, ctx.pooled,
                                      ctx.spatial_scale)
        else:
            dfeat = roi_pool_bwd(feat, rois, out, dy, ctx.pooled,
                                 ctx.spatial_scale)
        return dfeat.to(feat.dtype), None, None, None


def roi_pool_train(feat, rois, pooled=7, spatial_scale=1.0 / 8):
    """The train path's ROI pool (roi_pool.py:207-223): feat (H,W,C) or
    (B,H,W,C), a roi's frame its column 0, on a CUDA device (both kernels)
    or the CPU (both plain versions); any other device raises."""
    if feat.dim() not in (3, 4):
        raise ValueError("roi_pool_train: feat must be (H,W,C) or (B,H,W,C)")
    if not (feat.is_cuda or feat.device.type == "cpu"):
        raise ValueError("roi_pool_train: no ROI pool for device "
                         + str(feat.device))
    return RoIPoolTrain.apply(feat.contiguous(), rois.contiguous(), pooled,
                              spatial_scale)


class RoIPoolTrainPlain(torch.autograd.Function):
    """The train pool through both plain versions on any device: the
    reference the kernel pair is held to on the card (chip_smoke.py) and
    tools/profile_train's plain_pool variant."""

    @staticmethod
    def forward(ctx, feat, rois, pooled, spatial_scale):
        out = roi_pool(feat, rois, pooled, spatial_scale)
        ctx.save_for_backward(feat, rois, out)
        ctx.args = (pooled, spatial_scale)
        return out

    @staticmethod
    def backward(ctx, dy):
        feat, rois, out = ctx.saved_tensors
        return (roi_pool_bwd(feat, rois, out, dy.float(), *ctx.args)
                .to(feat.dtype), None, None, None)


def roi_pool_train_plain(feat, rois, pooled=7, spatial_scale=1.0 / 8):
    """roi_pool_train's plain pair: the plain forward and gradient, on the
    device feat lies on, with no kernel."""
    return RoIPoolTrainPlain.apply(feat, rois, pooled, spatial_scale)


def roi_pool_np(feat, rois, pooled=7, spatial_scale=1.0 / 8):
    """The reference's ROIPoolForward loops in numpy on one (H,W,C) map and
    (R,5) rois, with the integer-exact bins of ``bin_bounds``
    (ops/roi_pool.py:226-256). Returns (R,pooled,pooled,C)."""
    f32 = np.float32
    H, W, C = feat.shape
    out = np.zeros((rois.shape[0], pooled, pooled, C), feat.dtype)

    def cround(v):
        return int(np.sign(v) * np.floor(abs(f32(v)) + f32(0.5)))

    for r in range(rois.shape[0]):
        xs, ys, xe, ye = (cround(f32(rois[r, k]) * f32(spatial_scale))
                          for k in (1, 2, 3, 4))
        roi_w = max(xe - xs + 1, 1)
        roi_h = max(ye - ys + 1, 1)
        for ph in range(pooled):
            for pw in range(pooled):
                h0 = min(max((ph * roi_h) // pooled + ys, 0), H)
                h1 = min(max(((ph + 1) * roi_h + pooled - 1) // pooled + ys,
                             0), H)
                w0 = min(max((pw * roi_w) // pooled + xs, 0), W)
                w1 = min(max(((pw + 1) * roi_w + pooled - 1) // pooled + xs,
                             0), W)
                if h1 > h0 and w1 > w0:
                    out[r, ph, pw] = feat[h0:h1, w0:w1].max(axis=(0, 1))
    return out
