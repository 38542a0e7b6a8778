"""BEV placement: the CUDA kernel (csrc/bev_place.cu), its plain PyTorch
version and the dispatch between them. The kernel replaces
mv3d_tf_tpu/ops/bev_pallas.py:bev_place_pallas.

All three take what ops/bev.py's stable sort gives: seg_s (B, N) int32,
each point's slot cell*9 + slice in ascending order, a dead point at a
value >= N_FLAT (ops/bev.py:DEAD); zs (B, N) float32, z - HEIGHT_MIN, and
rs (B, N) float32, the reflectance, in the same order. They return the
(B, 601, 601, 9) float32 raster. The sort kept file order within a run of
equal slots, so
  * a (cell, slice)'s height winner is the last entry of its run;
  * a cell's intensity winner is the last entry of the cell's run, since
    slices ascend within a cell (the reference rewrites channel 8 slice
    after slice).
Every winner owns its output element, so the placement is a set of
unique stores and its result is exact and deterministic.

The kernel writes each raster element once: a block builds a chunk of
CHUNK_CELLS whole cells of one scan in shared memory, zeros and winners,
from the chunk's range of the sorted slots, and stores it; the wrapper
allocates the raster with torch.empty and launches it.
"""

import torch

from mv3d_tf_tpu_torch import kernels
from mv3d_tf_tpu_torch.geometry import BEV_C, BEV_H, BEV_W, N_SLICES

N_FLAT = BEV_H * BEV_W * BEV_C      # raster elements per scan
# cells of a kernel block's chunk, csrc/bev_place.cu's constant of that name
CHUNK_CELLS = 1024


def bev_place_plain(seg_s, zs, rs):
    """The plain version: the winners by comparison with the next entry,
    then one index_put_ into a zeroed raster."""
    B, N = seg_s.shape
    nxt = torch.cat([seg_s[:, 1:], seg_s.new_full((B, 1), -1)], 1)
    cell = torch.div(seg_s, BEV_C, rounding_mode="floor")
    live = (seg_s >= 0) & (seg_s < N_FLAT)
    win_h = live & (seg_s != nxt)
    win_i = live & (cell != torch.div(nxt, BEV_C, rounding_mode="floor"))
    frame = torch.arange(B, device=seg_s.device)[:, None].expand(B, N)
    out = torch.zeros((B, N_FLAT), dtype=torch.float32, device=seg_s.device)
    out.index_put_(
        (torch.cat([frame[win_h], frame[win_i]]),
         torch.cat([seg_s[win_h], cell[win_i] * BEV_C + N_SLICES]).long()),
        torch.cat([zs[win_h], rs[win_i]]))
    return out.reshape(B, BEV_H, BEV_W, BEV_C)


def bev_place_cuda(seg_s, zs, rs):
    """The placement on the card: seg_s (B, N) int32, zs and rs (B, N)
    float32, contiguous, on one CUDA device. Returns (B, 601, 601, 9)
    float32, every element written by the one launch."""
    if not all(t.is_cuda and t.device == seg_s.device
               for t in (seg_s, zs, rs)):
        raise ValueError("bev_place_cuda: inputs must be on one CUDA device")
    if seg_s.dtype != torch.int32 or zs.dtype != torch.float32 \
            or rs.dtype != torch.float32:
        raise TypeError("bev_place_cuda: seg_s must be int32 and zs, rs "
                        "float32, got %s, %s, %s"
                        % (seg_s.dtype, zs.dtype, rs.dtype))
    if seg_s.dim() != 2 or zs.shape != seg_s.shape or rs.shape != seg_s.shape:
        raise ValueError("bev_place_cuda: seg_s, zs and rs must be one (B, N) "
                         "shape, got %s, %s, %s" % (tuple(seg_s.shape),
                                                    tuple(zs.shape),
                                                    tuple(rs.shape)))
    if not all(t.is_contiguous() for t in (seg_s, zs, rs)):
        raise ValueError("bev_place_cuda: inputs must be contiguous")
    B, N = seg_s.shape
    if N >= 2 ** 31:
        raise ValueError("bev_place_cuda: %d points a scan is more than the "
                         "kernel's 32-bit index takes" % N)
    out = torch.empty((B, BEV_H, BEV_W, BEV_C), dtype=torch.float32,
                      device=seg_s.device)
    if B == 0:
        return out
    lib = kernels.library()
    with torch.cuda.device(seg_s.device):
        bev_place_cuda.launches += 1
        err = lib.mv3d_bev_place_f32(
            seg_s.data_ptr(), zs.data_ptr(), rs.data_ptr(), out.data_ptr(),
            B, N, N_FLAT, BEV_C,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "bev_place_cuda")
    return out


bev_place_cuda.launches = 0


def bev_place(seg_s, zs, rs):
    """Dispatch: the kernel for CUDA tensors, the plain version for CPU
    tensors; any other device raises."""
    if seg_s.is_cuda:
        return bev_place_cuda(seg_s, zs, rs)
    if seg_s.device.type == "cpu":
        return bev_place_plain(seg_s, zs, rs)
    raise ValueError("bev_place: no placement for device " + str(seg_s.device))
