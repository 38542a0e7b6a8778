"""BEV rasterization: a Velodyne scan -> the (601, 601, 9) bird's-eye raster
(mv3d_tf_tpu/ops/bev.py), on tensors.

Reference semantics (the reference's tools/read_lidar.py:10-115, as the
JAX package pins them):
  * channels 0..7: height above HEIGHT_MIN of the LAST point in file order
    that falls in the cell and the 0.3 m slice (last-write-wins, not a max);
  * channel 8: reflectance of the last point of the highest slice that
    touches the cell;
  * strict range filters x in (0, 60), y in (-30, 30); pixel coordinates
    truncate toward zero.

Three formulations, bit-identical to each other:
  * ``point_cloud_2_top_np``: the numpy twin, on the host;
  * ``point_cloud_2_top``: the plain torch scatter (per slot, the winner is
    the scatter-max of the point ordinal; then one store of the winners);
    the CPU path and the reference of the whole front end;
  * ``point_cloud_2_top_fast``: one stable sort by slot = cell*9 + slice,
    then the placement of ops/bev_cuda.py (the CUDA kernel on the card,
    its plain version on the CPU).
``point_cloud_2_top_batch`` runs the fast path on the card and the plain
scatter on the CPU; numpy inputs go to ``device`` ("cuda" unless the caller
asks for another), tensors stay where they are.

Two float32 rules hold in all three:
  * slice boundaries: z is compared with float32(h) and float32(h + ZRES),
    as in the JAX device paths and in the reference under numpy 1.x. (The
    JAX package's numpy twin compares in float64 under numpy 2, so a z
    that sits exactly on a boundary lands one slice off there;
    tests/test_torch_bev.py pins both.)
  * pixel coordinates come from IEEE float32 division -y / RES by a
    tensor: PyTorch's CUDA division by a Python scalar multiplies by the
    scalar's reciprocal, which moves a coordinate on a 0.1 m boundary by
    one pixel.
"""

import numpy as np
import torch

from mv3d_tf_tpu_torch.geometry import (BEV_C, BEV_H, BEV_W, HEIGHT_MAX,
                                        HEIGHT_MIN, N_SLICES, RES, TOP_X_MAX,
                                        TOP_X_MIN, TOP_Y_MAX, ZRES)
from mv3d_tf_tpu_torch.ops.bev_cuda import N_FLAT, bev_place

# the slice starts the reference enumerates (read_lidar.py:80), and the
# float32 bounds every formulation compares z with
SLICE_STARTS = np.arange(HEIGHT_MIN, HEIGHT_MAX, ZRES)    # 8 floats
_SLICE_BOUNDS = [(float(np.float32(h)), float(np.float32(h + ZRES)))
                 for h in SLICE_STARTS]
_X_SHIFT = -int(np.floor(-TOP_Y_MAX / RES))               # +300 (x_img shift)
_Y_SHIFT = int(np.floor(TOP_X_MAX / RES))                 # +600 (y_img shift)
DEAD = 1 << 30   # the sort key of a point that lands in no slot: sorts last


def point_cloud_2_top_np(points):
    """The numpy twin of the reference BEV generator (read_lidar.py:10-115).

    points: (N, 4) [x, y, z, reflectance], taken as float32. Returns
    (601, 601, 9) float32. Slice membership compares z with the slice
    bounds rounded to float32, not in float64 as numpy 2 would promote
    them: float32 is what the reference computed under numpy 1.x and
    what every device path computes.
    """
    points = np.asarray(points, np.float32)
    x, y, z, r = points[:, 0], points[:, 1], points[:, 2], points[:, 3]
    top = np.zeros((BEV_H, BEV_W, BEV_C), np.float32)
    in_range = ((x > TOP_X_MIN) & (x < TOP_X_MAX)
                & (y > -TOP_Y_MAX) & (y < TOP_Y_MAX))
    for i, (lo, hi) in enumerate(_SLICE_BOUNDS):
        idx = np.flatnonzero(in_range & (z >= lo) & (z < hi))
        x_img = (-y[idx] / RES).astype(np.int32) + _X_SHIFT
        y_img = (-x[idx] / RES).astype(np.int32) + _Y_SHIFT
        top[y_img, x_img, i] = z[idx] - HEIGHT_MIN
        top[y_img, x_img, N_SLICES] = r[idx]
    return top


def _as_tensors(points, valid, device):
    """Points as float32 and the mask as bool; numpy inputs go to device."""
    if not torch.is_tensor(points):
        points = torch.as_tensor(np.asarray(points, np.float32), device=device)
    if not torch.is_tensor(valid):
        valid = torch.as_tensor(np.asarray(valid, bool), device=device)
    return points.float(), valid.to(device=points.device, dtype=torch.bool)


def _prep(points, valid):
    """The elementwise part shared by both formulations, on (..., N, 4):
    (live, cell, slice_idx, z - HEIGHT_MIN, r); cell and slice_idx int32,
    meaningful only where live."""
    x, y, z, r = points.unbind(-1)
    in_range = (valid
                & (x > TOP_X_MIN) & (x < TOP_X_MAX)
                & (y > -TOP_Y_MAX) & (y < TOP_Y_MAX))
    # true float32 division by a tensor; cast truncates toward zero
    res = torch.tensor(RES, dtype=torch.float32, device=points.device)
    x_img = (-y / res).to(torch.int32) + _X_SHIFT
    y_img = (-x / res).to(torch.int32) + _Y_SHIFT
    cell = y_img * BEV_W + x_img
    # a point belongs to at most one slice; the last match wins, as in JAX
    slice_idx = torch.full_like(cell, -1)
    for i, (lo, hi) in enumerate(_SLICE_BOUNDS):
        slice_idx = torch.where((z >= lo) & (z < hi), i, slice_idx)
    live = in_range & (slice_idx >= 0)
    return live, cell, slice_idx, z - HEIGHT_MIN, r


def point_cloud_2_top(points, valid, device="cuda"):
    """The plain torch scatter (ops/bev.py:82-132), one scan.

    points (N, 4) float32, valid (N,) bool, on one device (numpy inputs go
    to ``device``). Returns (601, 601, 9) float32 there. Last-write-wins
    is resolved by an explicit winner: the height slot's winner is the
    largest point ordinal, the intensity slot's the largest
    (slice, ordinal) key slice*N + ordinal; then one store of the winners,
    whose slots are unique.
    """
    points, valid = _as_tensors(points, valid, device)
    n = points.shape[0]
    live, cell, slice_idx, zh, r = _prep(points, valid)
    dev = points.device
    order = torch.arange(n, device=dev)
    dump = N_FLAT                       # the slot of every dead point

    def winners(seg, key):
        win = torch.full((N_FLAT + 1,), -1, dtype=torch.int64, device=dev)
        win.scatter_reduce_(0, seg, key, "amax")
        return live & (win[seg] == key)

    seg_h = torch.where(live, cell * BEV_C + slice_idx, dump).long()
    seg_i = torch.where(live, cell * BEV_C + N_SLICES, dump).long()
    keep_h = winners(seg_h, order)
    keep_i = winners(seg_i, slice_idx.long() * n + order)
    flat = torch.zeros(N_FLAT, dtype=torch.float32, device=dev)
    flat[torch.cat([seg_h[keep_h], seg_i[keep_i]])] = torch.cat(
        [zh[keep_h], r[keep_i]])
    return flat.reshape(BEV_H, BEV_W, BEV_C)


def sort_slots(points, valid):
    """The sort of the fast path (ops/bev.py:162-168): (B, N, 4) float32 +
    (B, N) bool tensors -> seg_s (B, N) int32 slots in ascending order
    (DEAD for a point in no slot), with z - HEIGHT_MIN and r gathered into
    the same order. The sort is stable, so file order holds within a run
    of equal slots."""
    live, cell, slice_idx, zh, r = _prep(points, valid)
    seg = torch.where(live, cell * BEV_C + slice_idx, DEAD)
    seg_s, perm = torch.sort(seg, dim=-1, stable=True)
    return (seg_s.contiguous(), torch.gather(zh, -1, perm),
            torch.gather(r, -1, perm))


def point_cloud_2_top_fast(points, valid, device="cuda"):
    """Sort and place (ops/bev.py:135-187), batched: (B, N, 4) + (B, N) ->
    (B, 601, 601, 9) float32 on the inputs' device. The placement
    (ops/bev_cuda.py) finds every winner at the end of its run."""
    return bev_place(*sort_slots(*_as_tensors(points, valid, device)))


def point_cloud_2_top_batch(points, valid, device="cuda"):
    """Batched BEV rasterization: (B, N, 4) + (B, N) -> (B, 601, 601, 9).

    On the card, the sort and the CUDA placement kernel, always; on the
    CPU, the plain scatter per scan; any other device raises. Numpy inputs
    go to ``device``."""
    points, valid = _as_tensors(points, valid, device)
    if points.is_cuda:
        return point_cloud_2_top_fast(points, valid)
    if points.device.type == "cpu":
        return torch.stack([point_cloud_2_top(p, v)
                            for p, v in zip(points, valid)])
    raise ValueError("point_cloud_2_top_batch: no rasterizer for device "
                     + str(points.device))


def pad_points(points, bucket=131072):
    """Pad or trim one (N, 4) scan to a fixed bucket, with its valid mask."""
    n = min(points.shape[0], bucket)
    out = np.zeros((bucket, 4), np.float32)
    out[:n] = points[:n]
    valid = np.zeros((bucket,), bool)
    valid[:n] = True
    return out, valid


def load_velodyne(path):
    """A KITTI velodyne .bin as (N, 4) float32 (read_lidar.py:128-129)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)
