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

from mv3d_tf_tpu_torch import trace as T
from mv3d_tf_tpu_torch.geometry import (BEV_C, BEV_H, BEV_W, HEIGHT_MAX,
                                        HEIGHT_MIN, N_SLICES, RES, TOP_X_MAX,
                                        TOP_X_MIN, TOP_Y_MAX, ZRES)
from mv3d_tf_tpu_torch.ops.bev_cuda import CHUNK_CELLS, N_FLAT, bev_place

# the slice starts the reference enumerates (read_lidar.py:80), and the
# float32 bounds every formulation compares z with
SLICE_STARTS = np.arange(HEIGHT_MIN, HEIGHT_MAX, ZRES)    # 8 floats
_SLICE_BOUNDS = [(float(np.float32(h)), float(np.float32(h + ZRES)))
                 for h in SLICE_STARTS]
_X_SHIFT = -int(np.floor(-TOP_Y_MAX / RES))               # +300 (x_img shift)
_Y_SHIFT = int(np.floor(TOP_X_MAX / RES))                 # +600 (y_img shift)
DEAD = 1 << 30   # the sort key of a point that lands in no slot: sorts last


def point_cloud_2_top_np(points, res=RES, zres=ZRES,
                         side_range=(-TOP_Y_MAX, TOP_Y_MAX),
                         fwd_range=(TOP_X_MIN, TOP_X_MAX),
                         height_range=(HEIGHT_MIN, HEIGHT_MAX)):
    """The numpy twin of the reference BEV generator (read_lidar.py:10-115),
    with its ranges (mv3d_tf_tpu/ops/bev.py:51-80).

    points: (N, 4) [x, y, z, reflectance], taken as float32. Returns
    float32 (fwd/res + 1, side/res + 1, height/zres + 1): (601, 601, 9) at
    the defaults. Slice membership compares z with the slice bounds
    rounded to float32, not in float64 as numpy 2 would promote them:
    float32 is what the reference computed under numpy 1.x and what every
    device path computes.
    """
    points = np.asarray(points, np.float32)
    x, y, z, r = points[:, 0], points[:, 1], points[:, 2], points[:, 3]
    x_max = int((side_range[1] - side_range[0]) / res)
    y_max = int((fwd_range[1] - fwd_range[0]) / res)
    z_max = int((height_range[1] - height_range[0]) / zres)
    top = np.zeros((y_max + 1, x_max + 1, z_max + 1), np.float32)
    in_range = ((x > fwd_range[0]) & (x < fwd_range[1])
                & (y > -side_range[1]) & (y < -side_range[0]))
    x_shift = -int(np.floor(side_range[0] / res))
    y_shift = int(np.floor(fwd_range[1] / res))
    for i, h in enumerate(np.arange(height_range[0], height_range[1], zres)):
        lo, hi = np.float32(h), np.float32(h + zres)
        idx = np.flatnonzero(in_range & (z >= lo) & (z < hi))
        x_img = (-y[idx] / res).astype(np.int32) + x_shift
        y_img = (-x[idx] / res).astype(np.int32) + y_shift
        top[y_img, x_img, i] = z[idx] - height_range[0]
        top[y_img, x_img, z_max] = r[idx]
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


def slot_keys(points, valid):
    """The elementwise part of the fast path: (B, N, 4) float32 + (B, N)
    bool tensors -> (seg (B, N) int32 slot = cell * 9 + slice, DEAD for a
    point in no slot; z - HEIGHT_MIN; r)."""
    live, cell, slice_idx, zh, r = _prep(points, valid)
    return torch.where(live, cell * BEV_C + slice_idx, DEAD), zh, r


def sort_slots(points, valid):
    """The sort of the fast path (ops/bev.py:162-168): (B, N, 4) float32 +
    (B, N) bool tensors -> seg_s (B, N) int32 slots in ascending order
    (DEAD for a point in no slot), with z - HEIGHT_MIN and r gathered into
    the same order. The sort is stable, so file order holds within a run
    of equal slots."""
    seg, zh, r = slot_keys(points, valid)
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
    with T.span("bev.raster"):
        points, valid = _as_tensors(points, valid, device)
        if points.is_cuda:
            return point_cloud_2_top_fast(points, valid)
        if points.device.type == "cpu":
            return torch.stack([point_cloud_2_top(p, v)
                                for p, v in zip(points, valid)])
    raise ValueError("point_cloud_2_top_batch: no rasterizer for device "
                     + str(points.device))


def _points_in(cells, slices, rng):
    """One point inside each (cell, slice): x, y a fraction 0.2-0.8 into
    the pixel that float32 division and truncation give the cell, z as far
    into the slice; the reflectance random. Cells must be reachable by
    points: pixel row 1..600, column 1..599 (the strict range filters)."""
    cells, slices = np.asarray(cells), np.asarray(slices)
    k = cells % BEV_W - _X_SHIFT                # trunc(-y / RES)
    m = cells // BEV_W - _Y_SHIFT               # trunc(-x / RES), <= 0
    u = rng.uniform(0.2, 0.8, (3, cells.size))
    v = np.where(k >= 0, k + u[0], k - u[0])
    lo = np.array([b[0] for b in _SLICE_BOUNDS])[slices]
    return np.stack([(-m + u[1]) * RES, -v * RES, lo + u[2] * ZRES,
                     rng.rand(cells.size)], 1).astype(np.float32)


def chunk_edge_points(n=4096, seed=0):
    """Three scans of n points whose sorted slots meet the placement
    kernel's chunk edges (a block owns CHUNK_CELLS whole cells, ops/
    bev_cuda.py): points (3, n, 4) float32 and valid (3, n) bool.

    Scans 0 and 2 hold, at every chunk edge whose cells points can reach,
    two points in the last height slot of the chunk's last cell (a run
    that ends on the chunk's last slot; its intensity is the chunk's last
    element), one in a lower slice of that cell, and two in the first slot
    of the next chunk; one point in the first and one in the last cell
    points can reach; a cell of 96 points over all slices whose run spans
    sorted entry 1024; then dead points: rows on live cells with valid
    False, rows out of range, above the last slice and NaN rows. File
    order is shuffled, so each run's winner is drawn at random. Scan 1 is
    empty (every row invalid) between the two."""
    rng = np.random.RandomState(seed)
    n_cells = BEV_H * BEV_W
    reach = lambda c: 1 <= c % BEV_W <= BEV_W - 2 and c // BEV_W >= 1  # noqa
    runs = []                                   # (cell, slice, count)
    for e in range(CHUNK_CELLS, n_cells, CHUNK_CELLS):
        if reach(e - 1) and reach(e):
            runs += [(e - 1, 3, 1), (e - 1, N_SLICES - 1, 2), (e, 0, 2)]
    runs += [(BEV_W + 1, 0, 1), (n_cells - 2, N_SLICES - 1, 1)]
    runs.sort(key=lambda r: r[0] * BEV_C + r[1])
    # a gap between two runs' cells where 96 entries starting there cross
    # sorted entry 1024
    before = np.cumsum([0] + [r[2] for r in runs])
    gaps = [j for j in range(1, len(runs))
            if 928 < before[j] <= 1023 and reach(runs[j - 1][0] + 1)
            and runs[j - 1][0] + 1 < runs[j][0]]
    if not gaps:
        raise ValueError("chunk_edge_points: no room for the spanning run")
    span = runs[gaps[0] - 1][0] + 1
    runs += [(span, s, 12) for s in range(N_SLICES)]
    cells = np.repeat([r[0] for r in runs], [r[2] for r in runs])
    slices = np.repeat([r[1] for r in runs], [r[2] for r in runs])
    dead = n - cells.size
    if dead < 16:
        raise ValueError("chunk_edge_points: n=%d leaves no dead points" % n)
    scans, valids = [], []
    for _ in range(2):
        live = _points_in(cells, slices, rng)
        junk = _points_in(rng.choice(cells, dead), np.zeros(dead, int), rng)
        q = dead // 4
        junk[q:2 * q, 0] = 70.0                 # out of range
        junk[2 * q:3 * q, 2] = 5.0              # above the last slice
        junk[3 * q::2, 0] = np.nan              # NaN rows: x or z
        junk[3 * q + 1::2, 2] = np.nan
        pts = np.concatenate([live, junk])
        valid = np.ones(n, bool)
        valid[cells.size:cells.size + q] = False    # on live cells
        perm = rng.permutation(n)
        scans.append(pts[perm])
        valids.append(valid[perm])
    points = np.stack([scans[0], scans[0], scans[1]])
    valid = np.stack([valids[0], np.zeros(n, bool), valids[1]])
    return points, valid


def chunk_edge_slots(n=4096, seed=0):
    """chunk_edge_points' three scans as the placement takes them (CPU
    tensors from sort_slots), with the ends of the raster that no point can
    reach spliced into scans 0 and 2: two entries at slot 0 first, two at
    slot N_FLAT - 2 (the last cell's last slice; its intensity is element
    N_FLAT - 1) after the live entries, four dead entries dropped from the
    end. Returns (seg_s, zs, rs), each (3, n)."""
    points, valid = chunk_edge_points(n, seed)
    seg_s, zs, rs = sort_slots(torch.from_numpy(points),
                               torch.from_numpy(valid))
    ends = torch.tensor([0, 0, N_FLAT - 2, N_FLAT - 2], dtype=torch.int32)
    vals = torch.tensor([0.25, 0.5, 0.75, 1.0])
    for b in (0, 2):
        live = int((seg_s[b] < N_FLAT).sum())
        for t, first, last in ((seg_s, ends[:2], ends[2:]),
                               (zs, vals[:2], vals[2:]),
                               (rs, vals[2:] + 1, vals[:2] + 1)):
            t[b] = torch.cat([first, t[b, :live], last, t[b, live:n - 4]])
    return seg_s, zs, rs


def pad_points(points, bucket=131072):
    """Pad or trim one (N, 4) scan to a fixed bucket, with its valid mask."""
    with T.span("bev.pad"):
        n = min(points.shape[0], bucket)
        out = np.zeros((bucket, 4), np.float32)
        out[:n] = points[:n]
        valid = np.zeros((bucket,), bool)
        valid[:n] = True
    return out, valid


def load_velodyne(path):
    """A KITTI velodyne .bin as (N, 4) float32 (read_lidar.py:128-129)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)
