"""The port's BEV rasterization (mv3d_tf_tpu_torch/ops/bev.py, ops/bev_cuda.py)
against mv3d_tf_tpu/ops/bev.py on CPU, bit for bit: the numpy twin, the
plain torch scatter, the sort-and-place path through the plain placement,
the slice-boundary rule, and the placement kernel's chunk-edge traffic
(ops/bev.py:chunk_edge_points, chunk_edge_slots), which chip_smoke.py also
holds the kernel to."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mv3d_tf_tpu.ops import bev as J  # noqa: E402
from mv3d_tf_tpu_torch.ops import bev as T  # noqa: E402
from mv3d_tf_tpu_torch.ops import bev_cuda as C  # noqa: E402

N = 4096   # one padded point count in every case: each JAX jit compiles once


def _scan(rng, n=5000):
    """tests/test_bev.py:_synthetic_scan: some points out of every range."""
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.uniform(-5, 70, n)
    pts[:, 1] = rng.uniform(-35, 35, n)
    pts[:, 2] = rng.uniform(-2.5, 1.0, n)
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


def _on_boundary(z):
    bounds = np.float32(np.concatenate([J.SLICE_STARTS,
                                        J.SLICE_STARTS + 0.3]))
    return np.isin(z, bounds)


def _port_paths(pts, val):
    """The port's plain scatter and its fast path (plain placement) on one
    padded scan, as numpy."""
    plain = T.point_cloud_2_top(pts, val, device="cpu").numpy()
    fast = T.point_cloud_2_top_fast(pts[None], val[None], device="cpu")
    return plain, fast[0].numpy()


# the hand cases of tests/test_bev.py: points and the raster entries they
# must give; [500, 300] is the cell of x=10, y=0 (y=0 -> -0.0/0.1 -> 0)
HAND_CASES = {
    "single_point": (
        [[10.0, 0.0, -1.0, 0.5]],
        {(500, 300, 3): np.float32(-1.0) + 2, (500, 300, 8): 0.5}),
    "last_write_wins": (
        [[10.0, 0.0, -0.9, 0.1], [10.0, 0.0, -1.05, 0.9]],
        {(500, 300, 3): np.float32(-1.05) + 2, (500, 300, 8): 0.9}),
    "cross_slice_intensity": (
        [[10.0, 0.0, 0.2, 0.7], [10.0, 0.0, -1.9, 0.2]],
        {(500, 300, 8): 0.7, (500, 300, 0): np.float32(-1.9) + 2,
         (500, 300, 7): np.float32(0.2) + 2}),
    "strict_filters": (
        [[0.0, 0.0, -1.0, 0.5], [60.0, 0.0, -1.0, 0.5],
         [10.0, -30.0, -1.0, 0.5], [10.0, 30.0, -1.0, 0.5],
         [10.0, 0.0, -2.1, 0.5], [10.0, 0.0, 0.4, 0.5]],
        {}),
}


@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_hand_cases(case):
    rows, want = HAND_CASES[case]
    pts = np.array(rows, np.float32)
    top = T.point_cloud_2_top_np(pts)
    assert top.shape == (601, 601, 9) and top.dtype == np.float32
    assert np.array_equal(top, J.point_cloud_2_top_np(pts))
    assert np.count_nonzero(top) == len(want)
    for idx, v in want.items():
        assert top[idx] == np.float32(v), idx
    p, v = T.pad_points(pts, N)
    for got in _port_paths(p, v):
        assert np.array_equal(got, top)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_matches_jax_twin(seed):
    pts = _scan(np.random.RandomState(seed))
    assert not _on_boundary(pts[:, 2]).any()
    assert np.array_equal(T.point_cloud_2_top_np(pts),
                          J.point_cloud_2_top_np(pts))


# (res, zres, side_range, fwd_range, height_range) other than the defaults
RANGES = {
    "coarse": (0.2, 0.5, (-20.0, 20.0), (0.0, 40.0), (-2.5, 1.0)),
    "offset": (0.1, 0.3, (-10.0, 25.0), (5.0, 45.0), (-1.7, 0.5)),
    "fine": (0.05, 0.4, (-15.0, 15.0), (0.0, 30.0), (-2.0, 0.4)),
}


@pytest.mark.parametrize("name", sorted(RANGES))
def test_twin_ranges_match_jax_twin(name):
    """The twin's range arguments size and fill the raster as JAX's twin
    does, bit for bit (no z on a slice bound, where the two differ)."""
    res, zres, side, fwd, height = RANGES[name]
    pts = _scan(np.random.RandomState(4))
    starts = np.arange(height[0], height[1], zres)
    bounds = np.float32(np.concatenate([starts, starts + zres]))
    assert not np.isin(pts[:, 2], bounds).any()
    kw = dict(res=res, zres=zres, side_range=side, fwd_range=fwd,
              height_range=height)
    want = J.point_cloud_2_top_np(pts, **kw)
    got = T.point_cloud_2_top_np(pts, **kw)
    assert got.shape == want.shape != (601, 601, 9)
    assert got.dtype == np.float32 and np.count_nonzero(got) > 1000
    assert np.array_equal(got, want)


def _heavy_duplicates(rng):
    """tests/test_bev.py:106-115 traffic for one scan: every other point in
    a 0.5 m square, 5% of the rows invalid."""
    pts = np.zeros((N, 4), np.float32)
    pts[:, 0] = rng.rand(N) * 70 - 5
    pts[:, 1] = rng.rand(N) * 70 - 35
    pts[:, 2] = rng.rand(N) * 4 - 2.5
    pts[:, 3] = rng.rand(N)
    pts[::2, 0] = 10.0 + rng.rand((N + 1) // 2) * 0.5
    pts[::2, 1] = 5.0 + rng.rand((N + 1) // 2) * 0.5
    return pts, rng.rand(N) > 0.05


def _plain_case(name, rng):
    if name == "random":
        return T.pad_points(_scan(rng), N)
    if name == "heavy_duplicates":
        return _heavy_duplicates(rng)
    pts, val = T.pad_points(_scan(rng, 3000), N)
    if name == "all_invalid":
        return pts, np.zeros(N, bool)
    pts[::3, 0] = np.nan                 # NaN x: fails the strict filters
    pts[1::7, 1:3] = np.nan              # NaN y and z
    return pts, val


@pytest.mark.parametrize("name", ["random", "heavy_duplicates", "all_invalid",
                                  "nan_rows"])
def test_plain_scatter_matches_jax(name):
    pts, val = _plain_case(name, np.random.RandomState(7))
    ref = np.asarray(J.point_cloud_2_top(pts, val))
    plain, fast = _port_paths(pts, val)
    assert np.array_equal(plain, ref)
    assert np.array_equal(fast, ref)
    if name == "all_invalid":
        assert not ref.any()
    else:
        assert np.count_nonzero(ref) > 100


def test_batch_matches_jax_batch():
    rng = np.random.RandomState(3)
    padded = [T.pad_points(_scan(rng, 3000), N) for _ in range(3)]
    pts = np.stack([p for p, _ in padded])
    val = np.stack([v for _, v in padded])
    ref = np.asarray(J.point_cloud_2_top_batch(pts, val))
    got = T.point_cloud_2_top_batch(pts, val, device="cpu")
    assert got.device.type == "cpu" and got.shape == (3, 601, 601, 9)
    assert np.array_equal(got.numpy(), ref)
    # tensors stay on their device whatever ``device`` says
    again = T.point_cloud_2_top_batch(torch.from_numpy(pts),
                                      torch.from_numpy(val))
    assert torch.equal(again, got)


def _jax_fast(pts, val):
    return np.asarray(J.point_cloud_2_top_fast(
        jnp.asarray(pts), jnp.asarray(val), interpret=True))


def test_fast_path_matches_jax_pallas():
    """B=2, N=4096 heavy-duplicate traffic (tests/test_bev.py:97-123):
    the port's sort + plain placement equals the JAX sort + Pallas
    placement in interpret mode, and the kernel is not launched."""
    rng = np.random.RandomState(11)
    pts, val = (np.stack(a) for a in zip(*[_heavy_duplicates(rng)
                                            for _ in range(2)]))
    before = C.bev_place_cuda.launches
    got = T.point_cloud_2_top_fast(pts, val, device="cpu").numpy()
    assert C.bev_place_cuda.launches == before
    assert np.array_equal(got, _jax_fast(pts, val))
    for b in range(2):
        assert np.array_equal(got[b], T.point_cloud_2_top_np(pts[b][val[b]]))


def _boundary_points():
    """16 points, one at float32(h) and one at float32(h + 0.3) for each
    of the 8 slice starts h, each alone in its cell; two sit at y = +0.0
    and y = -0.0, whose pixel column truncates to 300. The last one,
    float32(0.4), is past the last slice and drops out."""
    pts = np.zeros((16, 4), np.float32)
    for i, h in enumerate(J.SLICE_STARTS):
        for j, z in enumerate((np.float32(h), np.float32(h + 0.3))):
            k = 2 * i + j
            pts[k] = [10.05 + 2.0 * i + j, -5.05 + 10.0 * j, z,
                      0.05 + 0.05 * k]
    pts[0, 1], pts[1, 1] = 0.0, -0.0
    return pts


def test_slice_boundary_pin():
    """On a slice boundary the port's three paths agree with JAX's two
    device paths (float32 bounds). JAX's numpy twin differs there while
    numpy promotes its float32 z against the float64 slice bounds (numpy
    2's rule); under numpy 1.x's value-based casting it agrees."""
    pts16 = _boundary_points()
    pts, val = T.pad_points(pts16, N)
    dev = np.asarray(J.point_cloud_2_top(pts, val))
    fast = _jax_fast(np.stack([pts, pts]), np.stack([val, val]))
    assert np.array_equal(fast[0], dev) and np.array_equal(fast[1], dev)
    assert np.count_nonzero(dev[..., 8]) == 15   # one cell per kept point
    assert np.array_equal(T.point_cloud_2_top_np(pts16), dev)
    for got in _port_paths(pts, val):
        assert np.array_equal(got, dev)
    assert dev[500, 300, 8] and dev[490, 300, 8]     # y = +0.0, -0.0

    h = J.SLICE_STARTS[3]
    float64_bounds = not (np.array([np.float32(h)]) >= h)[0]
    differ = np.count_nonzero(J.point_cloud_2_top_np(pts16) != dev)
    if float64_bounds:
        # 10 points land one slice lower there; each moves its height
        # entry from one channel to the next: 20 entries
        assert differ == 20, (
            "the JAX numpy twin differs in %d entries, not 20: it no longer "
            "compares float32 z with float64 bounds as numpy 2 does" % differ)
    else:
        assert differ == 0


def test_plain_placement_runs_of_one_slot():
    """bev_place_plain on a hand-sorted input: the last entry of a slot's
    run wins the height, the last entry of a cell's run the intensity,
    dead entries and the scan's last entry are handled."""
    seg = torch.tensor([[5, 5, 7, 9 * 3, T.DEAD, T.DEAD],
                        [0, 0, 0, 9 * 2 + 4, 9 * 2 + 6, C.N_FLAT - 2]],
                       dtype=torch.int32)
    zs = torch.arange(12, dtype=torch.float32).reshape(2, 6) + 1
    rs = zs + 100
    out = C.bev_place(seg, zs, rs).reshape(2, -1)
    want = torch.zeros_like(out)
    want[0, [5, 7, 8, 27, 35]] = torch.tensor([2.0, 3, 103, 4, 104])
    want[1, [0, 8, 22, 24, 26, C.N_FLAT - 2, C.N_FLAT - 1]] = torch.tensor(
        [9.0, 109, 10, 11, 111, 12, 112])
    assert torch.equal(out, want)


def test_kernel_wrapper_refuses_cpu_tensors():
    seg = torch.zeros((1, 8), dtype=torch.int32)
    zs = torch.zeros((1, 8))
    with pytest.raises(ValueError):
        C.bev_place_cuda(seg, zs, zs)


def _jax_place(seg_s, zs, rs):
    """JAX's Pallas placement (interpret mode) on sorted slots, with the
    winners, stripe offsets and row bounds its fast path computes
    (mv3d_tf_tpu/ops/bev.py:170-187)."""
    from mv3d_tf_tpu.ops.bev_pallas import (NO_REM, N_STEPS, ROW_SEGS,
                                            ROWS_PER_STEP, bev_place_pallas)
    import jax
    seg = jnp.asarray(seg_s.numpy())
    nxt = jnp.concatenate([seg[:, 1:], jnp.full((seg.shape[0], 1), -1,
                                                jnp.int32)], 1)
    live = seg < C.N_FLAT
    win_h = (seg != nxt) & live
    win_i = (seg // 9 != nxt // 9) & live
    rem = seg - (seg // ROW_SEGS) * ROW_SEGS
    rem_h = jnp.where(win_h, rem, NO_REM)
    rem_i = jnp.where(win_i, (rem // 9) * 9 + 8, NO_REM)
    starts = jnp.arange(N_STEPS * ROWS_PER_STEP + 1, dtype=jnp.int32) \
        * ROW_SEGS
    bounds = jax.vmap(lambda s: jnp.searchsorted(s, starts).astype(
        jnp.int32))(seg)
    return np.asarray(bev_place_pallas(
        rem_h, rem_i, jnp.asarray(zs.numpy()), jnp.asarray(rs.numpy()),
        bounds, interpret=True))


def test_chunk_edge_points_front_end():
    """The chunk-edge scans: the port's plain scatter and its fast path
    (plain placement) equal the numpy twin and JAX's batch rasterizer bit
    for bit, and the traffic has what it promises: the chunks' last
    elements written, a run across sorted entry 1024, the empty scan 1,
    dead rows."""
    pts, val = T.chunk_edge_points(N)
    ref = np.asarray(J.point_cloud_2_top_batch(pts, val))
    plain = T.point_cloud_2_top_batch(pts, val, device="cpu").numpy()
    fast = T.point_cloud_2_top_fast(pts, val, device="cpu").numpy()
    assert np.array_equal(plain, ref) and np.array_equal(fast, ref)
    for b in (0, 2):
        assert np.array_equal(ref[b], T.point_cloud_2_top_np(pts[b][val[b]]))
    assert not ref[1].any()
    flat = ref.reshape(3, -1)
    edges = np.arange(C.CHUNK_CELLS, 601 * 601, C.CHUNK_CELLS)
    last = flat[0, edges * 9 - 1]               # the chunks' last elements
    first = flat[0, edges * 9]                  # the next chunks' first
    assert (last > 0).sum() > 300 and (last > 0).sum() == (first > 0).sum()
    seg, _, _ = T.sort_slots(torch.from_numpy(pts), torch.from_numpy(val))
    assert seg[0, 1023] // 9 == seg[0, 1024] // 9 < C.N_FLAT // 9
    dead = (seg[0] >= C.N_FLAT).sum()
    assert dead > 2000 and (seg[1] >= C.N_FLAT).all()


def test_chunk_edge_slots_plain_matches_jax_pallas():
    """bev_place_plain on the chunk-edge slots, with the raster's first and
    last elements spliced in, equals JAX's Pallas placement in interpret
    mode bit for bit; the wrapper's dispatch takes the plain route on the
    CPU without launching the kernel. The NaN rows' values sort last, onto
    dead entries, which the placement ignores; JAX's one-hot product would
    spread them (0 * NaN in its last block), so it gets them as zeros."""
    seg_s, zs, rs = T.chunk_edge_slots(N)
    assert seg_s[0, 0] == seg_s[2, 0] == 0
    assert torch.isnan(zs).any()
    before = C.bev_place_cuda.launches
    got = C.bev_place(seg_s, zs, rs)
    assert C.bev_place_cuda.launches == before
    dead = seg_s >= C.N_FLAT
    zs0, rs0 = zs.masked_fill(dead, 0.0), rs.masked_fill(dead, 0.0)
    assert torch.equal(C.bev_place(seg_s, zs0, rs0), got)
    want = _jax_place(seg_s, zs0, rs0)
    assert np.array_equal(got.numpy(), want)
    flat = want.reshape(3, -1)
    assert flat[0, 0] == 0.5 and flat[0, 8] == 2.0
    assert flat[2, -2] == 1.0 and flat[2, -1] == 1.5
    assert not flat[1].any()
    assert np.array_equal(got.numpy(), C.bev_place_plain(seg_s, zs, rs))


def test_chunk_cells_is_the_kernels():
    """ops/bev_cuda.CHUNK_CELLS, at whose edges chunk_edge_points cuts its
    traffic, is the chunk that csrc/bev_place.cu compiles in, with the
    raster's channels; the C entry takes no chunk size, and its ctypes
    signature has one type per parameter."""
    import os
    import re
    from mv3d_tf_tpu_torch import kernels
    src = open(os.path.join(os.path.dirname(C.__file__), os.pardir, "csrc",
                            "bev_place.cu")).read()
    assert re.findall(r"constexpr int CHUNK_CELLS = (\d+);", src) == [
        str(C.CHUNK_CELLS)]
    assert re.findall(r"constexpr int CHANNELS = (\d+);", src) == [
        str(C.BEV_C)]
    entry = re.search(r"int mv3d_bev_place_f32\(([^)]*)\)", src).group(1)
    assert "chunk" not in entry
    assert entry.count(",") + 1 == len(
        kernels._SIGNATURES["mv3d_bev_place_f32"])
