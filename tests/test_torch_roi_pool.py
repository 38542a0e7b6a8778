"""The port's plain ROI pool against the numpy CUDA-loop oracle and the JAX
pools (the Pallas kernel in interpret mode and the XLA formulation): max is
exact, so every comparison is bit for bit. The CUDA kernel is compared
with this plain version on the card by chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mv3d_tf_tpu.ops.roi_pool import roi_pool as j_roi_pool  # noqa: E402
from mv3d_tf_tpu.ops.roi_pool import roi_pool_np  # noqa: E402
from mv3d_tf_tpu.ops.roi_pool_pallas import (_bin_bounds,  # noqa: E402
                                             roi_pool_pallas)
from mv3d_tf_tpu_torch.ops import roi_pool as T  # noqa: E402
from mv3d_tf_tpu_torch.ops.roi_pool_cuda import roi_pool_cuda  # noqa: E402


def _rois(rng, n, in_h, in_w, frames=1):
    """Random rois, some past the map edge, plus the edge cases: the
    right/bottom-edge and whole-map rois (tools/tpu_selfcheck.py:78-80,
    scaled), a degenerate point, a malformed roi (x2 < x1) and one whose
    bins all fall outside the map (empty)."""
    x1 = rng.uniform(-30, in_w - 10, n)
    y1 = rng.uniform(-30, in_h - 10, n)
    rois = np.stack([rng.randint(0, frames, n), x1, y1,
                     x1 + rng.uniform(2, in_w / 2, n),
                     y1 + rng.uniform(2, in_h / 2, n)], 1)
    edge = np.array([[0, in_w - 8, in_h - 8, in_w - 1, in_h - 1],
                     [0, 0, 0, in_w - 1, in_h - 1],
                     [0, 20, 20, 20, 20],
                     [0, 40, 30, 12, 50],
                     [0, in_w + 100, in_h + 100, in_w + 300, in_h + 300]])
    edge[:, 0] = frames - 1
    return np.concatenate([rois, edge]).astype(np.float32)


def test_plain_matches_numpy_oracle(rng):
    """Also crosses the plain version's roi blocks (more than _CHUNK rois)."""
    feat = rng.randn(20, 24, 8).astype(np.float32)
    rois = _rois(rng, T._CHUNK + 40, 160, 192)
    got = T.roi_pool(torch.from_numpy(feat), torch.from_numpy(rois))
    np.testing.assert_array_equal(got.numpy(), roi_pool_np(feat, rois))
    # empty bins give 0 even where every feature is negative
    assert not got[-1].any()


def test_numpy_twin_matches_jax_numpy_oracle(rng):
    """The port's roi_pool_np against JAX's, bit for bit, and against the
    plain pool, at 1/8 and at the 2D path's 1/16."""
    feat = rng.randn(20, 24, 8).astype(np.float32)
    rois = _rois(rng, 60, 160, 192)
    for scale in (1.0 / 8, 1.0 / 16):
        got = T.roi_pool_np(feat, rois, spatial_scale=scale)
        np.testing.assert_array_equal(
            got, roi_pool_np(feat, rois, spatial_scale=scale))
        np.testing.assert_array_equal(got, T.roi_pool(
            torch.from_numpy(feat), torch.from_numpy(rois),
            spatial_scale=scale).numpy())


def test_bin_bounds_match_jax(rng):
    rois = _rois(rng, 50, 600, 600)
    ref = _bin_bounds(jnp.asarray(rois), 7, 1.0 / 8, 75, 75)
    got = T.bin_bounds(torch.from_numpy(rois), 7, 1.0 / 8, 75, 75)
    assert got.dtype == torch.int32 and got.shape == (rois.shape[0], 4, 7)
    for i, r in enumerate(ref):
        np.testing.assert_array_equal(got[:, i].numpy(), np.asarray(r))


def test_c_round_is_half_away_from_zero():
    x = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 2.4999])
    assert T._c_round(x).tolist() == [-3, -2, -1, 1, 2, 3, 2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_plain_matches_jax_pools(rng, dtype):
    """Two frames, rois over both, against roi_pool_pallas(interpret=True)
    and the XLA roi_pool."""
    feat = rng.randn(2, 12, 20, 16).astype(np.float32)
    rois = _rois(rng, 30, 96, 160, frames=2)
    jfeat = jnp.asarray(feat).astype(dtype)
    ref_pal = roi_pool_pallas(jfeat, jnp.asarray(rois), interpret=True)
    ref_xla = j_roi_pool(jfeat, jnp.asarray(rois), max_in_h=400,
                         max_in_w=500)
    tfeat = torch.from_numpy(feat).to(getattr(torch, dtype))
    got = T.roi_pool(tfeat, torch.from_numpy(rois))
    assert got.dtype == tfeat.dtype and got.shape == (35, 7, 7, 16)
    got = got.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_pal, np.float32))
    np.testing.assert_array_equal(got, np.asarray(ref_xla, np.float32))


def test_fast_dispatch_cpu_uses_plain_and_other_devices_raise(rng):
    feat = torch.from_numpy(rng.randn(2, 10, 10, 4).astype(np.float32))
    rois = torch.from_numpy(_rois(rng, 8, 80, 80, frames=2))
    before = roi_pool_cuda.launches
    assert torch.equal(T.roi_pool_fast(feat, rois), T.roi_pool(feat, rois))
    assert roi_pool_cuda.launches == before
    with pytest.raises(ValueError):
        T.roi_pool_fast(feat.to("meta"), rois.to("meta"))
    with pytest.raises(ValueError):    # the kernel wrapper takes no CPU tensor
        roi_pool_cuda(feat, rois)


@pytest.mark.parametrize("in_h,in_w,H,W", [(600, 600, 75, 75),
                                           (384, 1248, 48, 156),
                                           (88, 120, 11, 15)])
def test_bin_bounds_on_boundary_rois_match_jax(in_h, in_w, H, W):
    """The formula the kernels carry (csrc/roi_bin.cuh), pinned through
    bin_bounds on rois at every rounding and clipping case: corners on
    exact k.5 cells after the 1/8 scale and just off them, whole-map,
    beyond-map, outside, malformed and 1-cell rois."""
    rois = T.boundary_rois(in_h, in_w)
    ref = _bin_bounds(jnp.asarray(rois.numpy()), 7, 1.0 / 8, H, W)
    got = T.bin_bounds(rois, 7, 1.0 / 8, H, W)
    for i, r in enumerate(ref):
        np.testing.assert_array_equal(got[:, i].numpy(), np.asarray(r))
    # every case is there: bins clipped at both edges, empty bins, 1-cell bins
    hs, he, ws, we = got.unbind(1)
    assert (hs == 0).any() and (he == H).any() and (we == W).any()
    assert (he <= hs).any() and ((he - hs == 1) & (we - ws == 1)).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_boundary_rois_pool_matches_pallas(rng, dtype):
    """The plain pool on the boundary rois over three frames, against
    roi_pool_pallas(interpret=True), bit for bit; frame columns 0.9, 1.0,
    2.7 and 3 truncate and clamp to frames 0, 1, 2 and 2."""
    if dtype == "int8":
        feat = rng.randint(-128, 128, (3, 11, 15, 16)).astype(np.int8)
    else:
        feat = rng.randn(3, 11, 15, 16).astype(np.float32)
    rois = T.boundary_rois(88, 120, frames=3)
    jfeat = jnp.asarray(feat).astype(dtype)
    ref = roi_pool_pallas(jfeat, jnp.asarray(rois.numpy()), interpret=True)
    tfeat = torch.from_numpy(feat).to(getattr(torch, dtype))
    got = T.roi_pool(tfeat, rois)
    assert got.dtype == tfeat.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))
    frame = T._as_batch(tfeat, rois)[1]
    assert frame[:4].tolist() == [0, 1, 2, 2]
