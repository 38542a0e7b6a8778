"""The rest of the port's geometry.py against mv3d_tf_tpu/geometry.py under
jax.jit, which is how JAX's detector, proposal layer and targets run it, on
the same seeded numpy inputs: elementwise maps, floors and truncations bit
for bit; the projections, the corners' mean and the inverse extrinsics
within 1e-5 of the max (float32 sums in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from __graft_entry__ import _example_calib  # noqa: E402

from mv3d_tf_tpu import geometry as G  # noqa: E402
from mv3d_tf_tpu_torch import geometry as TG  # noqa: E402

REL = 1e-5   # of the max magnitude: the projections, the mean, the inverse

# the KITTI-like calibration of tests/test_geometry.py
P2 = np.array([[707.0, 0.0, 601.8, 45.7],
               [0.0, 707.0, 183.1, -0.34],
               [0.0, 0.0, 1.0, 0.005]], np.float32)
R0 = np.array([[0.9999, 0.0098, -0.0074],
               [-0.0099, 0.9999, -0.0043],
               [0.0074, 0.0044, 0.9999]], np.float32)
TR = np.array([[0.0002, -0.9999, -0.0106, -0.002],
               [0.0104, 0.0106, -0.9999, -0.075],
               [0.9999, 0.0002, 0.0105, -0.272]], np.float32)
R0_ROW = np.concatenate([R0.reshape(-1), np.zeros(3, np.float32)])


def _t(a):
    return torch.tensor(np.asarray(a))


def _n(t):
    return t.numpy()


def _equal(port, ref):
    np.testing.assert_array_equal(_n(port), np.asarray(ref))


def _within(port, ref, rel=REL):
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == torch.float32
    err = np.abs(_n(port).astype(np.float64) - ref).max()
    assert err <= rel * np.abs(ref).max(), err


def seed0_boxes(n=200_000):
    """Lidar boxes in front of the car: x in [0, 60), y in [-30, 30), z 0,
    l in [1, 5), w in [1, 3), h 1.5, from RandomState(0) in that order."""
    rng = np.random.RandomState(0)
    x, y = rng.uniform(0, 60, n), rng.uniform(-30, 30, n)
    l, w = rng.uniform(1, 5, n), rng.uniform(1, 3, n)
    return np.stack([x, y, np.zeros(n), l, w, np.full(n, 1.5)],
                    1).astype(np.float32)


def _boxes(rng, n):
    return np.stack([rng.uniform(5, 40, n), rng.uniform(-15, 15, n),
                     rng.uniform(-2, 0, n), rng.uniform(1, 5, n),
                     rng.uniform(0.5, 2.5, n), rng.uniform(1, 2, n)],
                    1).astype(np.float32)


def test_bv_pixels_match_jitted_jax_on_the_seed0_boxes():
    """The division by RES is jitted JAX's multiply by float32(1/RES): a
    true division (eager JAX) puts 5 of these 200,000 boxes one pixel off."""
    boxes = seed0_boxes()
    want = np.asarray(jax.jit(G.lidar_3d_to_bv)(boxes))
    _equal(TG.lidar_3d_to_bv(_t(boxes)), want)
    eager = np.asarray(G.lidar_3d_to_bv(boxes))
    assert np.count_nonzero((eager != want).any(1)) == 5
    cnr = np.asarray(jax.jit(G.lidar_3d_to_corners)(boxes))
    cnr2 = np.concatenate([cnr, cnr[::-1]], 1)
    _equal(TG.corners_to_bv(_t(cnr2)), jax.jit(G.corners_to_bv)(cnr2))


def test_bv_coord_on_the_tenths():
    """x and y on every multiple of 0.1 m of the crop, where a pixel edge
    lies: bit for bit with jitted JAX."""
    x = (np.arange(0, 600) / 10).astype(np.float32)
    y = (np.arange(-300, 300) / 10).astype(np.float32)
    want = jax.jit(G.lidar_to_bv_coord)(x, y)
    for p, r in zip(TG.lidar_to_bv_coord(_t(x), _t(y)), want):
        _equal(p, r)


def test_bv_to_lidar_coords(rng):
    """Bit for bit with the formula as written (eager JAX). Jitted JAX on
    the CPU folds 60 - t + (-30) into 30 - t and fuses the multiply into
    one FMA there: within one float32 ulp of 60, the sum's largest term."""
    xx = np.concatenate([np.arange(601), rng.uniform(0, 600, 399)]
                        ).astype(np.float32)
    yy = rng.permutation(xx)
    got = TG.bv_to_lidar_coords(_t(xx), _t(yy))
    for p, r in zip(got, G.bv_to_lidar_coords(xx, yy)):
        _equal(p, r)
    for p, r in zip(got, jax.jit(G.bv_to_lidar_coords)(xx, yy)):
        assert np.abs(_n(p) - np.asarray(r)).max() <= np.spacing(
            np.float32(60))


def test_lidar_to_bv_keeps_the_batch_column(rng):
    rois = np.concatenate([rng.randint(0, 4, (500, 1)).astype(np.float32),
                           _boxes(rng, 500)], 1)
    got = TG.lidar_to_bv(_t(rois))
    _equal(got, jax.jit(G.lidar_to_bv)(rois))
    _equal(got[:, 0], rois[:, 0])


def test_lidar_cnr_to_3d(rng):
    boxes = _boxes(rng, 64)
    cnr = np.asarray(G.lidar_3d_to_corners(boxes))
    cnr = cnr + rng.uniform(-0.2, 0.2, cnr.shape).astype(np.float32)
    got = TG.lidar_cnr_to_3d(_t(cnr), _t(boxes[:, 3:6]))
    _within(got, jax.jit(G.lidar_cnr_to_3d)(cnr, boxes[:, 3:6]))
    _equal(got[:, 3:], boxes[:, 3:])


@pytest.mark.parametrize("ry", [0.0, np.pi / 2, -2.3, 0.7])
def test_compute_corners_3d(rng, ry):
    box = np.array([rng.uniform(-10, 10), rng.uniform(0, 2),
                    rng.uniform(5, 40), 4.0, 1.6, 1.5], np.float32)
    got = TG.compute_corners_3d(_t(box), ry)
    assert got.shape == (3, 8)
    _within(got, jax.jit(G.compute_corners_3d)(box, ry))
    _within(TG.compute_corners_3d(_t(box), torch.tensor(ry)), got.numpy())


def test_legacy_inverse_rt():
    for tr in (TR, _example_calib()[3].reshape(3, 4)):
        got = TG._legacy_inverse_rt(_t(tr.reshape(-1)))
        want = np.asarray(jax.jit(G._legacy_inverse_rt)(tr))
        _within(got[:, :3], want[:, :3])
        _equal(got[:, 3], want[:, 3])     # the permuted, negated T


def test_camera_to_lidar_cnr(rng):
    one = rng.uniform(-20, 20, (3, 8)).astype(np.float32)
    many = rng.uniform(-20, 20, (50, 24)).astype(np.float32)
    f = jax.jit(G.camera_to_lidar_cnr)
    got = TG.camera_to_lidar_cnr(_t(one), _t(TR))
    assert got.shape == (1, 24)
    _within(got, f(one, TR))
    _within(TG.camera_to_lidar_cnr(_t(many), _t(TR)), f(many, TR))


def test_cam_to_lidar_3d(rng):
    pts = np.concatenate([rng.uniform(-20, 40, (50, 3)),
                          rng.uniform(1, 5, (50, 3))], 1).astype(np.float32)
    got = TG.cam_to_lidar_3d(_t(pts), _t(TR))
    want = np.asarray(jax.jit(G.cam_to_lidar_3d)(pts, TR))
    _within(got[:, :3], want[:, :3])
    _equal(got[:, 3:], want[:, 3:])


def test_project_to_image(rng):
    pts = np.stack([rng.uniform(-10, 10, 200), rng.uniform(-2, 2, 200),
                    rng.uniform(5, 60, 200)]).astype(np.float32)
    got = TG.project_to_image(_t(pts), _t(P2.reshape(-1)))
    assert got.shape == (2, 200)
    _within(got, jax.jit(G.project_to_image)(pts, P2))


def _corners(rng, n):
    return np.asarray(G.lidar_3d_to_corners(_boxes(rng, n)))


@pytest.mark.parametrize("batched", [False, True])
def test_lidar_cnr_to_img_legacy_int_switch(rng, batched):
    """legacy_int=False: the untruncated boxes within 1e-5 of the max;
    True: the truncated ones equal but where JAX's value was within 1e-3
    of an integer."""
    cnr = _corners(rng, 256)
    args = (_t(TR.reshape(-1)), _t(R0_ROW), _t(P2.reshape(-1)))
    if batched:
        cnr_t = torch.stack([_t(cnr)] * 2)
        args = tuple(torch.stack([a, a]) for a in args)
    else:
        cnr_t = _t(cnr)
    f = jax.jit(G.lidar_cnr_to_img, static_argnames="legacy_int")
    raw = np.asarray(f(cnr, TR, R0_ROW, P2, legacy_int=False))
    got = TG.lidar_cnr_to_img(cnr_t, *args, legacy_int=False)
    trunc = TG.lidar_cnr_to_img(cnr_t, *args)
    if batched:
        assert torch.equal(got[0], got[1]) and got.shape == (2, 256, 4)
        got, trunc = got[0], trunc[0]
    _within(got, raw)
    diff = np.abs(_n(trunc) - np.asarray(f(cnr, TR, R0_ROW, P2)))
    near_int = np.abs(raw - np.round(raw)) < 1e-3
    assert np.all(diff[~near_int] == 0) and np.all(diff <= 1)
    # a raw 3x3 R0 (9 entries) gets the calib blob's zero row
    _within(TG.lidar_cnr_to_img(_t(cnr), args[0].reshape(-1, 12)[0],
                                _t(R0.reshape(-1)),
                                args[2].reshape(-1, 12)[0], legacy_int=False),
            raw)


@pytest.mark.parametrize("batched", [False, True])
def test_lidar_cnr_to_img_full(rng, batched):
    cnr = _corners(rng, 128)
    want = np.asarray(jax.jit(G.lidar_cnr_to_img_full)(cnr, TR, R0_ROW, P2))
    args = [_t(TR.reshape(-1)), _t(R0_ROW), _t(P2.reshape(-1))]
    if batched:
        got = TG.lidar_cnr_to_img_full(torch.stack([_t(cnr)] * 3),
                                       *(torch.stack([a] * 3) for a in args))
        assert got.shape == (3, 128, 4) and torch.equal(got[0], got[2])
        got = got[0]
    else:
        got = TG.lidar_cnr_to_img_full(_t(cnr), *args)
    _within(got, want)
    legacy = np.asarray(G.lidar_cnr_to_img(cnr, TR, R0_ROW, P2,
                                           legacy_int=False))
    assert np.abs(_n(got) - legacy).max() > 0.5   # translations kept


def test_bbox_transform_cnr(rng):
    ex = _corners(rng, 64)
    gt = ex + rng.uniform(-1, 1, ex.shape).astype(np.float32)
    got = TG.bbox_transform_cnr(_t(ex), _t(gt))
    want = np.asarray(jax.jit(G.bbox_transform_cnr)(ex, gt))
    np.testing.assert_allclose(_n(got), want, rtol=1e-6, atol=0)
    back = TG.bbox_transform_inv_cnr(_t(ex), got)
    _within(back, G.bbox_transform_inv_cnr(ex, want))
