"""The port's geometry and anchor grid against mv3d_tf_tpu on the same
numpy inputs: float32 functions at rtol 1e-6, the anchor tables bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _example_calib  # noqa: E402

from mv3d_tf_tpu import anchors as A  # noqa: E402
from mv3d_tf_tpu import geometry as G  # noqa: E402
from mv3d_tf_tpu_torch import anchors as TA  # noqa: E402
from mv3d_tf_tpu_torch import geometry as TG  # noqa: E402

RTOL = 1e-6   # float32 ops in the same order; a sum may round 1 ulp apart


def _boxes(rng, n):
    """(n,6) lidar boxes [x,y,z,l,w,h] in front of the car."""
    return np.stack([rng.uniform(5, 60, n), rng.uniform(-30, 30, n),
                     rng.uniform(-2, 0, n), rng.uniform(1, 5, n),
                     rng.uniform(0.5, 2.5, n), rng.uniform(1, 2, n)],
                    1).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=0)


def test_box_transforms_match_jax(rng):
    boxes = _boxes(rng, 64)
    deltas = (rng.randn(64, 12) * 0.2).astype(np.float32)
    _close(TG.lidar_3d_to_bv(_t(boxes)), G.lidar_3d_to_bv(boxes))
    cnr = G.lidar_3d_to_corners(boxes)
    _close(TG.lidar_3d_to_corners(_t(boxes)), cnr)
    cnr2 = np.concatenate([np.asarray(cnr)] * 2, 1)
    _close(TG.corners_to_bv(_t(cnr2)), G.corners_to_bv(cnr2))
    _close(TG.bbox_transform_inv_3d(_t(boxes), _t(deltas)),
           G.bbox_transform_inv_3d(boxes, deltas))
    _close(TG.corner_diag(_t(np.asarray(cnr))), G.corner_diag(cnr))
    cdeltas = (rng.randn(64, 48) * 0.1).astype(np.float32)
    _close(TG.bbox_transform_inv_cnr(_t(np.asarray(cnr)), _t(cdeltas)),
           G.bbox_transform_inv_cnr(cnr, cdeltas))
    wide = (rng.randn(64, 8) * 400 + 300).astype(np.float32)
    _close(TG.clip_boxes(_t(wide), (601, 601)), G.clip_boxes(wide, (601, 601)))
    x, y = boxes[:, 0], boxes[:, 1]
    for p, r in zip(TG.lidar_to_bv_coord(_t(x), _t(y)),
                    G.lidar_to_bv_coord(x, y)):
        _close(p, r)


@pytest.mark.parametrize("batched", [False, True])
def test_lidar_cnr_to_img_matches_jax(rng, batched):
    """Truncated image boxes agree exactly, except that a value JAX had
    within 1e-3 of an integer before truncation may land 1 apart."""
    calib = _example_calib()
    cnr = np.asarray(G.lidar_3d_to_corners(_boxes(rng, 256)))
    ref = np.asarray(G.lidar_cnr_to_img(cnr, calib[3], calib[2], calib[0]))
    raw = np.asarray(G.lidar_cnr_to_img(cnr, calib[3], calib[2], calib[0],
                                        legacy_int=False))
    c = _t(calib)
    if batched:   # frames as a leading dim, one calib row set per frame
        c2 = torch.stack([c, c])
        got = TG.lidar_cnr_to_img(torch.stack([_t(cnr)] * 2), c2[:, 3],
                                  c2[:, 2], c2[:, 0])
        assert got.shape == (2, 256, 4)
        assert torch.equal(got[0], got[1])
        got = got[0]
    else:
        got = TG.lidar_cnr_to_img(_t(cnr), c[3], c[2], c[0])
    diff = np.abs(got.numpy() - ref)
    near_int = np.abs(raw - np.round(raw)) < 1e-3
    assert np.all(diff[~near_int] == 0)
    assert np.all(diff <= 1)


def test_anchor_grid_bit_identical():
    for shape in ((10, 10), (75, 75), (7, 12)):
        ref = A.get_anchor_grid(*shape)
        got = TA.get_anchor_grid(*shape)
        np.testing.assert_array_equal(got.base, ref.base)
        np.testing.assert_array_equal(got.anchors_bv, ref.anchors_bv)
        np.testing.assert_array_equal(got.anchors_3d, ref.anchors_3d)
        np.testing.assert_array_equal(got.inside, ref.inside)
        assert got.anchors_3d.dtype == ref.anchors_3d.dtype == np.float32
        assert (got.num_anchors, got.total) == (ref.num_anchors, ref.total)


def test_bev_constants_match():
    for name in ("TOP_X_MAX", "TOP_X_MIN", "TOP_Y_MIN", "TOP_Y_MAX", "RES",
                 "Xn", "Yn", "BEV_H", "BEV_W", "BEV_C", "LIDAR_HEIGHT",
                 "CAR_HEIGHT"):
        assert getattr(TG, name) == getattr(G, name), name
    assert jnp.float32(TG.RES) == jnp.float32(G.RES)
