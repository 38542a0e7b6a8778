"""The port's train-path geometry, IoU and target layers against
mv3d_tf_tpu on CPU, with JAX's own uniforms injected into the port: IoU
bit for bit on integer-pixel boxes, labels and slots exactly, targets
within float32 rounding."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _example_calib  # noqa: E402
from mv3d_tf_tpu import geometry as G  # noqa: E402
from mv3d_tf_tpu import targets as JT  # noqa: E402
from mv3d_tf_tpu.anchors import get_anchor_grid  # noqa: E402
from mv3d_tf_tpu.ops.iou import bbox_overlaps  # noqa: E402
from mv3d_tf_tpu_torch import geometry as TG  # noqa: E402
from mv3d_tf_tpu_torch import targets as TT  # noqa: E402
from mv3d_tf_tpu_torch.ops.iou import bbox_overlaps as t_overlaps  # noqa: E402

MAX_GT = 8


def _t(a):
    return torch.tensor(np.asarray(a))


def _cars(rng, n):
    """n padded gt rows (MAX_GT) of cars in BEV range, built from lidar
    boxes with the pad_gt convention (data/loader.py:40-66)."""
    box = np.stack([rng.uniform(8, 52, n), rng.uniform(-25, 25, n),
                    np.full(n, -0.95), rng.uniform(3.5, 4.5, n),
                    rng.uniform(1.5, 1.9, n), rng.uniform(1.4, 1.7, n)],
                   1).astype(np.float32)
    bv = np.zeros((MAX_GT, 5), np.float32)
    b3 = np.zeros((MAX_GT, 7), np.float32)
    b3[:, 3:6] = 1.0
    cnr = np.zeros((MAX_GT, 25), np.float32)
    bv[:n, :4] = np.asarray(G.lidar_3d_to_bv(box))
    b3[:n, :6] = box
    cnr[:n, :24] = np.asarray(G.lidar_3d_to_corners(box))
    bv[:n, 4] = b3[:n, 6] = cnr[:n, 24] = 1.0
    valid = np.arange(MAX_GT) < n
    return bv, b3, cnr, valid


def _uniforms(key, n):
    """The two uniforms a JAX target layer draws from its key."""
    k_fg, k_bg = jax.random.split(key)
    return (np.asarray(jax.random.uniform(k_fg, (n,))),
            np.asarray(jax.random.uniform(k_bg, (n,))))


def test_bbox_overlaps_and_transform_3d_match_jax(rng):
    grid = get_anchor_grid(20, 20)
    gt_bv, gt_3d, _, _ = _cars(rng, 6)
    ref = np.asarray(bbox_overlaps(grid.anchors_bv, gt_bv[:, :4]))
    got = t_overlaps(_t(grid.anchors_bv), _t(gt_bv[:, :4])).numpy()
    assert (ref > 0).sum() > 20
    np.testing.assert_array_equal(got, ref)         # integer boxes: exact

    ex = grid.anchors_3d[:64]
    gt = np.tile(gt_3d[:4, :6], (16, 1))
    np.testing.assert_allclose(TG.bbox_transform_3d(_t(ex), _t(gt)).numpy(),
                               np.asarray(G.bbox_transform_3d(ex, gt)),
                               rtol=1e-6, atol=0)
    anchors = grid.anchors_bv[:64]
    np.testing.assert_allclose(TG.bv_anchor_to_lidar(_t(anchors)).numpy(),
                               np.asarray(G.bv_anchor_to_lidar(anchors)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("traced_k", [False, True])
def test_sample_mask_matches_jax(traced_k):
    n = 300
    key = jax.random.PRNGKey(5)
    cand = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(6), 0.3, (n,)))
    u = np.asarray(jax.random.uniform(key, (n,)))
    if traced_k:
        ref = jax.jit(JT._sample_mask)(key, jnp.asarray(cand), jnp.int32(40))
        k = torch.tensor(40)
    else:
        ref = JT._sample_mask(key, jnp.asarray(cand), 40)
        k = 40
    got = TT._sample_mask(_t(u), _t(cand), k)
    assert got.sum() == 40
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # fewer candidates than k: all of them
    few = cand & (np.arange(n) < 60)
    got = TT._sample_mask(_t(u), _t(few), k)
    np.testing.assert_array_equal(got.numpy(), few)


@pytest.mark.parametrize("feat", [10, 75])
def test_anchor_target_layer_matches_jax(rng, feat):
    gt_bv, gt_3d, _, gt_valid = _cars(rng, 5)
    if feat == 10:    # gts must overlap the 80x80 px anchor field
        grid = get_anchor_grid(feat, feat)
        inside = np.where(grid.inside)[0]
        gt_bv[:2, :4] = grid.anchors_bv[inside[[40, 200]]]
        gt_bv[2:, :] = 0
        gt_valid = np.arange(MAX_GT) < 2
        gt_3d[:2, :6] = np.asarray(G.bv_anchor_to_lidar(gt_bv[:2, :4]))
    key = jax.random.PRNGKey(11)
    ref_labels, ref_tgt = JT.anchor_target_layer(key, gt_bv, gt_valid, gt_3d,
                                                 feat, feat)
    u_fg, u_bg = _uniforms(key, feat * feat * 4)
    labels, tgt = TT.anchor_target_layer(_t(u_fg), _t(u_bg), _t(gt_bv),
                                         _t(gt_valid), _t(gt_3d), feat, feat)
    ref_labels = np.asarray(ref_labels)
    assert labels.dtype == torch.int32
    assert (ref_labels == 1).sum() > 0 and (ref_labels == 0).sum() > 0
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    # atol: the size targets log(l_gt / l_anchor) take log of ratios near
    # 1, where XLA's float32 log on the CPU is accurate to ~1.2e-7 absolute
    # (two ulps of 1), not relative
    np.testing.assert_allclose(tgt.numpy(), np.asarray(ref_tgt), rtol=1e-6,
                               atol=2e-7)


def test_proposal_target_layer_matches_jax(rng):
    """Proposals: jittered gts (fg), near misses, far boxes (bg), invalid
    slots; gt padding; fg quota 8 of 32 rois binding."""
    gt_bv, gt_3d, gt_cnr, gt_valid = _cars(rng, 3)
    n = 60
    src = gt_bv[np.arange(n) % 3, :4]
    shift = np.where((np.arange(n) < 24)[:, None],
                     rng.randint(-2, 3, (n, 4)),
                     rng.randint(-12, 13, (n, 4)) + (np.arange(n) >= 45)[:, None] * 80)
    props_bv = np.zeros((n, 5), np.float32)
    props_bv[:, 1:] = src + shift
    props_3d = np.zeros((n, 7), np.float32)
    props_3d[:, 1:] = np.asarray(G.bv_anchor_to_lidar(props_bv[:, 1:]))
    valid = rng.rand(n) > 0.15
    calib = _example_calib()
    key = jax.random.PRNGKey(4)
    ref = JT.proposal_target_layer_3d(key, props_bv, props_3d, valid, gt_bv,
                                      gt_valid, gt_3d, gt_cnr, calib,
                                      rois_per_image=32)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    u_fg, u_bg = _uniforms(key, n + MAX_GT)
    got = TT.proposal_target_layer_3d(
        _t(u_fg), _t(u_bg), _t(props_bv), _t(props_3d), _t(valid), _t(gt_bv),
        _t(gt_valid), _t(gt_3d), _t(gt_cnr), _t(calib), rois_per_image=32)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(ref)
    assert int(ref["num_fg"]) == 8 and 8 < ref["valid"].sum() < 32
    for key in ("labels", "valid", "num_fg", "rois_bv", "rois_3d"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_allclose(got["bbox_targets"], ref["bbox_targets"],
                               rtol=0, atol=1e-5)
    # image boxes: exact, except that a value JAX had within 1e-3 of an
    # integer before truncation may land 1 apart (test_torch_geometry.py)
    # (rows past the sample project a zero box: 0/0, NaN in both)
    v = ref["valid"]
    np.testing.assert_array_equal(np.isnan(got["rois_img"]),
                                  np.isnan(ref["rois_img"]))
    cnr = G.lidar_3d_to_corners(ref["rois_3d"][v, 1:])
    raw = np.asarray(G.lidar_cnr_to_img(cnr, calib[3], calib[2], calib[0],
                                        legacy_int=False))
    near_int = np.abs(raw - np.round(raw)) < 1e-3
    diff = np.abs(got["rois_img"] - ref["rois_img"])[v, 1:]
    assert np.all(diff[~near_int] == 0) and np.all(diff <= 1)
    assert not got["rois_img"][v, 0].any()
