"""The port's legacy 2D Faster R-CNN stages against mv3d_tf_tpu's on CPU in
float32: anchors, 2D box transforms, nms_matrix and nms_new_np, the VGG16
trunk, RPN and head, the proposal layer and im_detect, both target layers
on JAX's rebuilt draws, the 4-term loss, one momentum-SGD train step and
the snapshot unnormalization. Parameters are He-scaled (utils.weights.
he_normal_params_2d with fc 64), the same numpy arrays in both packages.

Tolerances: bit for bit where JAX is integer-exact, a selection, a max or
an exact copy (anchors, keep sets, labels, sampled rois, weights, nms);
float32 tolerance where the two packages round convolutions, exp/log and
sums in another order (stated per test)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mv3d_tf_tpu import anchors as JA  # noqa: E402
from mv3d_tf_tpu import faster_rcnn_2d as J2  # noqa: E402
from mv3d_tf_tpu import geometry as JG  # noqa: E402
from mv3d_tf_tpu.models import vggnet as JV  # noqa: E402
from mv3d_tf_tpu.models.mv3d import rpn_probs as j_rpn_probs  # noqa: E402
from mv3d_tf_tpu.ops import nms as JN  # noqa: E402
from mv3d_tf_tpu_torch import anchors as TA  # noqa: E402
from mv3d_tf_tpu_torch import faster_rcnn_2d as T2  # noqa: E402
from mv3d_tf_tpu_torch import geometry as TG  # noqa: E402
from mv3d_tf_tpu_torch.models import mv3d as TM  # noqa: E402
from mv3d_tf_tpu_torch.models import vggnet as TV  # noqa: E402
from mv3d_tf_tpu_torch.ops import nms as TN  # noqa: E402
from mv3d_tf_tpu_torch.utils.weights import (he_normal_params_2d,  # noqa: E402
                                             params_from_jax, params_to_jax)

FC = 64
H = W = 6                    # a 96x96 input at stride 16
MAX_GT = 4


def _t(a):
    return torch.tensor(np.asarray(a))


def _n(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


@pytest.fixture(scope="module")
def np_params():
    return he_normal_params_2d(5, fc_dim=FC)


@pytest.fixture(scope="module")
def params(np_params):
    return params_from_jax(np_params, device="cpu")


def _image(seed, hw):
    rng = np.random.RandomState(seed)
    return (rng.rand(hw[0], hw[1], 3) * 255 - 128).astype(np.float32)


def _gt(boxes):
    gt = np.zeros((MAX_GT, 5), np.float32)
    gt[:len(boxes)] = boxes
    return gt, np.arange(MAX_GT) < len(boxes)


def test_generate_anchors_and_grid_bit_for_bit():
    np.testing.assert_array_equal(TA.generate_anchors(),
                                  JA.generate_anchors())
    np.testing.assert_array_equal(T2.get_anchor_grid_2d(H, W + 3),
                                  J2.get_anchor_grid_2d(H, W + 3))


def test_bbox_transform_and_inverse(rng):
    """Float ops in another fusion (XLA may contract a*b+c); 2e-6 relative
    on the targets, 1e-4 px on decoded boxes of ~100 px."""
    ex = np.sort(rng.rand(50, 4).astype(np.float32) * 200, axis=0)
    ex = np.concatenate([np.minimum(ex[:, :2], ex[:, 2:]),
                         np.maximum(ex[:, :2], ex[:, 2:])], 1)
    gt = ex + rng.randn(50, 4).astype(np.float32) * 8
    gt[:, 2:] = np.maximum(gt[:, 2:], gt[:, :2] + 1)
    np.testing.assert_allclose(_n(TG.bbox_transform(_t(ex), _t(gt))),
                               np.asarray(JG.bbox_transform(ex, gt)),
                               rtol=2e-6, atol=1e-7)
    deltas = rng.randn(50, 12).astype(np.float32) * 0.3
    np.testing.assert_allclose(_n(TG.bbox_transform_inv(_t(ex), _t(deltas))),
                               np.asarray(JG.bbox_transform_inv(ex, deltas)),
                               rtol=0, atol=1e-4)
    # clip_boxes with a tensor im_info equals JAX's with traced values
    info = np.array([120.0, 150.0, 1.0], np.float32)
    got = TG.clip_boxes(TG.bbox_transform_inv(_t(ex), _t(deltas)),
                        (_t(info)[0], _t(info)[1]))
    want = jax.jit(lambda b, i: JG.clip_boxes(b, (i[0], i[1])))(
        JG.bbox_transform_inv(ex, deltas), info)
    np.testing.assert_allclose(_n(got), np.asarray(want), rtol=0, atol=1e-4)
    assert float(got[..., 0::2].max()) <= 149 and float(got.min()) >= 0


def _chain_boxes(rng, n=120, chain=24):
    """n boxes whose first `chain`, in score order, each overlap the next
    at IoU ~0.8: greedy keeps every other one, and a fixpoint needs many
    rounds; the rest are random, some invalid."""
    boxes = np.zeros((n, 4), np.float32)
    k = np.arange(chain, dtype=np.float32)
    boxes[:chain] = np.stack([k * 6, k * 0, k * 6 + 59, k * 0 + 59], 1)
    xy = rng.rand(n - chain, 2).astype(np.float32) * 300
    wh = rng.rand(n - chain, 2).astype(np.float32) * 80 + 10
    boxes[chain:] = np.concatenate([xy, xy + wh], 1)
    scores = np.concatenate([np.linspace(1.0, 0.9, chain),
                             rng.rand(n - chain) * 0.8]).astype(np.float32)
    valid = rng.rand(n) > 0.1
    valid[:chain] = True
    return boxes, scores, valid


@pytest.mark.parametrize("max_out", [8, 60])
def test_nms_matrix_matches_jax_and_greedy(rng, max_out):
    """Keep slots and validity bit for bit against JAX's nms_matrix and the
    port's greedy loop, on a 24-box suppression chain among random boxes
    (ties in score included)."""
    boxes, scores, valid = _chain_boxes(rng)
    scores[30:34] = scores[30]                     # score ties
    got_idx, got_val = TN.nms_matrix(_t(boxes), _t(scores), _t(valid),
                                     max_out, 0.7)
    j_idx, j_val = JN.nms_matrix(boxes, scores, valid, max_out, 0.7)
    np.testing.assert_array_equal(_n(got_val), np.asarray(j_val))
    np.testing.assert_array_equal(_n(got_idx), np.asarray(j_idx))
    g_idx, g_val = TN.nms(_t(boxes), _t(scores), _t(valid), max_out, 0.7)
    np.testing.assert_array_equal(_n(got_val), _n(g_val))
    np.testing.assert_array_equal(_n(got_idx)[_n(got_val)],
                                  _n(g_idx)[_n(g_val)])
    # the chain keeps every other box
    kept = set(_n(got_idx)[_n(got_val)].tolist())
    assert {0, 2, 4}.issubset(kept) and not {1, 3, 5} & kept


def test_nms_new_np_matches_jax(rng):
    boxes, scores, _ = _chain_boxes(rng, n=80, chain=10)
    # near-containment pairs: a box inside a slightly larger one
    boxes[70:75] = boxes[10:15] + np.array([2, 2, -2, -2], np.float32)
    dets = np.hstack([boxes, scores[:, None]]).astype(np.float32)
    for thresh in (0.3, 0.7):
        assert TN.nms_new_np(dets, thresh) == JN.nms_new_np(dets, thresh)
    assert TN.nms_new_np(dets, 0.99) != TN.nms_np(dets, 0.99)


def test_trunk_rpn_and_head_match_jax(np_params, params):
    """conv5_3, the RPN scores and deltas, and the test-mode head: float32
    convs summed in another order, 1e-4 relative to each output's max."""
    x = _image(1, (96, 128))[None]
    c5 = TV.trunk_apply_2d(params, _t(x))
    j5 = JV.trunk_apply_2d(np_params, x)
    assert c5.shape == (1, 6, 8, 512)

    def close(a, b):
        b = np.asarray(b)
        assert np.abs(_n(a) - b).max() <= 1e-4 * np.abs(b).max()

    close(c5, j5)
    for a, b in zip(TV.rpn_head_2d(params, c5),
                    JV.rpn_head_2d(np_params, j5)):
        close(a, b)
    pooled = np.random.RandomState(2).rand(10, 7, 7, 512).astype(np.float32)
    for a, b in zip(TV.head_2d(params, _t(pooled)),
                    JV.head_2d(np_params, pooled)):
        close(a, b)


def test_head_train_mode_matches_jax(np_params, params):
    """Dropout on JAX's two bernoulli masks from the head's key."""
    pooled = np.random.RandomState(3).rand(12, 7, 7, 512).astype(np.float32)
    key = jax.random.PRNGKey(4)
    masks = [_t(jax.random.bernoulli(k, 0.5, (12, FC)))
             for k in jax.random.split(key)]
    got = TV.head_2d(params, _t(pooled), train=True, masks=masks,
                     keep_prob=0.5)
    want = JV.head_2d(np_params, pooled, keep_prob=0.5, rng=key, train=True)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.abs(_n(a) - b).max() <= 1e-4 * np.abs(b).max()


def _rpn_outputs(seed, h, w):
    rng = np.random.RandomState(seed)
    prob = np.asarray(j_rpn_probs(rng.randn(1, h, w, 18).astype(np.float32)))
    deltas = (rng.randn(1, h, w, 36) * 0.2).astype(np.float32)
    return prob, deltas


def test_proposal_layer_2d_matches_jax():
    """Keep validity and the order of kept proposals bit for bit (scores
    too: a gather); roi corners within 1e-4 px (decode rounding)."""
    prob, deltas = _rpn_outputs(6, 16, 16)
    info = np.array([250.0, 256.0, 1.2], np.float32)
    kw = dict(pre_nms_top_n=600, post_nms_top_n=400)
    rois, scores, valid = T2.proposal_layer_2d(_t(prob), _t(deltas),
                                               _t(info), 16, 16, **kw)
    j_rois, j_scores, j_valid = J2.proposal_layer_2d(prob, deltas, info,
                                                     16, 16, **kw)
    np.testing.assert_array_equal(_n(valid), np.asarray(j_valid))
    np.testing.assert_array_equal(_n(scores), np.asarray(j_scores))
    np.testing.assert_allclose(_n(rois), np.asarray(j_rois), rtol=0,
                               atol=1e-4)
    assert 20 < int(valid.sum()) < 400


def test_im_detect_2d_matches_jax(np_params, params):
    """The whole detector on a 96x96 image: the keep set bit for bit, rois
    within 1e-2 px and scores/boxes within 1e-3 relative (the float32
    convs' rounding amplified by exp in the decode)."""
    image = _image(7, (96, 96))
    info = np.array([90.0, 96.0, 1.0], np.float32)
    kw = dict(pre_nms_top_n=200, post_nms_top_n=30)
    got = T2.build_im_detect_2d(H, W, **kw)(params, image, info)
    want = J2.build_im_detect_2d(H, W, **kw)(np_params, image, info)
    np.testing.assert_array_equal(_n(got["valid"]), np.asarray(want["valid"]))
    assert int(got["valid"].sum()) >= 4
    np.testing.assert_allclose(_n(got["rois"]), np.asarray(want["rois"]),
                               rtol=0, atol=1e-2)
    for k in ("scores", "boxes"):
        b = np.asarray(want[k])
        assert np.abs(_n(got[k]) - b).max() <= 1e-3 * np.abs(b).max(), k


def _split_uniforms(key, n):
    return [_t(jax.random.uniform(k, (n,))) for k in jax.random.split(key)]


def test_anchor_target_layer_2d_matches_jax():
    """A 16x16 grid (256x240 image extent, strict '<'): labels bit for bit
    on JAX's uniforms, targets within 2e-6 relative."""
    gt, gv = _gt([[20, 30, 150, 140, 7], [100, 60, 230, 200, 15],
                  [5, 5, 60, 90, 3]])
    info = np.array([240.0, 256.0, 1.0], np.float32)
    key = jax.random.PRNGKey(11)
    u_fg, u_bg = _split_uniforms(key, 16 * 16 * 9)
    labels, targets = T2.anchor_target_layer_2d(u_fg, u_bg, _t(gt), _t(gv),
                                                _t(info), 16, 16)
    j_labels, j_targets = J2.anchor_target_layer_2d(key, gt, gv, info,
                                                    16, 16)
    np.testing.assert_array_equal(_n(labels), np.asarray(j_labels))
    np.testing.assert_allclose(_n(targets), np.asarray(j_targets),
                               rtol=2e-6, atol=1e-6)
    assert int((labels == 1).sum()) >= 3 and int((labels == 0).sum()) >= 10


@pytest.mark.parametrize("normalize", [False, True])
def test_proposal_target_layer_2d_matches_jax(normalize):
    """One fg and one bg uniform vector, each used for the sample and the
    slot order: sampled rois, labels, weights, valid and num_fg bit for
    bit; targets within 1e-6 relative (XLA may divide by the stds as a
    reciprocal multiply)."""
    rng = np.random.RandomState(12)
    gt, gv = _gt([[20, 30, 150, 140, 7], [100, 60, 230, 200, 15]])
    n = 60
    xy = rng.rand(n, 2).astype(np.float32) * 180
    rois = np.concatenate([np.zeros((n, 1), np.float32), xy,
                           xy + rng.rand(n, 2).astype(np.float32) * 120 + 20],
                          1).astype(np.float32)
    rois[:10, 1:] = gt[[0, 1] * 5, :4] + rng.randn(10, 4).astype(
        np.float32) * 6
    valid = rng.rand(n) > 0.2
    key = jax.random.PRNGKey(13)
    u_fg, u_bg = _split_uniforms(key, n + MAX_GT)
    got = T2.proposal_target_layer_2d(u_fg, u_bg, _t(rois), _t(valid),
                                      _t(gt), _t(gv), rois_per_image=32,
                                      bbox_normalize=normalize)
    want = J2.proposal_target_layer_2d(key, rois, valid, gt, gv,
                                       rois_per_image=32,
                                       bbox_normalize=normalize)
    for k in ("rois", "labels", "bbox_inside_weights",
              "bbox_outside_weights", "valid", "num_fg"):
        np.testing.assert_array_equal(_n(got[k]), np.asarray(want[k]), k)
    np.testing.assert_allclose(_n(got["bbox_targets"]),
                               np.asarray(want["bbox_targets"]),
                               rtol=1e-6, atol=1e-6)
    assert 0 < int(got["num_fg"]) < int(got["valid"].sum())


def test_compute_losses_2d_matches_jax():
    """Random scores, deltas, labels and weights; 1e-6 relative."""
    rng = np.random.RandomState(14)
    na, nr, k = 6 * 6 * 9, 16, 21
    inputs = dict(
        rpn_cls_score=rng.randn(1, 6, 6, 18).astype(np.float32),
        rpn_bbox_pred=rng.randn(1, 6, 6, 36).astype(np.float32),
        rpn_labels=rng.randint(-1, 2, na).astype(np.int32),
        rpn_bbox_targets=rng.randn(na, 4).astype(np.float32),
        cls_score=rng.randn(nr, k).astype(np.float32),
        bbox_pred=rng.randn(nr, 4 * k).astype(np.float32),
        roi_labels=rng.randint(0, k, nr).astype(np.int32),
        roi_bbox_targets=rng.randn(nr, 4 * k).astype(np.float32),
        bbox_inside_weights=(rng.rand(nr, 4 * k) > 0.9).astype(np.float32),
        bbox_outside_weights=(rng.rand(nr, 4 * k) > 0.5).astype(np.float32),
        roi_valid=rng.rand(nr) > 0.3)
    got = T2.compute_losses_2d(**{a: _t(v) for a, v in inputs.items()})
    want = J2.compute_losses_2d(**inputs)
    for key, v in want.items():
        assert float(got[key]) == pytest.approx(float(v), rel=1e-6), key


def _train_batch():
    image = _image(15, (192, 192))
    gt, gv = _gt([[20, 30, 150, 140, 7], [60, 40, 180, 170, 15]])
    return {"image": image, "im_info": np.array([192, 180, 1.0], np.float32),
            "gt_boxes": gt, "gt_valid": gv}


TRAIN_KW = dict(rois_per_image=16, pre_nms_top_n=300, post_nms_top_n=40)


def _jax_draws_2d(key, n_anchors, n_all, n_rois, fc, keep_prob=0.5):
    """The draws JAX's 2D step makes from its key: split(key, 3) -> anchor,
    roi, drop (faster_rcnn_2d.py:276); each target layer splits its key
    into fg and bg uniforms; the head splits its key into two bernoulli
    masks (vggnet.py:73-77)."""
    k_anchor, k_roi, k_drop = jax.random.split(key, 3)
    a_fg, a_bg = _split_uniforms(k_anchor, n_anchors)
    r_fg, r_bg = _split_uniforms(k_roi, n_all)
    drop = tuple(_t(jax.random.bernoulli(k, keep_prob, (n_rois, fc)))
                 for k in jax.random.split(k_drop))
    return {"anchor_fg": a_fg, "anchor_bg": a_bg, "roi_fg": r_fg,
            "roi_bg": r_bg, "drop": drop}


def test_train_step_matches_jax(np_params):
    """One step at 192x192 (12x12 grid) from the same params on JAX's
    draws. Compared: the four losses within 2e-6 relative (the RPN terms
    non-zero); frozen conv1/conv2 unchanged bit for bit in both packages;
    each trained layer's update and momentum (the first step's gradient)
    against JAX's: the RPN and fc layers elementwise within 1e-4 of the
    largest |JAX value| (float32 sums in another order), the trunk convs
    within 1e-2 in relative norm (a pre-activation within rounding of 0
    flips its ReLU in one package and not the other, which moves the
    gradient of the layers below it at those cells). No tie rule shows: the
    maps are float32 from random weights, and a tie at a ReLU zero passes
    no gradient in either package.
    """
    key = jax.random.PRNGKey(16)
    batch = _train_batch()
    step_j, tx = J2.build_train_step_2d(12, 12, **TRAIN_KW)
    jp = jax.tree.map(jnp.asarray, np_params)
    jp, js, mj = step_j(jp, tx.init(jp), batch, key)

    params = params_from_jax(np_params, device="cpu")
    step_t, make_opt = T2.build_train_step_2d(12, 12, **TRAIN_KW)
    opt, sched = make_opt(params)
    n_all = TRAIN_KW["post_nms_top_n"] + MAX_GT
    mt = step_t(params, opt, sched, batch,
                _jax_draws_2d(key, 12 * 12 * 9, n_all, 16, FC))
    for name, v in mj.items():
        assert float(mt[name]) == pytest.approx(float(v), rel=2e-6,
                                                abs=1e-7), name
    assert float(mt["rpn_cross_entropy"]) > 0
    assert float(mt["rpn_loss_box"]) > 0
    after = params_to_jax(params)
    trace = js[0].trace
    for name, sub in after.items():
        layer = params[name.replace("/", "__")]
        for s, a in sub.items():
            b = np.asarray(jp[name][s])
            start = np_params[name][s]
            if name in TV.FROZEN_2D:
                np.testing.assert_array_equal(a, start)
                np.testing.assert_array_equal(b, start)
                assert not layer.weight.requires_grad
                continue
            buf = opt.state[layer.weight if s == "weights" else layer.bias][
                "momentum_buffer"]
            buf = params_to_jax(torch.nn.ModuleDict({"x": _as_layer(
                layer, buf, s)}))["x"][s]
            for got, want in ((a - start, b - start),
                              (buf, np.asarray(trace[name][s]))):
                assert np.abs(want).max() > 0, (name, s)
                if name.startswith("conv"):
                    assert (np.linalg.norm(got - want)
                            <= 1e-2 * np.linalg.norm(want)), (name, s)
                else:
                    assert (np.abs(got - want).max()
                            <= 1e-4 * np.abs(want).max()), (name, s)
    assert sched.get_last_lr() == [0.001]


def _as_layer(layer, value, sub):
    """A copy of ``layer`` whose weight or bias is ``value``, to take a
    momentum buffer through params_to_jax's layout change."""
    import copy
    out = copy.deepcopy(layer)
    with torch.no_grad():
        (out.weight if sub == "weights" else out.bias).copy_(value)
    return out


def test_snapshot_unnormalize_2d_bit_for_bit(np_params, params):
    """Per-coordinate and per-class stats, folded in float64 and rounded
    once, as JAX's numpy float64 arrays reach its float32 net."""
    for means, stds in (((0., 0., 0., 0.), (0.1, 0.1, 0.2, 0.2)),
                        (np.linspace(-0.1, 0.1, 84),
                         np.linspace(0.05, 0.3, 84))):
        got = T2.snapshot_unnormalize_2d(params, means, stds)
        want = J2.snapshot_unnormalize_2d(np_params, means, stds)
        out = params_to_jax(torch.nn.ModuleDict(
            {"bbox_pred": got["bbox_pred"]}))["bbox_pred"]
        for s in ("weights", "biases"):
            np.testing.assert_array_equal(
                out[s], np.asarray(want["bbox_pred"][s], np.float32))
        assert got["fc7"] is params["fc7"]
        assert got["bbox_pred"] is not params["bbox_pred"]


def test_make_draws_2d_shapes():
    gen = torch.Generator().manual_seed(0)
    d = T2.make_draws_2d(gen, 324, 44, 16, FC, 0.5, "cpu")
    assert d["anchor_fg"].shape == d["anchor_bg"].shape == (324,)
    assert d["roi_fg"].shape == d["roi_bg"].shape == (44,)
    assert [m.shape for m in d["drop"]] == [(16, FC)] * 2
    assert 0.4 < float(torch.cat(d["drop"]).float().mean()) < 0.6


def test_rpn_head_2d_is_the_mv3d_head():
    assert TV.rpn_head_2d is TM.rpn_head


def test_get_network_names_the_family():
    """models.factory: the JAX package's name -> mode rule; VGGnet* is the
    2D family (21 classes, stride 16), the rest MV3D; other names raise."""
    from mv3d_tf_tpu.models.factory import get_network as j_get_network
    from mv3d_tf_tpu_torch.models.factory import get_network
    for name, is_2d, classes, stride in (("VGGnet_train", True, 21, 16),
                                         ("VGGnet_test", True, 21, 16),
                                         ("MV3D_test", False, 2, 8)):
        spec = get_network(name)
        assert (spec.name, spec.mode) == (j_get_network(name).name,
                                          j_get_network(name).mode)
        assert (spec.is_2d, spec.n_classes, spec.feat_stride) == (
            is_2d, classes, stride)
    with pytest.raises(KeyError, match="Unknown network"):
        get_network("VGGnet")
