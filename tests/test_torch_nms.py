"""The port's top-K, greedy NMS and proposal layer against mv3d_tf_tpu and
the numpy greedy oracle, on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _example_calib  # noqa: E402

from mv3d_tf_tpu.ops import nms as J  # noqa: E402
from mv3d_tf_tpu.proposals import proposal_layer_3d  # noqa: E402
from mv3d_tf_tpu_torch.ops import nms as T  # noqa: E402
from mv3d_tf_tpu_torch.proposals import \
    proposal_layer_3d as t_proposal_layer_3d  # noqa: E402


def _boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(4, 30, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("equal", [False, True])
def test_top_k_matches_lax_top_k(rng, equal):
    n, k = 300, 120
    scores = (np.full(n, 0.5) if equal else rng.rand(n)).astype(np.float32)
    valid = rng.rand(n) > 0.3
    ref_idx, ref_valid = J.top_k_by_score(jnp.asarray(scores),
                                          jnp.asarray(valid), k)
    idx, val = T.top_k_by_score(torch.from_numpy(scores),
                                torch.from_numpy(valid), k)
    np.testing.assert_array_equal(val.numpy(), np.asarray(ref_valid))
    # lax.top_k orders ties by index; compare the slots JAX marks valid
    # and, where all scores tie, every slot
    sel = np.ones(k, bool) if equal else np.asarray(ref_valid)
    np.testing.assert_array_equal(idx.numpy()[sel], np.asarray(ref_idx)[sel])


@pytest.mark.parametrize("equal", [False, True])
def test_nms_matches_jax(rng, equal):
    n, max_out = 200, 60
    boxes = _boxes(rng, n)
    scores = (np.full(n, 0.5) if equal else rng.rand(n)).astype(np.float32)
    valid = rng.rand(n) > 0.2
    ref_idx, ref_val = J.nms(jnp.asarray(boxes), jnp.asarray(scores),
                             jnp.asarray(valid), max_out, 0.7)
    idx, val = T.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                     torch.from_numpy(valid), max_out, 0.7)
    np.testing.assert_array_equal(val.numpy(), np.asarray(ref_val))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


def test_nms_keep_set_matches_nms_np(rng):
    n = 300
    boxes = _boxes(rng, n, size=60.0)
    scores = rng.rand(n).astype(np.float32)
    keep_ref = T.nms_np(np.hstack([boxes, scores[:, None]]), 0.5)
    assert keep_ref == J.nms_np(np.hstack([boxes, scores[:, None]]), 0.5)
    idx, val = T.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                     torch.ones(n, dtype=torch.bool), n, 0.5)
    assert idx[val].tolist() == keep_ref
    # frames as a leading batch dim: each frame gets its own keep set
    b_idx, b_val = T.nms(torch.from_numpy(np.stack([boxes, boxes[::-1]])),
                         torch.from_numpy(np.stack([scores, scores[::-1]])),
                         torch.ones(2, n, dtype=torch.bool), n, 0.5)
    assert b_idx[0][b_val[0]].tolist() == keep_ref
    assert sorted(b_idx[1][b_val[1]].tolist()) == sorted(
        n - 1 - i for i in keep_ref)


def test_nms_all_invalid_slots_are_zero(rng):
    boxes = _boxes(rng, 10)
    idx, val = T.nms(torch.from_numpy(boxes), torch.rand(10),
                     torch.zeros(10, dtype=torch.bool), 4)
    assert not val.any() and not idx.any()


def _rpn_outputs(rng, h, w):
    logits = rng.randn(1, h, w, 4, 2).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    prob = (e / e.sum(-1, keepdims=True)).reshape(1, h, w, 8)
    deltas = (rng.randn(1, h, w, 24) * 0.1).astype(np.float32)
    return prob.astype(np.float32), deltas


def test_proposal_layer_matches_jax(rng):
    prob, deltas = _rpn_outputs(rng, 10, 10)
    calib = _example_calib()
    kw = dict(pre_nms_top_n=120, post_nms_top_n=40, nms_thresh=0.7)
    ref = proposal_layer_3d(jnp.asarray(prob), jnp.asarray(deltas),
                            jnp.asarray(calib), 10, 10, **kw)
    got = t_proposal_layer_3d(torch.from_numpy(prob), torch.from_numpy(deltas),
                              torch.from_numpy(calib), 10, 10, **kw)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(ref["valid"]))
    assert got["valid"].sum() > 10
    for key in ("rois_bv", "rois_img", "rois_3d", "scores"):
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=1e-4, err_msg=key)
    # two frames at once give each frame's single-frame result
    two = t_proposal_layer_3d(
        torch.from_numpy(np.concatenate([prob, prob])),
        torch.from_numpy(np.concatenate([deltas, deltas])),
        torch.from_numpy(np.stack([calib, calib])), 10, 10, **kw)
    for key in got:
        assert torch.equal(two[key][1], got[key]), key
