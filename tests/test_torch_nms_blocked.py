"""The port's blocked NMS (nms_blocked, nms_blocked_fixed), the proposal
layer's NMS routing and the batched detector's certificate against
mv3d_tf_tpu's, on the same numpy inputs: keep_idx, keep_valid and the
certificate exactly, and the keep sets against the greedy nms and nms_np
where certified."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _example_calib  # noqa: E402
from mv3d_tf_tpu.eval import build_detect_batch_fn as j_batch_fn  # noqa: E402
from mv3d_tf_tpu.ops import nms as J  # noqa: E402
from mv3d_tf_tpu.proposals import proposal_layer_3d  # noqa: E402
from mv3d_tf_tpu_torch import proposals as TP  # noqa: E402
from mv3d_tf_tpu_torch.eval import build_detect_batch_fn  # noqa: E402
from mv3d_tf_tpu_torch.ops import nms as T  # noqa: E402
from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,  # noqa: E402
                                             params_from_jax)
from test_torch_eval import HE, HE_FRAMES, HE_SEED, _frame  # noqa: E402

MAX_OUT, THRESH = 600, 0.7


def _boxes(rng, n, size=300.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(4, 40, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _chain(n, x0=0.0):
    """n boxes 100 wide, each shifted 12 px: neighbours overlap at IoU
    0.786 >= 0.7, boxes two apart at 0.613. Greedy keeps every other one,
    and the fixpoint needs about n rounds."""
    x = x0 + 12.0 * np.arange(n, dtype=np.float32)
    return np.stack([x, np.full(n, 500.0), x + 99.0, np.full(n, 599.0)],
                    1).astype(np.float32)


def _sorted(boxes, scores, valid):
    """What presorted promises: descending score, the invalid trailing."""
    order = np.argsort(-np.where(valid & np.isfinite(scores), scores, -1e30),
                       kind="stable")
    return boxes[order], scores[order], valid[order]


def _jax(fixed, boxes, scores, valid, max_out=MAX_OUT, **kw):
    args = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
            max_out, THRESH)
    if fixed:
        idx, val, conv = J.nms_blocked_fixed(*args, **kw)
        return np.asarray(idx), np.asarray(val), bool(conv)
    idx, val = J.nms_blocked(*args, **kw)
    return np.asarray(idx), np.asarray(val), True


def _port(fixed, boxes, scores, valid, max_out=MAX_OUT, **kw):
    args = (torch.from_numpy(boxes), torch.from_numpy(scores),
            torch.from_numpy(valid), max_out, THRESH)
    if fixed:
        idx, val, conv = T.nms_blocked_fixed(*args, **kw)
        assert conv.shape == boxes.shape[:-2]
        return idx.numpy(), val.numpy(), conv.numpy()
    idx, val = T.nms_blocked(*args, **kw)
    return idx.numpy(), val.numpy(), np.ones(boxes.shape[:-2], bool)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert bool(got[2]) == want[2]


def _greedy(boxes, scores, valid, max_out=MAX_OUT):
    idx, val = T.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                     torch.from_numpy(valid), max_out, THRESH)
    return idx.numpy(), val.numpy()


def _case(kind, rng):
    n = 1500
    boxes = _boxes(rng, n)
    scores = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) > 0.1
    if kind == "trailing":               # 300 invalid entries at the end
        valid[-300:] = False
    elif kind == "nonfinite":
        scores[rng.choice(n, 40, replace=False)] = np.nan
        scores[rng.choice(n, 40, replace=False)] = np.inf
        scores[rng.choice(n, 40, replace=False)] = -np.inf
    elif kind == "ties":                 # 8 distinct scores over 1500 boxes
        scores = (rng.randint(0, 8, n) / 8.0).astype(np.float32)
    return boxes, scores, valid


@pytest.mark.parametrize("kind", ["random", "trailing", "nonfinite", "ties"])
@pytest.mark.parametrize("block", [512, 64])
@pytest.mark.parametrize("presorted", [False, True])
def test_blocked_nms_matches_jax(kind, block, presorted, rng):
    """N=1500 at blocks 512 and 64: both variants give JAX's keep_idx,
    keep_valid and certificate; certified, the keep set is the greedy
    loop's and the numpy oracle's."""
    boxes, scores, valid = _case(kind, rng)
    if presorted:
        boxes, scores, valid = _sorted(boxes, scores, valid)
    kw = dict(block=block, presorted=presorted)
    for fixed in (False, True):
        got = _port(fixed, boxes, scores, valid, **kw)
        want = _jax(fixed, boxes, scores, valid, **kw)
        _assert_same(got, want)
        assert got[2] and got[1].sum() > 100
        idx, val = _greedy(boxes, scores, valid)
        np.testing.assert_array_equal(got[1], val)
        np.testing.assert_array_equal(got[0], idx)
    if kind == "random":
        act = valid & np.isfinite(scores)
        keep = [int(np.flatnonzero(act)[i]) for i in T.nms_np(
            np.hstack([boxes[act], scores[act, None]]), THRESH)]
        assert got[0][got[1]].tolist() == keep[:MAX_OUT]


@pytest.mark.parametrize("presorted", [False, True])
def test_chain_deeper_than_rounds(presorted, rng):
    """A 40-box chain inside one 64-block: 16 rounds do not reach the
    fixpoint, so nms_blocked_fixed's certificate is False in both packages
    and its keep set still equals JAX's; the exact variant keeps every
    other chain box, as the greedy loop does."""
    chain = _chain(40)
    boxes = np.concatenate([chain, _boxes(rng, 160)])
    scores = np.concatenate([np.linspace(0.99, 0.9, 40),
                             rng.rand(160) * 0.8]).astype(np.float32)
    valid = np.ones(200, bool)
    if presorted:
        boxes, scores, valid = _sorted(boxes, scores, valid)
    kw = dict(block=64, presorted=presorted)
    fixed = _port(True, boxes, scores, valid, max_out=120, **kw)
    _assert_same(fixed, _jax(True, boxes, scores, valid, max_out=120, **kw))
    assert not fixed[2]
    exact = _port(False, boxes, scores, valid, max_out=120, **kw)
    _assert_same(exact, _jax(False, boxes, scores, valid, max_out=120, **kw))
    idx, val = _greedy(boxes, scores, valid, max_out=120)
    np.testing.assert_array_equal(exact[0], idx)
    np.testing.assert_array_equal(exact[1], val)
    chain_kept = sorted(i for i in exact[0][exact[1]] if scores[i] >= 0.9)
    assert len(chain_kept) == 20
    assert not np.array_equal(fixed[0], exact[0])


def test_batched_rows_match_jax_per_frame(rng):
    """B=3 frames in one call (one of them with a 40-box chain): each row
    equals JAX's result for that frame alone, certificates included."""
    frames = [_case("random", rng), _case("ties", rng), _case("random", rng)]
    b, s, v = frames[2]
    b[:40], s[:40], v[:40] = _chain(40), np.linspace(2.0, 1.9, 40), True
    boxes, scores, valid = (np.stack(x) for x in zip(*frames))
    for fixed in (False, True):
        got = _port(fixed, boxes, scores, valid, block=64)
        for f in range(3):
            want = _jax(fixed, *frames[f], block=64)
            _assert_same((got[0][f], got[1][f], got[2][f]), want)
    assert got[2].tolist() == [True, True, False]


def _rpn_outputs(rng, feat=10):
    """RPN softmax probabilities and small deltas for one frame."""
    logits = rng.randn(1, feat, feat, 8).astype(np.float32) * 2
    e = np.exp(logits.reshape(1, feat, feat, 4, 2))
    prob = (e / e.sum(-1, keepdims=True)).reshape(1, feat, feat, 8)
    deltas = (rng.randn(1, feat, feat, 24) * 0.1).astype(np.float32)
    return prob.astype(np.float32), deltas


@pytest.mark.parametrize("nms_impl", ["auto", "blocked", "blocked_fixed"])
def test_proposal_layer_routing_matches_jax(nms_impl, rng):
    """proposal_layer_3d at feat 10x10 and post-NMS 600 ("auto" takes the
    blocked scan above 512) against JAX's layer: the valid rows and the
    certificate ("blocked_fixed") exactly, the rois as the greedy layer's
    test holds them; at post-NMS 300 "auto" is the greedy
    loop and gives the same rows."""
    prob, deltas = _rpn_outputs(rng)
    calib = _example_calib()
    kw = dict(pre_nms_top_n=12000, post_nms_top_n=600, nms_impl=nms_impl)
    want = proposal_layer_3d(jnp.asarray(prob), jnp.asarray(deltas),
                             jnp.asarray(calib), 10, 10, **kw)
    got = TP.proposal_layer_3d(torch.from_numpy(prob),
                               torch.from_numpy(deltas),
                               torch.from_numpy(calib), 10, 10, **kw)
    assert set(got) == set(want)
    assert ("nms_converged" in got) == (nms_impl == "blocked_fixed")
    for k in ("valid", "nms_converged"):
        if k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the decoded boxes round as in tests/test_torch_nms.py (atol 1e-4)
    for k in ("rois_bv", "rois_img", "rois_3d", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
    assert got["valid"].sum() > 50
    small = TP.proposal_layer_3d(torch.from_numpy(prob),
                                 torch.from_numpy(deltas),
                                 torch.from_numpy(calib), 10, 10,
                                 post_nms_top_n=300)
    n = int(small["valid"].sum())
    assert n == min(300, int(got["valid"].sum()))
    for k in ("rois_bv", "rois_3d", "scores"):
        np.testing.assert_array_equal(small[k][:n].numpy(),
                                      got[k][:n].numpy(), err_msg=k)
    with pytest.raises(ValueError, match="nms_impl"):
        TP.proposal_layer_3d(torch.from_numpy(prob), torch.from_numpy(deltas),
                             torch.from_numpy(calib), 10, 10, nms_impl="x")


def test_detector_certificate_matches_jax():
    """build_detect_batch_fn(nms_impl="blocked_fixed") at
    tests/test_torch_eval.py's He config: the certificate JAX's batched
    detector computes, per frame, and the same valid rows."""
    p = he_normal_params(HE_SEED, fc_dim=64)
    bev, img, calib = (np.stack(x) for x in zip(*[_frame(f)
                                                  for f in HE_FRAMES]))
    want = j_batch_fn(nms_impl="blocked_fixed", **HE)(
        p, jnp.asarray(bev), jnp.asarray(img), jnp.asarray(calib))
    got = build_detect_batch_fn(nms_impl="blocked_fixed", **HE)(
        params_from_jax(p, device="cpu"), bev, img, calib)
    np.testing.assert_array_equal(got["nms_converged"].numpy(),
                                  np.asarray(want["nms_converged"]))
    assert got["nms_converged"].shape == (2,)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-4)
    auto = build_detect_batch_fn(**HE)(params_from_jax(p, device="cpu"),
                                       bev, img, calib)
    assert "nms_converged" not in auto
