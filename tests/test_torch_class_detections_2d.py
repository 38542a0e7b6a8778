"""The 2D detector's host class step: utils/native.nms_np_native (C++)
against the greedy loop ops.nms.nms_np, and solver.class_detections_2d
against test_net_2d's per-class loop written out plainly (threshold,
nms_np, cap), on random
detector-like outputs whose rois crowd a few places, so that the NMS
removes boxes and the cap bites."""

import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from mv3d_tf_tpu_torch.ops.nms import nms_np  # noqa: E402
from mv3d_tf_tpu_torch.solver import class_detections_2d  # noqa: E402
from mv3d_tf_tpu_torch.utils.native import nms_np_native  # noqa: E402


def random_dets(rng, n, ties=False):
    """(n, 5) float32 boxes around 4 centres, some degenerate, with scores
    rounded to one decimal when ``ties``."""
    centres = rng.uniform(0, 400, (4, 2))
    xy = centres[rng.integers(0, 4, n)] + rng.normal(0, 20, (n, 2))
    wh = rng.uniform(-2, 100, (n, 2))
    scores = rng.uniform(0, 1, (n, 1))
    if ties:
        scores = np.round(scores, 1)
    return np.hstack([xy, xy + wh, scores]).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7, np.float64(0.7)])
def test_nms_np_native_is_nms_np(seed, thresh):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 37, 300):
        for ties in (False, True):
            dets = random_dets(rng, n, ties)
            if n > 3:
                dets[1] = dets[0]            # an exact duplicate
                dets[2, 0] = np.nan
            with warnings.catch_warnings():
                # degenerate boxes give 0/0 overlaps in both
                warnings.simplefilter("ignore", RuntimeWarning)
                assert nms_np_native(dets, thresh) == nms_np(dets, thresh)


def plain_class_loop(out, im_scale, thresh, nms_thresh, max_per_image):
    """test_net_2d's steps as the loop it ran over nms_np."""
    scores, valid = out["scores"], out["valid"]
    boxes = out["boxes"] / im_scale
    dets_all = [np.zeros((0, 5), np.float32)]
    for j in range(1, scores.shape[1]):
        inds = np.where(valid & (scores[:, j] > thresh))[0]
        dets = np.hstack([boxes[inds, 4 * j:4 * (j + 1)],
                          scores[inds, j:j + 1]]).astype(np.float32)
        dets_all.append(dets[nms_np(dets, nms_thresh)])
    if max_per_image > 0:
        flat = np.concatenate([d[:, -1] for d in dets_all[1:]])
        if len(flat) > max_per_image:
            t = np.sort(flat)[-max_per_image]
            dets_all = [dets_all[0]] + [d[d[:, -1] >= t]
                                        for d in dets_all[1:]]
    return dets_all


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("max_per_image", [0, 20, 100])
def test_class_detections_2d_is_the_plain_loop(seed, max_per_image):
    rng = np.random.default_rng(100 + seed)
    p, k = 200, 6
    logits = rng.normal(0, 2, (p, k))
    scores = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    boxes = np.concatenate([random_dets(rng, p)[:, :4] for _ in range(k)],
                           axis=1)
    valid = rng.uniform(size=p) < 0.9
    out = {"scores": (scores * valid[:, None]).astype(np.float32),
           "boxes": (boxes * valid[:, None]).astype(np.float32),
           "valid": valid}
    scale = np.float32(1.6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = plain_class_loop(out, scale, 0.05, 0.5, max_per_image)
        got = class_detections_2d(out, scale, 0.05, 0.5, max_per_image)
    assert len(got) == len(want) == k
    assert sum(len(d) for d in want[1:]) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape[1] == 5
        np.testing.assert_array_equal(g, w)
