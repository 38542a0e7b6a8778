"""The port's MV3D host assembly (eval.frame_detections), whose per-class
NMS is utils/native.nms_np_native (C++), against mv3d_tf_tpu's
frame_detections, whose NMS is the greedy numpy loop nms_np, bit for bit in
all three arrays of each class; and the counters it bumps
(trace.assembly_boxes, trace.assembly_kept). Frames are detector-shaped:
300 rois, BEV boxes of 8-40 px in the 601x601 raster, crowded so that the
NMS removes boxes."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu.eval import (  # noqa: E402
    frame_detections as j_frame_detections)
from mv3d_tf_tpu_torch import trace as T  # noqa: E402
from mv3d_tf_tpu_torch.eval import frame_detections  # noqa: E402

ROIS = 300


def mv3d_frame(rng, k, case):
    """One detector frame as float32 tensors: scores (300, k) softmaxed,
    valid (300,), class BEV boxes (300, 4k) around a few centres, corners
    (300, 24k) twice. ``case`` shapes it: "plain", "ties" (scores on a
    0.1 grid, exact duplicate boxes), "none_pass" (no score above 0.05,
    some exactly 0.05), "all_invalid", "cap" (scores on a 0.01 grid)."""
    logits = rng.normal(0, 1.5, (ROIS, k))
    scores = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    centres = rng.uniform(40, 560, (6, 2))
    xy = centres[rng.integers(0, 6, (ROIS, k))] + rng.normal(0, 25,
                                                             (ROIS, k, 2))
    wh = rng.uniform(8, 40, (ROIS, k, 2))
    bv = np.concatenate([xy, xy + wh], 2).reshape(ROIS, 4 * k)
    valid = rng.uniform(size=ROIS) < 0.9
    if case == "ties":
        scores = np.round(scores, 1)
        bv[1::7] = bv[0::7][:len(bv[1::7])]
    elif case == "cap":
        scores = np.round(scores, 2)
    elif case == "none_pass":
        scores = scores * 0.05
        scores[::5, 1:] = 0.05
    elif case == "all_invalid":
        valid[:] = False
    scores = scores * valid[:, None]
    cnr = rng.normal(0, 20, (ROIS, 24 * k)) * valid[:, None]
    cnr_r = cnr + rng.normal(0, 0.1, cnr.shape) * valid[:, None]
    arrays = {"scores": scores, "boxes_bv": bv * valid[:, None],
              "boxes_cnr": cnr, "boxes_cnr_r": cnr_r}
    det = {n: torch.from_numpy(a.astype(np.float32))
           for n, a in arrays.items()}
    det["valid"] = torch.from_numpy(valid)
    det["rois_3d"] = torch.zeros(ROIS, 7)
    return det


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("nms_thresh", [0.1, 0.3, 0.7, np.float64(0.1)])
@pytest.mark.parametrize("case", ["plain", "ties", "none_pass",
                                  "all_invalid", "cap"])
def test_frame_detections_matches_jax(k, nms_thresh, case):
    rng = np.random.default_rng(
        [k, int(1000 * nms_thresh), len(case), type(nms_thresh) is float])
    det = mv3d_frame(rng, k, case)
    cap = 40 if case == "cap" else 300
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = j_frame_detections(det, num_classes=k, score_thresh=0.05,
                                  nms_thresh=nms_thresh, max_per_image=cap)
        got = frame_detections(det, num_classes=k, score_thresh=0.05,
                               nms_thresh=nms_thresh, max_per_image=cap)
    assert sorted(got) == sorted(want) == list(range(1, k))
    for j in want:
        for g, w in zip(got[j], want[j]):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
    n = sum(len(want[j][0]) for j in want)
    if case in ("none_pass", "all_invalid"):
        assert n == 0
        assert all(got[j][0].shape == (0, 5) and got[j][1].shape == (0, 25)
                   for j in got)
    else:
        assert n > 0
    if case == "cap":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            uncapped = j_frame_detections(det, num_classes=k,
                                          score_thresh=0.05,
                                          nms_thresh=nms_thresh,
                                          max_per_image=0)
        assert n < sum(len(uncapped[j][0]) for j in uncapped)


def test_frame_detections_counts_boxes_and_kept():
    """Class 1: three boxes pass, two of them overlapping (IoU 0.83 > 0.1),
    so two are kept; class 2: none passes; an invalid roi with a high
    score and a box below the threshold are not handed to the NMS."""
    bv = np.zeros((6, 12), np.float32)
    scores = np.zeros((6, 3), np.float32)
    bv[0, 4:8], scores[0, 1] = [10, 10, 30, 30], 0.9
    bv[1, 4:8], scores[1, 1] = [12, 12, 32, 32], 0.8
    bv[2, 4:8], scores[2, 1] = [200, 200, 220, 230], 0.7
    bv[3, 4:8], scores[3, 1] = [400, 400, 420, 420], 0.04
    bv[4, 4:8], scores[4, 1] = [300, 300, 320, 320], 0.95
    scores[:, 2] = 0.01
    valid = np.array([True, True, True, True, False, True])
    det = {"scores": torch.from_numpy(scores),
           "boxes_bv": torch.from_numpy(bv),
           "boxes_cnr": torch.zeros(6, 72), "boxes_cnr_r": torch.zeros(6, 72),
           "valid": torch.from_numpy(valid)}
    before = (T.assembly_boxes, T.assembly_kept)
    T.clear()
    with T.tracing():
        out = frame_detections(det, num_classes=3, score_thresh=0.05,
                               nms_thresh=0.1)
    assert T.assembly_boxes - before[0] == 3
    assert T.assembly_kept - before[1] == 2
    assert [len(out[j][0]) for j in (1, 2)] == [2, 0]
    (span,) = [r for r in T.records() if r.name == "assembly"]
    T.clear()
    assert span.counts["host_syncs"] == 5
    # a span reader takes every counter but these two for kernel launches
    assert not {"assembly_boxes", "assembly_kept"} & set(span.counts)
