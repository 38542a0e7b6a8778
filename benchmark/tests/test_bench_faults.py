"""A run with the timed path broken underneath comes out not correct: the
harness's whole run (set-up, window, judgement) at small shapes on the CPU,
once for each fault a detection cell can have. The cells keep no state
from call to call and run on one chip, so a step that leaves its state
unchanged and a dropped exchange between chips do not apply."""

import pytest
import torch

from benchmark.lib import harness as H
from benchmark.tests import small

SEED = 2**31 + 77
# the number that judges a detection's score, by cell
SCORE = {"mv3d.detect_b8": "logit_err", "mv3d.online_b1": "logit_err",
         "faster_rcnn.detect_b1": "score_err"}


def _run(cell):
    return H.run_cell(cell, SEED, 0.2, False, device="cpu",
                      cell_files=small.cell_files(cell))


def _failed(out):
    return {k for k, c in out["checks"].items() if c["value"] > c["limit"]}


def _wrap(monkeypatch, module, name, broken):
    real = getattr(module, name)

    def build(*a, **kw):
        fn = real(*a, **kw)
        return lambda *x: broken(fn(*x))
    monkeypatch.setattr(module, name, build)


def _alter_score(det, frame=None):
    """One answer altered where it is produced: the first kept roi's
    foreground score."""
    s = det["scores"].clone()
    at = (0,) if frame is None else (frame, 0)
    s[at + (1,)] = 1.0 - s[at + (1,)]
    return dict(det, scores=s)


def _half_batch(det):
    """Half of the batch left out: its frames get the other half's
    answers."""
    out = {}
    for k, v in det.items():
        v = v.clone()
        h = v.shape[0] // 2
        v[h:2 * h] = v[:h]
        out[k] = v
    return out


def test_sound_runs_pass_the_numbers_the_faults_fail():
    for cell, score in SCORE.items():
        failed = _failed(_run(cell))
        assert not failed & {score, "roi_err", "raster_mismatch"}, (
            cell, failed)


@pytest.mark.parametrize("fault", ["answer", "half_batch"])
def test_detect_b8_faults(monkeypatch, fault):
    from mv3d_tf_tpu_torch import eval as E
    broken = (lambda d: _alter_score(d, 0)) if fault == "answer" else \
        _half_batch
    _wrap(monkeypatch, E, "build_detect_batch_fn", broken)
    out = _run("mv3d.detect_b8")
    assert not out["correct"]
    assert ("logit_err" if fault == "answer" else "roi_err") in _failed(out)


def test_detect_2d_answer_altered(monkeypatch):
    from mv3d_tf_tpu_torch import faster_rcnn_2d as F2
    _wrap(monkeypatch, F2, "build_im_detect_2d", _alter_score)
    out = _run("faster_rcnn.detect_b1")
    assert not out["correct"] and "score_err" in _failed(out)


@pytest.mark.parametrize("fault", ["answer", "raster"])
def test_online_faults(monkeypatch, fault):
    from mv3d_tf_tpu_torch import eval as E
    from mv3d_tf_tpu_torch.ops import bev
    if fault == "answer":
        _wrap(monkeypatch, E, "build_detect_fn", _alter_score)
    else:
        real = bev.point_cloud_2_top_batch

        def raster(*a, **kw):
            r = real(*a, **kw).clone()
            r[0, -1, r.shape[2] // 2, 8] += 0.5
            return r
        monkeypatch.setattr(bev, "point_cloud_2_top_batch", raster)
    out = _run("mv3d.online_b1")
    assert not out["correct"]
    assert ("logit_err" if fault == "answer" else
            "raster_mismatch") in _failed(out)


def test_the_faults_leave_shapes_alone():
    det = {"scores": torch.rand(4, 3, 2), "valid": torch.ones(4, 3,
                                                              dtype=bool)}
    assert _half_batch(det)["scores"].shape == (4, 3, 2)
    assert _alter_score(det, 1)["scores"][1, 0, 1] != det["scores"][1, 0, 1]
