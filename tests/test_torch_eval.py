"""The port's detector end to end against mv3d_tf_tpu on CPU in float32:
the parameter round trip, the golden canary (tests/golden_e2e.npz), a
He-scaled detector against the JAX detector, and a run without jax."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from __graft_entry__ import _example_calib  # noqa: E402
from mv3d_tf_tpu.eval import build_detect_fn as j_build_detect_fn  # noqa: E402
from mv3d_tf_tpu.models import mv3d as J  # noqa: E402
from mv3d_tf_tpu_torch.eval import (build_detect_batch_fn,  # noqa: E402
                                    build_detect_fn, frame_detections)
from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,  # noqa: E402
                                             params_from_jax, params_to_jax)

GOLDEN_FILE = os.path.join(os.path.dirname(__file__), "golden_e2e.npz")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(feat_h=10, feat_w=10, pre_nms_top_n=120, post_nms_top_n=40)
# He-scaled case: params seed, frames and pre-NMS top-K chosen so that
# neighbouring pre-NMS scores are more than 1e-4 apart (asserted in the
# test) and no decoded roi edge sits within float32 noise of a pixel
# boundary, where a floor could move it by one pixel
HE_SEED, HE_FRAMES = 21, (1, 2)
HE = dict(feat_h=10, feat_w=10, pre_nms_top_n=30, post_nms_top_n=30)


def _frame(seed):
    rng = np.random.RandomState(seed)
    bev = rng.rand(81, 81, 9).astype(np.float32)
    img = (rng.rand(88, 120, 3) * 255).astype(np.float32)
    return bev, img, _example_calib()


def _np(det):
    return {k: v.numpy() for k, v in det.items()}


def test_params_round_trip_is_exact():
    p = {k: {n: np.asarray(a) for n, a in v.items()}
         for k, v in J.init_params(jax.random.PRNGKey(1), fc_dim=16).items()}
    back = params_to_jax(params_from_jax(p, device="cpu"))
    assert set(back) == set(p)
    for name in p:
        for sub in ("weights", "biases"):
            assert back[name][sub].dtype == np.float32
            np.testing.assert_array_equal(back[name][sub], p[name][sub])


def test_golden_end_to_end():
    """tests/golden_e2e.npz within test_golden_e2e.py's tolerances, from the
    JAX package's own init (every score is a tie at 0.5 there, so this pins
    the tie rules of top-K and NMS)."""
    params = params_from_jax(J.init_params(jax.random.PRNGKey(7)),
                             device="cpu")
    det = _np(build_detect_fn(**SMALL)(params, *_frame(7)))
    g = np.load(GOLDEN_FILE)
    np.testing.assert_array_equal(det["valid"], g["valid"])
    np.testing.assert_allclose(det["scores"], g["scores"], atol=1e-4)
    np.testing.assert_allclose(det["boxes_bv"], g["boxes_bv"], atol=1e-2)
    np.testing.assert_allclose(det["boxes_cnr_r"], g["boxes_cnr_r"],
                               atol=1e-2)


@pytest.fixture(scope="module")
def he_case():
    """He-scaled params, two frames, and the JAX single-frame detector's
    outputs on each (one jit)."""
    p = he_normal_params(HE_SEED, fc_dim=64)
    frames = [_frame(f) for f in HE_FRAMES]
    detect = j_build_detect_fn(**HE)
    ref = [{k: np.asarray(v) for k, v in detect(p, *f).items()}
           for f in frames]
    return p, frames, ref


def _jax_pre_nms_scores(p, frame):
    """JAX's top pre_nms_top_n + 1 valid pre-NMS scores, in order: its
    proposal layer with nms_thresh 1.0 suppresses nothing but exact
    duplicates."""
    from mv3d_tf_tpu.eval import PIXEL_MEANS
    from mv3d_tf_tpu.proposals import proposal_layer_3d
    bev, img, calib = frame
    c5, _ = J.extract_features(p, bev[None], img[None] - PIXEL_MEANS)
    cls, box = J.rpn_head(p, c5)
    k = HE["pre_nms_top_n"] + 1
    out = proposal_layer_3d(J.rpn_probs(cls), box, calib, 10, 10,
                            pre_nms_top_n=k, post_nms_top_n=k, nms_thresh=1.0)
    assert np.asarray(out["valid"]).all()
    return np.asarray(out["scores"])


def _assert_matches(got, ref):
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    assert ref["valid"].sum() >= 10
    for key in got:
        if key != "valid":
            np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-4,
                                       err_msg=key)


def test_he_scaled_detector_matches_jax(he_case):
    p, frames, ref = he_case
    # distinct pre-NMS scores, so both packages sort and suppress alike
    for frame in frames:
        assert np.min(-np.diff(_jax_pre_nms_scores(p, frame))) > 1e-4
    params = params_from_jax(p, device="cpu")
    single = _np(build_detect_fn(**HE)(params, *frames[0]))
    assert set(single) == set(ref[0])
    _assert_matches(single, ref[0])

    batch = _np(build_detect_batch_fn(nms_impl="blocked_fixed", **HE)(
        params, *[np.stack(x) for x in zip(*frames)]))
    assert batch.pop("nms_converged").tolist() == [True, True]
    for b in range(2):
        want = {k: v for k, v in ref[b].items() if k != "rois_img"}
        _assert_matches({k: v[b] for k, v in batch.items()}, want)
    dets = frame_detections(single)
    assert set(dets) == {1} and len(dets[1][0]) > 0


def test_detector_runs_without_jax():
    code = (
        "import sys\n"
        "from mv3d_tf_tpu_torch.eval import build_detect_fn\n"
        "from mv3d_tf_tpu_torch.utils.weights import he_normal_params, "
        "params_from_jax\n"
        "import numpy as np\n"
        "rng = np.random.RandomState(0)\n"
        "cal = np.zeros((4, 12), np.float32); cal[0, [0, 5, 10]] = 1\n"
        "cal[2, [0, 4, 8]] = 1; cal[3, [1, 6, 8]] = [-1, -1, 1]\n"
        "det = build_detect_fn(feat_h=5, feat_w=5, pre_nms_top_n=30,\n"
        "    post_nms_top_n=8)(params_from_jax(he_normal_params(0, fc_dim=8),\n"
        "    device='cpu'),\n"
        "    rng.rand(41, 41, 9), rng.rand(40, 48, 3) * 255, cal)\n"
        "assert det['scores'].shape == (8, 2)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'mv3d_tf_tpu')]\n"
        "assert not bad, 'loaded: %s' % bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
