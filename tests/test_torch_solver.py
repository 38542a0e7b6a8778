"""The port's evaluation loop and what it reads and writes, against the
JAX package's on CPU: the KITTI AP evaluators on the same detections,
solver.test_net with one injected deterministic detector (identical
pickles, as tests/test_multihost.py drives JAX's), the reference-style
.npy weight import, and the port's snapshots."""

import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu import solver as JSOL  # noqa: E402
from mv3d_tf_tpu.config import cfg as jcfg  # noqa: E402
from mv3d_tf_tpu.config import get_output_dir as j_output_dir  # noqa: E402
from mv3d_tf_tpu.data import kitti as JK  # noqa: E402
from mv3d_tf_tpu.data import kitti_eval as JE  # noqa: E402
from mv3d_tf_tpu.data import synthetic  # noqa: E402
from mv3d_tf_tpu.utils import weights as JW  # noqa: E402
from mv3d_tf_tpu_torch import solver as TSOL  # noqa: E402
from mv3d_tf_tpu_torch.config import cfg as tcfg  # noqa: E402
from mv3d_tf_tpu_torch.config import get_output_dir as t_output_dir  # noqa
from mv3d_tf_tpu_torch.data import kitti as TK  # noqa: E402
from mv3d_tf_tpu_torch.data import kitti_eval as TE  # noqa: E402
from mv3d_tf_tpu_torch.utils import checkpoint as TC  # noqa: E402
from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,  # noqa: E402
                                             load_npy_weights,
                                             params_from_jax, params_to_jax)

PICKLES = ("detections.pkl", "detections_cnr.pkl", "detections_cnr_r.pkl")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return synthetic.generate(str(tmp_path_factory.mktemp("kitti")),
                              num_frames=6, cars_per_frame=3, seed=7)


@pytest.fixture
def imdbs(root, tmp_path, monkeypatch):
    """Both packages' val imdbs, their caches and outputs under tmp_path."""
    for c, sub in ((jcfg, "jax"), (tcfg, "port")):
        monkeypatch.setattr(c, "DATA_DIR", str(tmp_path / sub / "data"))
        monkeypatch.setattr(c, "ROOT_DIR", str(tmp_path / sub))
    j, t = JK.KittiMV3D("val", kitti_path=root), \
        TK.KittiMV3D("val", kitti_path=root)
    JK.prepare_roidb(j)
    TK.prepare_roidb(t)
    return j, t


def _detections(imdb, seed=3):
    """Per frame: each gt jittered, one of them dropped, and false
    positives, with scores; BEV boxes, unregressed and regressed corners."""
    rng = np.random.RandomState(seed)
    n = imdb.num_images
    boxes = [[np.zeros((0, 5), np.float32)] * n for _ in range(2)]
    cnr = [[np.zeros((0, 25), np.float32)] * n for _ in range(2)]
    cnr_r = [[np.zeros((0, 25), np.float32)] * n for _ in range(2)]
    for i, e in enumerate(imdb.roidb):
        g = len(e["boxes_bv"])
        bv = np.concatenate([e["boxes_bv"][1:] + rng.uniform(-2, 2, (g - 1, 4)),
                             rng.uniform(100, 500, (3, 4))])
        bv[:, 2:] = np.maximum(bv[:, 2:], bv[:, :2] + 4)
        c = np.concatenate([e["boxes_corners"][1:]
                            + rng.uniform(-0.3, 0.3, (g - 1, 24)),
                            rng.uniform(-20, 20, (3, 24))])
        s = rng.uniform(0.1, 1.0, (len(bv), 1))
        boxes[1][i] = np.hstack([bv, s]).astype(np.float32)
        cnr[1][i] = np.hstack([c, s]).astype(np.float32)
        cnr_r[1][i] = np.hstack([c + rng.uniform(-0.2, 0.2, c.shape),
                                 s]).astype(np.float32)
    return boxes, cnr, cnr_r


def _assert_same(got, want, path="r"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], path + "/" + str(k))
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64),
                                   rtol=1e-12, atol=0, err_msg=path)


def test_kitti_bev_ap_equals_jax(imdbs):
    jimdb, timdb = imdbs
    boxes, _, _ = _detections(jimdb)
    for thr in (0.5, 0.7):
        for n in (None, 2):
            want = JE.evaluate_kitti_bev(jimdb, boxes, iou_thresh=thr,
                                         num_frames=n)
            got = TE.evaluate_kitti_bev(timdb, boxes, iou_thresh=thr,
                                        num_frames=n)
            _assert_same(got, want)
            assert 0 < got["ap"] < 1


@pytest.mark.parametrize("mode", [
    dict(),
    dict(projection="proper", derive_bev_from_corners=True, num_frames=2)])
def test_kitti_official_table_equals_jax(imdbs, mode):
    jimdb, timdb = imdbs
    boxes, cnr, cnr_r = _detections(jimdb)
    c = cnr_r if mode else cnr
    quiet = lambda *a, **k: None  # noqa: E731
    want = JE.evaluate_kitti_official(jimdb, boxes, c, log=quiet, **mode)
    got = TE.evaluate_kitti_official(timdb, boxes, c, log=quiet, **mode)
    _assert_same(got, want)
    for metric in ("2d", "bev", "3d"):
        assert got[metric]["hard"] > 0, metric


def _fake_detect(params, bev, image, calib):
    """tests/test_multihost.py's deterministic per-frame detector."""
    s = float(np.asarray(bev).sum()) % 7.0
    P = 4
    return {"scores": np.full((P, 2), 0.1 + s / 10.0, np.float32),
            "boxes_bv": np.tile(np.arange(8, dtype=np.float32) * (1 + s),
                                (P, 1)),
            "boxes_cnr": np.zeros((P, 48), np.float32) + s,
            "boxes_cnr_r": np.ones((P, 48), np.float32) * s,
            "rois_3d": np.zeros((P, 7), np.float32),
            "valid": np.ones((P,), bool)}


def test_test_net_pickles_equal_jax(imdbs):
    """One injected detector through both packages' test_net: the same three pickles,
    byte for byte, and the same return value."""
    jimdb, timdb = imdbs
    quiet = lambda *a, **k: None  # noqa: E731
    want = JSOL.test_net(None, jimdb, detect_fn=_fake_detect, log=quiet)
    got = TSOL.test_net(None, timdb, detect_fn=_fake_detect, log=quiet)
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            for a, b in zip(gc, wc):
                np.testing.assert_array_equal(a, b)
    jdir, tdir = j_output_dir(jimdb, "default"), t_output_dir(timdb,
                                                              "default")
    assert jdir != tdir
    for name in PICKLES:
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(tdir, PICKLES[0]), "rb") as f:
        assert len(pickle.load(f)[1]) == timdb.num_images


def test_test_net_raises_on_a_failed_nms_certificate(imdbs):
    _, timdb = imdbs

    def uncertified(*a):
        return dict(_fake_detect(*a), nms_converged=np.array(False))

    with pytest.raises(RuntimeError, match="certificate"):
        TSOL.test_net(None, timdb, detect_fn=uncertified,
                      log=lambda *a: None, evaluate=False)


def test_npy_weights_load_like_jax(tmp_path):
    """A reference-style .npy dict: known layers overwritten, the 3-channel
    ImageNet conv1_1 skipped on the 9-channel BEV trunk, unknown names
    skipped, fc6's rows permuted from channel-major to NHWC; the port's
    params equal JAX's load_npy_weights after params_from_jax."""
    P = he_normal_params(0, fc_dim=8)
    rng = np.random.RandomState(1)
    ref = {
        "conv1_1": {"weights": rng.randn(3, 3, 3, 64).astype(np.float32),
                    "biases": rng.randn(64).astype(np.float32)},
        "conv1_1_2": {"weights": rng.randn(3, 3, 3, 64).astype(np.float32),
                      "biases": rng.randn(64).astype(np.float32)},
        "conv5_3": {"weights": rng.randn(3, 3, 512, 512).astype(np.float32),
                    "biases": rng.randn(512).astype(np.float32)},
        "fc6": {"weights": rng.randn(512 * 49, 8).astype(np.float32)},
        "no_such_layer": {"weights": np.zeros(3, np.float32)},
    }
    path = str(tmp_path / "ref.npy")
    np.save(path, ref)
    want = JW.load_npy_weights(P, path, log=None)
    params = params_from_jax(P, device="cpu")
    assert TC.load_pretrained(params, path) is params
    got = params_to_jax(params)
    assert set(got) == set(want)
    for name in want:
        for sub in ("weights", "biases"):
            np.testing.assert_array_equal(got[name][sub],
                                          np.asarray(want[name][sub]),
                                          err_msg=name + "/" + sub)
    np.testing.assert_array_equal(got["conv1_1"]["weights"],
                                  P["conv1_1"]["weights"])
    np.testing.assert_array_equal(got["conv1_1_2"]["weights"],
                                  ref["conv1_1_2"]["weights"])
    with pytest.raises(ValueError):
        load_npy_weights(params_from_jax(P, device="cpu"), ref,
                         ignore_missing=False, log=None)


def test_snapshots_round_trip(tmp_path, monkeypatch):
    monkeypatch.setattr(tcfg.TRAIN, "SNAPSHOT_INFIX", "")
    P = he_normal_params(2, fc_dim=8)
    params = params_from_jax(P, device="cpu")
    out = str(tmp_path / "snap")
    assert TC.latest_snapshot(out) is None
    TC.save_checkpoint(out, 10, params)
    path = TC.save_checkpoint(out, 200, params)
    assert TC.latest_snapshot(out) == path
    assert os.path.basename(path) == TC.snapshot_name(200) + ".pt"
    fresh = params_from_jax(he_normal_params(3, fc_dim=8), device="cpu")
    TC.load_pretrained(fresh, path)
    for (k, a), (_, b) in zip(params.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="orbax"):
        TC.load_pretrained(fresh, str(tmp_path))
