"""The port's legacy 2D solver loops against the JAX package's on CPU, on a
synthetic VOC tree at a small bucket: train_net_2d (HAS_RPN on) with JAX's
draws injected, its snapshot unnormalization, the HAS_RPN-off dispatch to
Fast R-CNN over selective-search proposals, and test_net_2d on the same
weights. fc6/fc7 are narrowed to 64 in both
packages by monkeypatching init_params_2d (the full 25088x4096 fc6 would
make the runs slow); the trunk is full width. rpn_generate and the 2D CLIs
are tests/test_torch_tools_2d.py's."""

import functools
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from mv3d_tf_tpu import solver as JS  # noqa: E402
from mv3d_tf_tpu.config import cfg as jcfg  # noqa: E402
from mv3d_tf_tpu.data.kitti import get_imdb as j_get_imdb  # noqa: E402
from mv3d_tf_tpu.models import vggnet as JV  # noqa: E402
from mv3d_tf_tpu_torch import faster_rcnn_2d as T2  # noqa: E402
from mv3d_tf_tpu_torch import solver as TS  # noqa: E402
from mv3d_tf_tpu_torch.config import cfg as tcfg  # noqa: E402
from mv3d_tf_tpu_torch.data import synthetic  # noqa: E402
from mv3d_tf_tpu_torch.data.kitti import get_imdb as t_get_imdb  # noqa: E402
from mv3d_tf_tpu_torch.models import vggnet as TV  # noqa: E402
from mv3d_tf_tpu_torch.utils.weights import (he_normal_params_2d,  # noqa: E402
                                             params_from_jax, params_to_jax)

FC = 64
BUCKET = (160, 224)            # a 10x14 grid: some anchors lie inside
SMALL_CFG = {("TRAIN", "SCALES"): (160,), ("TRAIN", "MAX_SIZE"): 224,
             ("TEST", "SCALES"): (160,), ("TEST", "MAX_SIZE"): 224,
             ("TRAIN", "RPN_PRE_NMS_TOP_N"): 120,
             ("TRAIN", "RPN_POST_NMS_TOP_N"): 24,
             ("TEST", "RPN_PRE_NMS_TOP_N"): 120,
             ("TEST", "RPN_POST_NMS_TOP_N"): 24,
             ("TRAIN", "BATCH_SIZE"): 16, ("TRAIN", "HAS_RPN"): True,
             ("TRAIN", "SNAPSHOT_ITERS"): 1000, ("TRAIN", "DISPLAY"): 1}
ITERS = 3
# the training loop's lr in its test: at the config's 1e-3 a step moves the He-scaled
# weights so far that float32 rounding, amplified through the discrete
# proposal and sampling choices, sets the third iteration's loss apart by
# ~1e-2 in both directions; at 1e-5 the runs agree to the printed digit
LOOP_LR = 1e-5


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    return synthetic.generate_voc(
        str(tmp_path_factory.mktemp("voc") / "VOCdevkit"), num_images=4,
        seed=1)


@pytest.fixture
def small(tmp_path, monkeypatch):
    """Both configs at the small sizes, outputs and caches in tmp_path, and
    both packages' 2D init narrowed to fc 64."""
    for c, sub in ((jcfg, "jax"), (tcfg, "port")):
        monkeypatch.setattr(c, "ROOT_DIR", str(tmp_path / sub))
        monkeypatch.setattr(c, "DATA_DIR", str(tmp_path / sub / "data"))
        for (sect, key), v in SMALL_CFG.items():
            monkeypatch.setattr(c[sect], key, v)
    monkeypatch.setattr(JV, "init_params_2d",
                        functools.partial(JV.init_params_2d, fc_dim=FC))
    monkeypatch.setattr(TV, "init_params_2d",
                        functools.partial(TV.init_params_2d, fc_dim=FC))
    np.save(str(tmp_path / "he.npy"), he_normal_params_2d(7, fc_dim=FC))
    return tmp_path


def _imdbs(devkit, split):
    jimdb = j_get_imdb("voc_2007_" + split, devkit_path=devkit)
    timdb = t_get_imdb("voc_2007_" + split, devkit_path=devkit)
    for imdb in (jimdb, timdb):
        imdb._roidb = None              # each package's cache under its own
    return jimdb, timdb


def _roidb(imdb):
    roidb = imdb.roidb
    for i, entry in enumerate(roidb):
        entry.setdefault("image_path", imdb.image_path_at(i))
    return roidb


def _jax_draws_2d(key, n_anchors, n_all, n_rois, fc, keep_prob):
    """JAX's 2D step draws from its key (faster_rcnn_2d.py:276, :114, :147,
    vggnet.py:73-77)."""
    k_anchor, k_roi, k_drop = jax.random.split(key, 3)

    def pair(k, n):
        return [torch.tensor(np.asarray(jax.random.uniform(s, (n,))))
                for s in jax.random.split(k)]

    a_fg, a_bg = pair(k_anchor, n_anchors)
    r_fg, r_bg = pair(k_roi, n_all)
    drop = tuple(torch.tensor(np.asarray(jax.random.bernoulli(
        k, keep_prob, (n_rois, fc)))) for k in jax.random.split(k_drop))
    return {"anchor_fg": a_fg, "anchor_bg": a_bg, "roi_fg": r_fg,
            "roi_bg": r_bg, "drop": drop}


def test_train_net_2d_matches_jax(devkit, small, monkeypatch):
    """Three iterations of both training loops at lr LOOP_LR from the same .npy
    weights, the port on JAX's draws rebuilt from train_net_2d's key chain
    (PRNGKey(seed), split for the init, then one split per iteration): the
    logged losses within 1e-4 relative, every trained layer within 1e-2 in
    relative norm of its move (a ReLU whose pre-activation is within
    rounding of 0 switches in one package only: ~3e-3 in the trunk),
    conv1/conv2 bit for bit unchanged, and the .pt snapshot holding the
    params the run returns, with momentum for the trained layers only."""
    for c in (jcfg, tcfg):
        monkeypatch.setattr(c.TRAIN, "LEARNING_RATE", LOOP_LR)
    jimdb, timdb = _imdbs(devkit, "trainval")
    he = str(small / "he.npy")
    jlogs, tlogs = [], []
    jparams = JS.train_net_2d(jimdb, _roidb(jimdb), str(small / "jout"),
                              pretrained_model=he, max_iters=ITERS,
                              bucket_hw=BUCKET, log=jlogs.append)

    key = jax.random.PRNGKey(tcfg.RNG_SEED)
    key, _ = jax.random.split(key)
    steps = []
    for _ in range(ITERS):
        key, k_step = jax.random.split(key)
        steps.append(k_step)
    calls = []

    def jax_draws(gen, n_anchors, n_all, n_rois, fc, keep_prob, device):
        calls.append((n_anchors, n_all, n_rois, fc))
        return _jax_draws_2d(steps[len(calls) - 1], n_anchors, n_all, n_rois,
                             fc, keep_prob)

    monkeypatch.setattr(T2, "make_draws_2d", jax_draws)
    out_dir = str(small / "tout")
    tparams = TS.train_net_2d(timdb, _roidb(timdb), out_dir,
                              pretrained_model=he, max_iters=ITERS,
                              bucket_hw=BUCKET, log=tlogs.append,
                              device="cpu")
    assert calls == [(10 * 14 * 9, 24 + 32, 16, FC)] * ITERS

    def losses(logs):
        return [float(line.split("total loss: ")[1].split()[0])
                for line in logs if "total loss" in line]

    assert len(losses(tlogs)) == ITERS
    np.testing.assert_allclose(losses(tlogs), losses(jlogs), rtol=1e-4)
    start = np.load(he, allow_pickle=True).item()
    got = params_to_jax(tparams)
    for name, sub in got.items():
        for s, a in sub.items():
            b = np.asarray(jparams[name][s])
            if name in TV.FROZEN_2D:
                np.testing.assert_array_equal(a, start[name][s])
                np.testing.assert_array_equal(b, start[name][s])
                continue
            moved = np.linalg.norm(b - start[name][s])
            assert moved > 0, (name, s)
            assert np.linalg.norm(a - b) <= 1e-2 * moved, (name, s)
    blob = torch.load(os.path.join(out_dir, "VGGnet_fast_rcnn_iter_3.pt"),
                      weights_only=True)
    for k, v in tparams.state_dict().items():
        assert torch.equal(blob["params"][k], v), k
    assert len(blob["opt"]["state"]) == len(list(tparams.parameters())) - 8


def test_train_net_2d_snapshot_unnormalizes(devkit, small, monkeypatch):
    """With BBOX_NORMALIZE_TARGETS_PRECOMPUTED on, the snapshot holds
    snapshot_unnormalize_2d of the params the run returns."""
    monkeypatch.setattr(tcfg.TRAIN, "BBOX_NORMALIZE_TARGETS_PRECOMPUTED",
                        True)
    _, timdb = _imdbs(devkit, "train")
    out_dir = str(small / "norm")
    params = TS.train_net_2d(timdb, _roidb(timdb), out_dir, max_iters=1,
                             bucket_hw=BUCKET, log=lambda s: None,
                             device="cpu")
    blob = torch.load(os.path.join(out_dir, "VGGnet_fast_rcnn_iter_1.pt"),
                      weights_only=True)["params"]
    want = T2.snapshot_unnormalize_2d(params, n_classes=21)
    assert torch.equal(blob["bbox_pred.weight"], want["bbox_pred"].weight)
    assert torch.equal(blob["bbox_pred.bias"], want["bbox_pred"].bias)
    assert not torch.equal(blob["bbox_pred.weight"],
                           params["bbox_pred"].weight)


def test_train_net_2d_refuses_without_rpn(devkit, small, monkeypatch):
    """With HAS_RPN off train_net_2d no longer refuses: it trains Fast
    R-CNN (solver.train_net_fast_rcnn) over a selective-search roidb (a
    .mat of [y1 x1 y2 x2] 1-based boxes: each gt box, shifted and
    shrunk copies) one iteration, and its snapshot holds JAX's
    snapshot_unnormalize_2d of the params the run returns, with the
    per-class target stats of JAX's add_bbox_regression_targets on the
    same roidb, bit for bit."""
    import copy

    import scipy.io as sio

    from mv3d_tf_tpu.data import multiscale as JM
    from mv3d_tf_tpu.faster_rcnn_2d import snapshot_unnormalize_2d
    monkeypatch.setattr(tcfg.TRAIN, "HAS_RPN", False)
    _, timdb = _imdbs(devkit, "train")
    gt = [e["boxes"].astype(np.float64) for e in timdb.gt_roidb()]
    cell = np.empty((1, len(gt)), object)
    for i, g in enumerate(gt):
        boxes = np.vstack([g, g + 6, g + [4, 4, -4, -4], g + [-9, 3, 9, 3]])
        cell[0, i] = boxes[:, (1, 0, 3, 2)] + 1
    ss = os.path.join(devkit, "selective_search_data")
    os.makedirs(ss, exist_ok=True)
    sio.savemat(os.path.join(ss, "voc_2007_train.mat"), {"boxes": cell})
    timdb.roidb_handler = timdb.selective_search_roidb
    roidb = _roidb(timdb)
    for e in roidb:
        e["max_classes"] = e["gt_overlaps"].argmax(axis=1)
        e["max_overlaps"] = e["gt_overlaps"].max(axis=1)
    means, stds = JM.add_bbox_regression_targets(copy.deepcopy(roidb), 21)
    out_dir = str(small / "frcn")
    params = TS.train_net_2d(timdb, roidb, out_dir, max_iters=1,
                             bucket_hw=BUCKET, log=lambda s: None,
                             device="cpu")
    want = snapshot_unnormalize_2d(params_to_jax(params), means, stds, 21)
    blob = torch.load(os.path.join(out_dir, "VGGnet_fast_rcnn_iter_1.pt"),
                      weights_only=True)["params"]
    np.testing.assert_array_equal(
        blob["bbox_pred.weight"].numpy().T,
        np.asarray(want["bbox_pred"]["weights"], np.float32))
    np.testing.assert_array_equal(
        blob["bbox_pred.bias"].numpy(),
        np.asarray(want["bbox_pred"]["biases"], np.float32))
    assert not torch.equal(blob["bbox_pred.weight"],
                           params["bbox_pred"].weight)


def test_test_net_2d_matches_jax(devkit, small):
    """The same He weights through both evaluation loops over the test
    split: per class and image the same number of detections, boxes within
    1e-4 relative + 1e-2 px (image coordinates, the decode's exp amplifying
    float32 conv rounding) and scores within 1e-4, and
    the same VOC APs; the detections pickle is written."""
    jimdb, timdb = _imdbs(devkit, "test")
    np_params = he_normal_params_2d(8, fc_dim=FC)
    kw = dict(bucket_hw=BUCKET, thresh=0.0, log=lambda s: None)
    want = JS.test_net_2d(np_params, jimdb, **kw)
    got = TS.test_net_2d(params_from_jax(np_params, device="cpu"), timdb,
                         **kw)
    assert got == want and len(got) == 20
    with open(os.path.join(tcfg.ROOT_DIR, "output", "default",
                           "voc_2007_test", "default",
                           "detections.pkl"), "rb") as f:
        port_boxes = pickle.load(f)
    with open(os.path.join(jcfg.ROOT_DIR, "output", "default",
                           "voc_2007_test", "default",
                           "detections.pkl"), "rb") as f:
        jax_boxes = pickle.load(f)
    n = 0
    for c in range(1, 21):
        for i in range(4):
            a, b = port_boxes[c][i], jax_boxes[c][i]
            assert a.shape == b.shape, (c, i)
            np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=1e-4,
                                       atol=1e-2)
            np.testing.assert_allclose(a[:, 4], b[:, 4], rtol=0, atol=1e-4)
            n += len(a)
    assert n > 0
