"""The port's image-pyramid data path (mv3d_tf_tpu_torch/data/multiscale.py)
against mv3d_tf_tpu/data/multiscale.py on the same seeded inputs: the bbox
targets and their per-class normalization, the pyramid blob (PIL bilinear
per channel, flipped entries included), the 224^2 level rule, the fg/bg
roi sampling and the minibatch with one np.random.RandomState seed on both
sides (the same draws in the same order, so the states agree afterwards),
the padding to the step's bucket, and the gt_data_layer half (info_boxes,
their normalization, the gt minibatch). Every comparison is bit for bit."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu.config import cfg as jcfg  # noqa: E402
from mv3d_tf_tpu.data import multiscale as JM  # noqa: E402
from mv3d_tf_tpu_torch.config import cfg as tcfg  # noqa: E402
from mv3d_tf_tpu_torch.data import multiscale as TM  # noqa: E402
from mv3d_tf_tpu_torch.data.imdb_base import bbox_overlaps  # noqa: E402

SCALES = (1.0, 1.5, 2.0)


@pytest.fixture
def roidb(tmp_path):
    """Three images (60x80, 52x70, 60x80) with 2-3 gt boxes of classes 1
    and 2 and 12 jittered proposals each; the third entry is flipped."""
    from PIL import Image
    rng = np.random.RandomState(7)
    out = []
    for i, (h, w) in enumerate(((60, 80), (52, 70), (60, 80))):
        p = tmp_path / "im{}.png".format(i)
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(p)
        gt = np.array([[10, 10, 30, 40], [40, 20, 66, 50],
                       [5, 30, 25, 50]][:2 + i % 2], np.float32)
        prop = np.vstack([gt[k % len(gt)] + rng.randint(-9, 10, 4)
                          for k in range(12)]).clip(0, w - 1)
        prop[:, 2:] = np.maximum(prop[:, 2:], prop[:, :2] + 1)
        boxes = np.vstack([gt, prop]).astype(np.uint16)
        cls = np.array([1, 2, 1][:len(gt)], np.int32)
        ov = bbox_overlaps(boxes.astype(np.float32), gt)
        gt_classes = np.zeros(len(boxes), np.int32)
        gt_classes[:len(gt)] = cls
        gt_overlaps = np.zeros((len(boxes), 3), np.float32)
        gt_overlaps[np.arange(len(boxes)), cls[ov.argmax(1)]] = ov.max(1)
        out.append({"image": str(p), "flipped": i == 2, "boxes": boxes,
                    "gt_classes": gt_classes, "gt_overlaps": gt_overlaps,
                    "max_classes": gt_overlaps.argmax(1),
                    "max_overlaps": gt_overlaps.max(1)})
    return out


@pytest.fixture
def both_cfgs(monkeypatch):
    for c in (jcfg, tcfg):
        monkeypatch.setattr(c, "IS_MULTISCALE", True)
        monkeypatch.setattr(c.TRAIN, "SCALES_BASE", SCALES)
        monkeypatch.setattr(c.TRAIN, "BATCH_SIZE", 24)


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_bbox_targets_and_normalization(roidb):
    rng = np.random.RandomState(1)
    ex = rng.uniform(0, 60, (20, 4))
    ex[:, 2:] += ex[:, :2] + 10
    gt = ex + rng.uniform(-4, 4, (20, 4))
    np.testing.assert_array_equal(TM.compute_bbox_targets(ex, gt),
                                  JM.compute_bbox_targets(ex, gt))
    a, b = copy.deepcopy(roidb), copy.deepcopy(roidb)
    got = TM.add_bbox_regression_targets(a, 3)
    want = JM.add_bbox_regression_targets(b, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (12,)
    for ea, eb in zip(a, b):
        np.testing.assert_array_equal(ea["bbox_targets"], eb["bbox_targets"])
    assert (np.vstack([e["bbox_targets"] for e in a])[:, 0] == 2).any()


def test_image_blob_and_level_rule(roidb, both_cfgs):
    blob, scales = TM.get_image_blob_multiscale(roidb)
    jblob, jscales = JM.get_image_blob_multiscale(roidb)
    assert blob.shape == (9, 120, 160, 3) and scales == jscales
    np.testing.assert_array_equal(blob, jblob)
    rois = np.vstack([e["boxes"] for e in roidb]).astype(np.float32)
    rois = np.vstack([rois, [[0, 0, 223, 223], [0, 0, 149, 149]]])
    got, want = (m.project_im_rois_multiscale(rois, SCALES)
                 for m in (TM, JM))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert set(got[1].ravel()) == {0, 1, 2}
    compact = np.array([[0, 0, 0, 0, 0], [2, .1, .2, .3, .4],
                        [1, -1, 1, -2, 2]], np.float32)
    for g, w in zip(TM._expand_bbox_labels(compact, 3),
                    JM._expand_bbox_labels(compact, 3)):
        np.testing.assert_array_equal(g, w)


def test_sample_rois_and_minibatch_same_draws(roidb, both_cfgs):
    a, b = copy.deepcopy(roidb), copy.deepcopy(roidb)
    TM.add_bbox_regression_targets(a, 3)
    JM.add_bbox_regression_targets(b, 3)
    for fg, per in ((2, 8), (4, 12), (6, 20)):
        ra, rb = np.random.RandomState(5), np.random.RandomState(5)
        for g, w in zip(TM.sample_rois(a[0], fg, per, 3, ra),
                        JM.sample_rois(b[0], fg, per, 3, rb)):
            np.testing.assert_array_equal(g, w)
        assert str(ra.get_state()) == str(rb.get_state())
    ra, rb = np.random.RandomState(9), np.random.RandomState(9)
    for _ in range(2):
        got = TM.get_minibatch_multiscale(a, 3, rng=ra)
        want = JM.get_minibatch_multiscale(b, 3, rng=rb)
        _equal(got, want)
    assert str(ra.get_state()) == str(rb.get_state())
    assert got["rois"].shape == (24, 5) and got["data"].shape[0] == 9
    assert set(got["rois"][:, 0].astype(int)) <= set(range(9))
    for bucket, n in (((96, 128), 24), ((140, 200), 32)):
        _equal(TM.pad_minibatch_multiscale(got, bucket, n),
               JM.pad_minibatch_multiscale(want, bucket, n))


class _FakeImdb:
    """The gt_data_layer's view of an imdb: roidb, image_index, paths."""

    def __init__(self, roidb):
        self.roidb = roidb
        self.image_index = list(range(len(roidb)))
        self.num_classes = 3

    def image_path_at(self, i):
        return self.roidb[i]["image"]


def test_gt_data_layer(roidb):
    dbs = []
    for _ in range(2):
        db = copy.deepcopy(roidb)
        for e in db:
            n = int((e["gt_classes"] > 0).sum())
            e["boxes"] = e["boxes"][:n]
            e["gt_classes"] = e["gt_classes"][:n]
            e["gt_overlaps"] = e["gt_overlaps"][:n]
        dbs.append(db)
    kw = dict(scales=(1.0, 2.0), scale_mapping=(0, 1), fg_thresh=0.3)
    got = TM.prepare_gt_roidb(_FakeImdb(dbs[0]), **kw)
    want = JM.prepare_gt_roidb(_FakeImdb(dbs[1]), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["info_boxes"], w["info_boxes"])
    assert sum(len(e["info_boxes"]) for e in got) > 0
    for g, w in zip(TM.add_info_boxes_regression_targets(got),
                    JM.add_info_boxes_regression_targets(want)):
        np.testing.assert_array_equal(g, w)
    mb = dict(scales=(1.0, 2.0), scale_mapping=(0, 1), aspects=(1, 0.5),
              aspect_heights=(1.0, 2.0), aspect_widths=(1.0, 0.5))
    _equal(TM.get_minibatch_gt(got, **mb), JM.get_minibatch_gt(want, **mb))
