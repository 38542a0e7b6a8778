"""The port's data layer against the JAX package's on CPU: the synthetic
KITTI-layout generator file for file, the numpy box twins, the KITTI imdb
(roidb, calib, prepare_roidb), the frame loaders, and the imdb base's
recall and box-list roidb."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu import geometry_np as JG  # noqa: E402
from mv3d_tf_tpu.config import cfg as jcfg  # noqa: E402
from mv3d_tf_tpu.data import kitti as JK  # noqa: E402
from mv3d_tf_tpu.data import loader as JL  # noqa: E402
from mv3d_tf_tpu.data import synthetic as JS  # noqa: E402
from mv3d_tf_tpu_torch import geometry_np as TG  # noqa: E402
from mv3d_tf_tpu_torch.config import cfg as tcfg  # noqa: E402
from mv3d_tf_tpu_torch.data import kitti as TK  # noqa: E402
from mv3d_tf_tpu_torch.data import loader as TL  # noqa: E402
from mv3d_tf_tpu_torch.data import synthetic as TS  # noqa: E402

GEN = dict(num_frames=3, cars_per_frame=2, seed=11, image_hw=(120, 400))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One seed written by each package's generator."""
    base = tmp_path_factory.mktemp("synthetic")
    return (JS.generate(str(base / "jax"), **GEN),
            TS.generate(str(base / "port"), **GEN))


@pytest.fixture
def imdbs(trees, tmp_path, monkeypatch):
    """Both packages' KittiMV3D on the JAX-written tree, each caching its
    roidb under its own data dir in tmp_path."""
    monkeypatch.setattr(jcfg, "DATA_DIR", str(tmp_path / "jax_data"))
    monkeypatch.setattr(tcfg, "DATA_DIR", str(tmp_path / "port_data"))
    monkeypatch.setattr(tcfg, "ROOT_DIR", str(tmp_path))
    return (JK.KittiMV3D("train", kitti_path=trees[0]),
            TK.KittiMV3D("train", kitti_path=trees[0]))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_generator_writes_the_same_files(trees):
    """Labels, calib, scans, rasters, splits and the Pillow-drawn images:
    byte for byte."""
    jroot, troot = trees
    names = _files(jroot)
    assert names == _files(troot)
    assert any(n.endswith(".png") for n in names)
    assert any(n.endswith(".npy") for n in names)
    for name in names:
        with open(os.path.join(jroot, name), "rb") as a, \
                open(os.path.join(troot, name), "rb") as b:
            assert a.read() == b.read(), name


def test_geometry_np_twins_equal():
    rng = np.random.RandomState(4)
    box = np.array([1.5, 1.65, 20.0, 4.1, 1.6, 1.5], np.float32)
    Tr = JS.TR_VELO2CAM
    for ry in rng.uniform(-np.pi, np.pi, 4):
        cnr = TG.compute_corners_3d_np(box, ry)
        np.testing.assert_array_equal(cnr, JG.compute_corners_3d_np(box, ry))
        lid = TG.camera_to_lidar_cnr_np(cnr, Tr)
        np.testing.assert_array_equal(lid, JG.camera_to_lidar_cnr_np(cnr, Tr))
        np.testing.assert_array_equal(
            TG.lidar_cnr_to_3d_np(lid[0], box[3:6]),
            JG.lidar_cnr_to_3d_np(lid[0], box[3:6]))
        np.testing.assert_array_equal(TG.project_to_image_np(cnr, JS.P2),
                                      JG.project_to_image_np(cnr, JS.P2))
    rois = rng.uniform([0, -20, -2, 3, 1.4, 1.3], [60, 20, 0, 5, 1.9, 1.8],
                       (6, 6)).astype(np.float32)
    np.testing.assert_array_equal(TG.lidar_3d_to_bv_np(rois),
                                  JG.lidar_3d_to_bv_np(rois))
    anchors = rng.uniform(0, 600, (5, 4)).astype(np.float32)
    np.testing.assert_array_equal(TG.bv_anchor_to_lidar_np(anchors),
                                  JG.bv_anchor_to_lidar_np(anchors))


def _assert_entries_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


def test_kitti_imdb_equals_jax(imdbs):
    """roidb entries, calib blobs and prepare_roidb's additions, exactly;
    the roidb comes back from its cache unchanged."""
    jimdb, timdb = imdbs
    assert timdb.name == jimdb.name and timdb.classes == jimdb.classes
    assert timdb.image_index == jimdb.image_index
    want = JK.prepare_roidb(jimdb)
    got = TK.prepare_roidb(timdb)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_entries_equal(g, w)
    for i in range(timdb.num_images):
        np.testing.assert_array_equal(timdb.calib_at(i), jimdb.calib_at(i))
        assert timdb.image_path_at(i) == jimdb.image_path_at(i)
        assert timdb.lidar_path_at(i) == jimdb.lidar_path_at(i)
    cached = TK.KittiMV3D("train", kitti_path=timdb._kitti_path).roidb
    for g, w in zip(cached, jimdb.gt_roidb()):
        _assert_entries_equal(g, w)


def test_loaders_equal_jax(imdbs):
    jimdb, timdb = imdbs
    want = JK.prepare_roidb(jimdb)
    got = TK.prepare_roidb(timdb)
    path = timdb.image_path_at(0)
    img = TL.load_image_bgr(path)
    assert img.dtype == np.float32 and img.shape == (120, 400, 3)
    np.testing.assert_array_equal(img, JL.load_image_bgr(path))
    np.testing.assert_array_equal(TL.pad_image(img), JL.pad_image(img))
    for g, w in zip(got, want):
        _assert_entries_equal(TL.get_minibatch(g), JL.get_minibatch(w))
        _assert_entries_equal(TL.pad_gt(g, max_gt=1), JL.pad_gt(w, max_gt=1))


def test_recall_and_box_list_roidb_equal_jax(imdbs):
    jimdb, timdb = imdbs
    rng = np.random.RandomState(9)
    boxes = [np.concatenate([e["boxes"] + rng.uniform(-8, 8, e["boxes"].shape),
                             rng.uniform(0, 300, (5, 4))]).astype(np.float32)
             for e in jimdb.roidb]
    for kw in ({}, {"limit": 3}, {"thresholds": np.array([0.3, 0.6])}):
        got = timdb.evaluate_recall(boxes, **kw)
        want = jimdb.evaluate_recall(boxes, **kw)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       err_msg=key)
    got = timdb.create_roidb_from_box_list(boxes, timdb.roidb)
    want = jimdb.create_roidb_from_box_list(boxes, jimdb.roidb)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["gt_classes"], w["gt_classes"])
        np.testing.assert_allclose(g["gt_overlaps"], w["gt_overlaps"],
                                   rtol=1e-6)


def test_get_imdb_reads_kitti_splits_only(trees, tmp_path, monkeypatch):
    monkeypatch.setattr(tcfg, "DATA_DIR", str(tmp_path))
    imdb = TK.get_imdb("kitti_val", kitti_path=trees[1])
    assert imdb.num_images == 1
    assert TK.get_imdb("kitti_val", kitti_path=trees[1]) is imdb
    for name in ("coco", "kitti_minival", "nissan_val"):
        with pytest.raises(KeyError, match="Unknown dataset: " + name):
            TK.get_imdb(name)
