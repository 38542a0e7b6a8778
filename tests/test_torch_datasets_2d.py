"""The port's legacy 2D data layer against the JAX package's on CPU: the
image blob helpers, ds_utils, PASCAL VOC (gt roidb, result files, AP) on a
synthetic VOC tree, KITTI-2D (filters, result files, the 2D AP table) and
get_imdb's new names. Host numpy code: every comparison is exact."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu.config import cfg as jcfg  # noqa: E402
from mv3d_tf_tpu.data import blob as JB  # noqa: E402
from mv3d_tf_tpu.data import ds_utils as JD  # noqa: E402
from mv3d_tf_tpu.data import kitti_2d as JK2  # noqa: E402
from mv3d_tf_tpu.data import pascal_voc as JP  # noqa: E402
from mv3d_tf_tpu_torch.config import cfg as tcfg  # noqa: E402
from mv3d_tf_tpu_torch.data import blob as TB  # noqa: E402
from mv3d_tf_tpu_torch.data import ds_utils as TD  # noqa: E402
from mv3d_tf_tpu_torch.data import kitti as TK  # noqa: E402
from mv3d_tf_tpu_torch.data import kitti_2d as TK2  # noqa: E402
from mv3d_tf_tpu_torch.data import pascal_voc as TP  # noqa: E402
from mv3d_tf_tpu_torch.data import synthetic as TS  # noqa: E402

MEANS = np.array([[[102.9801, 115.9465, 122.7717]]])


@pytest.fixture
def data_dirs(tmp_path, monkeypatch):
    monkeypatch.setattr(jcfg, "DATA_DIR", str(tmp_path / "jax_data"))
    monkeypatch.setattr(tcfg, "DATA_DIR", str(tmp_path / "port_data"))
    return tmp_path


@pytest.mark.parametrize("hw,target,max_size", [
    ((300, 500), 600, 1000), ((300, 600), 600, 1000), ((375, 500), 96, 160),
    ((41, 37), 600, 2000)])
def test_prep_im_for_blob_bit_for_bit(hw, target, max_size):
    """Pillow's mode-F bilinear per channel in both packages: the same
    array and the same scale."""
    im = (np.random.RandomState(hw[0]).rand(*hw, 3) * 255).astype(np.float32)
    got, scale = TB.prep_im_for_blob(im, MEANS, target, max_size)
    want, jscale = JB.prep_im_for_blob(im, MEANS, target, max_size)
    assert scale == jscale
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_im_list_to_blob_equals_jax():
    rng = np.random.RandomState(1)
    ims = [rng.rand(10, 20, 3), rng.rand(15, 12, 3), rng.rand(3, 30, 3)]
    got = TB.im_list_to_blob(ims)
    assert got.shape == (3, 15, 30, 3)
    np.testing.assert_array_equal(got, JB.im_list_to_blob(ims))


def test_ds_utils_equal_jax():
    rng = np.random.RandomState(2)
    boxes = np.round(rng.rand(60, 4) * 100).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    boxes[40:50] = boxes[:10]                          # duplicates
    for scale in (1.0, 1.0 / 16):
        np.testing.assert_array_equal(TD.unique_boxes(boxes, scale),
                                      JD.unique_boxes(boxes, scale))
    assert len(TD.unique_boxes(boxes)) <= 50
    np.testing.assert_array_equal(TD.xywh_to_xyxy(boxes),
                                  JD.xywh_to_xyxy(boxes))
    np.testing.assert_array_equal(TD.xyxy_to_xywh(boxes),
                                  JD.xyxy_to_xywh(boxes))
    for min_size in (0, 20, 60):
        np.testing.assert_array_equal(TD.filter_small_boxes(boxes, min_size),
                                      JD.filter_small_boxes(boxes, min_size))
    TD.validate_boxes(boxes, width=300, height=300)
    with pytest.raises(AssertionError):
        TD.validate_boxes(boxes, width=100, height=300)


@pytest.fixture
def voc(data_dirs):
    devkit = TS.generate_voc(str(data_dirs / "VOCdevkit"), num_images=4,
                             seed=3)
    return (JP.PascalVOC("trainval", "2007", devkit),
            TP.PascalVOC("trainval", "2007", devkit))


def _roidb_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


def _random_dets(rng, roidb, n_classes, jitter):
    """all_boxes[cls][image]: each gt jittered, plus random false boxes."""
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in roidb]
                 for _ in range(n_classes)]
    for i, e in enumerate(roidb):
        for b, c in zip(e["boxes"].astype(np.float32), e["gt_classes"]):
            d = np.concatenate([b + rng.randn(4) * jitter, [rng.rand()]])
            all_boxes[c][i] = np.vstack([all_boxes[c][i], d[None]])
        for c in rng.randint(1, n_classes, 3):
            xy = rng.rand(2) * 200
            d = np.concatenate([xy, xy + 50 + rng.rand(2) * 100,
                                [rng.rand()]])
            all_boxes[c][i] = np.vstack([all_boxes[c][i], d[None]])
    return [[a.astype(np.float32) for a in row] for row in all_boxes]


def test_pascal_voc_roidb_and_ap_equal_jax(voc, capsys):
    """The gt roidb of the synthetic tree (difficult objects left out) and
    the per-class APs (VOC07 11-point) of the same detections."""
    jimdb, timdb = voc
    assert timdb.num_images == 4 and timdb.num_classes == 21
    assert timdb.image_path_at(1) == jimdb.image_path_at(1)
    _roidb_equal(timdb.roidb, jimdb.roidb)
    n_objs = sum(len(e["gt_classes"]) for e in timdb.roidb)
    assert n_objs == 4 * 3 - 2                 # two difficult ones left out
    all_boxes = _random_dets(np.random.RandomState(4), timdb.roidb, 21, 4.0)
    want = jimdb.evaluate_detections(all_boxes)
    got = timdb.evaluate_detections(all_boxes, output_dir=None)
    assert got == want
    assert any(v > 0 for v in got.values())
    assert "Mean AP" in capsys.readouterr().out


def test_voc_ap_equals_jax():
    rng = np.random.RandomState(5)
    rec = np.sort(rng.rand(30))
    prec = rng.rand(30)
    for use_07 in (False, True):
        assert TP.voc_ap(rec, prec, use_07) == JP.voc_ap(rec, prec, use_07)


def _kitti_layout(root):
    """Two frames: a Car, a Van (read as Car), a Pedestrian, a truncated Car
    and a 20 px Cyclist (both filtered out), then a Cyclist
    (tests/test_kitti_2d.py's labels)."""
    os.makedirs(os.path.join(root, "ImageSets"))
    lbl = os.path.join(root, "object", "training", "label_2")
    os.makedirs(lbl)
    with open(os.path.join(root, "ImageSets", "train.txt"), "w") as f:
        f.write("000000\n000001\n")
    with open(os.path.join(lbl, "000000.txt"), "w") as f:
        f.write("Car 0.0 0 0.0 100 100 200 160 1.5 1.6 3.9 0 0 10 0.0\n"
                "Van 0.1 1 0.0 300 120 400 170 2.0 1.9 5.0 5 0 15 0.0\n"
                "Pedestrian 0.0 0 0.0 500 100 520 170 1.8 0.6 0.8 -5 0 12 0\n"
                "Car 0.6 0 0.0 600 100 700 160 1.5 1.6 3.9 8 0 20 0.0\n"
                "Cyclist 0.0 0 0.0 50 100 70 120 1.7 0.6 1.7 -8 0 18 0.0\n")
    with open(os.path.join(lbl, "000001.txt"), "w") as f:
        f.write("Cyclist 0.0 2 0.0 200 150 260 230 1.7 0.6 1.7 2 0 9 0.0\n")
    return root


def test_kitti_2d_roidb_results_and_ap_equal_jax(data_dirs, capsys):
    """Filters, Van remap, the result files and the 2D AP table at easy,
    moderate and hard (the port's data/kitti_eval on its C++ matcher,
    JAX's on its own or its numpy loop: equal)."""
    root = _kitti_layout(str(data_dirs / "kitti2d"))
    jimdb = JK2.Kitti2D("train", kitti_path=root)
    timdb = TK2.Kitti2D("train", kitti_path=root)
    _roidb_equal(timdb.roidb, jimdb.roidb)
    assert timdb.roidb[0]["gt_classes"].tolist() == [1, 1, 2]
    all_boxes = _random_dets(np.random.RandomState(6), timdb.roidb, 4, 2.0)
    want = jimdb.evaluate_detections(all_boxes, str(data_dirs / "jax_out"))
    got = timdb.evaluate_detections(all_boxes, str(data_dirs / "port_out"))
    assert got == want
    assert got["Car"]["easy"] > 0
    for name in ("000000.txt", "000001.txt", "detections.txt"):
        with open(data_dirs / "jax_out" / name) as a, \
                open(data_dirs / "port_out" / name) as b:
            assert a.read() == b.read(), name
    assert "2D AP" in capsys.readouterr().out


def test_get_imdb_reads_voc_and_kitti2d(data_dirs):
    """voc_<year>_<split> under devkit_path, kitti2d_<split> under
    kitti_path, one instance per name and root; a name of no dataset
    raises KeyError, naming the known ones (the other 2D datasets are
    tests/test_torch_datasets_extra.py's)."""
    devkit = TS.generate_voc(str(data_dirs / "VOCdevkit"), num_images=2)
    voc = TK.get_imdb("voc_2007_test", devkit_path=devkit)
    assert isinstance(voc, TP.PascalVOC) and voc.num_images == 2
    assert TK.get_imdb("voc_2007_test", devkit_path=devkit) is voc
    root = _kitti_layout(str(data_dirs / "kitti2d"))
    k2 = TK.get_imdb("kitti2d_train", kitti_path=root)
    assert isinstance(k2, TK2.Kitti2D) and k2.name == "kitti2d_train"
    for name in ("kitti_minival", "coco", "pascal3d", "nissan_2014",
                 "imagenet"):
        with pytest.raises(KeyError, match="Unknown dataset: " + name):
            TK.get_imdb(name, kitti_path=root)
