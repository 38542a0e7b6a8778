"""The port's remaining 2D data layer against the JAX package's on the same
synthetic trees (built the way tests/test_datasets_extra.py,
test_subcnn.py and test_extra_datasets.py build them): the imdb base's
flip, SubCNN proposal recall and roidb merge; PascalVOC's region-proposal
and selective-search roidbs and proposal recall; boxes_grid and the SubCNN
helpers; the COCO AP; the datasets of extra_datasets.py (kitti_tracking,
coco, nissan / nthu, pascal3d, imagenet3d) with their roidbs and result
writers; and get_imdb's names for them. Roidbs, recalls, AP numbers and the
written files must be equal; each package caches under its own DATA_DIR."""

import copy
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu.config import cfg as jcfg  # noqa: E402
from mv3d_tf_tpu.data import boxes_grid as JB  # noqa: E402
from mv3d_tf_tpu.data import coco_eval as JC  # noqa: E402
from mv3d_tf_tpu.data import extra_datasets as JE  # noqa: E402
from mv3d_tf_tpu.data import kitti as JK  # noqa: E402
from mv3d_tf_tpu.data import pascal_voc as JP  # noqa: E402
from mv3d_tf_tpu.data import subcnn as JS  # noqa: E402
from mv3d_tf_tpu_torch.config import cfg as tcfg  # noqa: E402
from mv3d_tf_tpu_torch.data import boxes_grid as TB  # noqa: E402
from mv3d_tf_tpu_torch.data import coco_eval as TC  # noqa: E402
from mv3d_tf_tpu_torch.data import extra_datasets as TE  # noqa: E402
from mv3d_tf_tpu_torch.data import kitti as TK  # noqa: E402
from mv3d_tf_tpu_torch.data import pascal_voc as TP  # noqa: E402
from mv3d_tf_tpu_torch.data import subcnn as TS  # noqa: E402
from mv3d_tf_tpu_torch.data import synthetic  # noqa: E402


def _img(path, hw, seed):
    from PIL import Image
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.randint(0, 255, (hw[0], hw[1], 3), np.uint8)) \
        .save(path)


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def _props(rng, boxes, n, w, h):
    """Proposal rows [x1 y1 x2 y2 score]: each box jittered, n random
    boxes and one degenerate row (x2 < x1), as text."""
    rows = [b + rng.uniform(-6, 6, 4) for b in boxes for _ in range(3)]
    xy = rng.uniform(0, min(w, h) / 2, (n, 2))
    rows += list(np.hstack([xy, xy + rng.uniform(8, min(w, h) / 2, (n, 2))]))
    rows.append([30, 30, 20, 40])
    rows = np.hstack([np.clip(rows, 0, w - 1), rng.rand(len(rows), 1)])
    return "".join("{:.2f} {:.2f} {:.2f} {:.2f} {:.3f}\n".format(*r)
                   for r in rows)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One directory of synthetic trees: a VOC devkit (generate_voc) with
    RPN proposal files and a selective-search .mat; a PASCAL3D+ root
    (VOCdevkit2012 with car/bus XML, voxel exemplars, mapping, proposals);
    an ImageNet3D root (labels with and without viewpoints, proposals in
    three formats); a KITTI tracking sequence (label_02, voxel exemplars,
    proposals); a COCO root (instances json, one crowd); an image list."""
    import scipy.io as sio
    root = tmp_path_factory.mktemp("trees")
    rng = np.random.RandomState(11)
    out = {}

    voc = synthetic.generate_voc(str(root / "VOCdevkit"), num_images=3,
                                 seed=3, image_hw=(90, 120))
    imdb = TP.PascalVOC("trainval", "2007", voc)
    cell = np.empty((1, 3), object)
    for i, index in enumerate(imdb.image_index):
        gt = imdb._load_pascal_annotation(index)["boxes"].astype(np.float64)
        _write(os.path.join(voc, "region_proposals", "RPN", "training",
                            index + ".txt"), _props(rng, gt, 5, 120, 90))
        ss = np.vstack([gt + rng.uniform(-5, 5, gt.shape) for _ in range(3)])
        cell[0, i] = np.round(ss[:, (1, 0, 3, 2)] + 1)
    os.makedirs(os.path.join(voc, "selective_search_data"))
    sio.savemat(os.path.join(voc, "selective_search_data",
                             "voc_2007_trainval.mat"), {"boxes": cell})
    out["voc"] = voc

    p3 = root / "pascal3d"
    dk = p3 / "VOCdevkit2012" / "VOC2012"
    objs = {"img1": [("car", 11, 21, 61, 81), ("bus", 70, 10, 115, 60)],
            "img2": [("car", 5, 30, 40, 70)]}
    for split in ("train", "val"):
        _write(str(dk / "ImageSets" / "Main" / (split + ".txt")),
               "img1\nimg2\n")
    for n, (idx, ob) in enumerate(objs.items()):
        _img(str(dk / "JPEGImages" / (idx + ".jpg")), (100, 130), n)
        _write(str(dk / "Annotations" / (idx + ".xml")), "<annotation>" + "".join(
            "<object><name>{}</name><difficult>0</difficult><bndbox>"
            "<xmin>{}</xmin><ymin>{}</ymin><xmax>{}</xmax><ymax>{}</ymax>"
            "</bndbox></object>".format(*o) for o in ob) + "</annotation>")
        _write(str(p3 / "voxel_exemplars" / (idx + ".txt")), "".join(
            "{} {} {} {} {} {} {}\n".format(o[0], 3 + k + 4 * f, f, *o[1:])
            for f in (0, 1) for k, o in enumerate(ob)))
        for sub in ("training", "validation"):
            _write(str(p3 / "region_proposals" / "RPN" / sub /
                       (idx + ".txt")),
                   _props(rng, np.array([o[1:] for o in ob], float), 4,
                          130, 100))
    _write(str(p3 / "voxel_exemplars" / "mapping.txt"), "".join(
        "{} {} {:.1f}\n".format(s, "car" if s % 2 else "bus", 15.0 * s)
        for s in range(3, 9)))
    out["pascal3d"] = str(p3)

    i3 = root / "imagenet3d"
    _write(str(i3 / "ImageSets" / "train.txt"), "im1\nim2\n")
    _write(str(i3 / "ImageSets" / "test.txt"), "im2\n")
    _write(str(i3 / "Labels" / "im1.txt"),
           "car 10 20 60 80 30.0 10.0 -5.0\nchair 5 5 50 50\n")
    _write(str(i3 / "Labels" / "im2.txt"), "bus 30 10 90 70 -45 2 1\n")
    for n, idx in enumerate(("im1", "im2")):
        _img(str(i3 / "Images" / (idx + ".jpg")), (100, 100), 10 + n)
        for model in ("selective_search", "edge_boxes", "rpn_vgg16"):
            _write(str(i3 / "region_proposals" / model / (idx + ".txt")),
                   _props(rng, np.array([[10, 20, 60, 80]], float), 3,
                          100, 100))
    out["imagenet3d"] = str(i3)

    tr = root / "tracking"
    for i in range(3):
        _img(str(tr / "training" / "image_02" / "0000" /
                 "{:06d}.png".format(i)), (80, 120), 20 + i)
    _write(str(tr / "training" / "label_02" / "0000.txt"),
           "0 1 Car 0 0 -1.5 10 20 60 70 1.5 1.6 4.0 2.0 1.5 15.0 0.3\n"
           "0 2 Pedestrian 0 0 0 70 10 90 60 1.8 0.6 0.6 1 1 8 0\n"
           "2 1 Car 0 0 -1.4 15 20 65 70 1.5 1.6 4.0 2.2 1.5 14.5 0.25\n"
           "2 3 Van 0 0 0 1 1 5 5 1 1 1 1 1 1 0\n")
    for i, boxes in ((0, [(10, 20, 60, 70)]), (2, [(15, 20, 65, 70)])):
        _write(str(tr / "voxel_exemplars" / "trainval" / "0000" /
                   "{:06d}.txt".format(i)),
               "".join("Car {} {} {} {} {} {}\n".format(5 + 4 * f, f, *b)
                       for f in (0, 1) for b in boxes))
    _write(str(tr / "voxel_exemplars" / "trainval" / "mapping.txt"),
           "5 Car x 0.7\n9 Car x -0.7\n")
    for i in range(3):
        _write(str(tr / "region_proposals" / "RPN_trainval" / "training" /
                   "0000" / "{:06d}.txt".format(i)),
               _props(rng, np.array([[10, 20, 60, 70]], float), 2, 120, 80)
               if i != 1 else "")
    out["tracking"] = str(tr)

    co = root / "coco"
    ann = {"images": [{"id": 1, "file_name": "a.jpg"},
                      {"id": 2, "file_name": "b.jpg"}],
           "categories": [{"id": 18, "name": "dog"},
                          {"id": 3, "name": "car"}],
           "annotations": [
               {"image_id": 1, "category_id": 18, "bbox": [10, 10, 30, 30],
                "iscrowd": 0},
               {"image_id": 1, "category_id": 3, "bbox": [40, 5, 20, 25],
                "iscrowd": 0},
               {"image_id": 2, "category_id": 18, "bbox": [5, 5, 20, 20],
                "iscrowd": 0},
               {"image_id": 2, "category_id": 3, "bbox": [0, 0, 9, 9],
                "iscrowd": 1}]}
    _write(str(co / "annotations" / "instances_val2014.json"),
           json.dumps(ann))
    for n, f in enumerate(("a.jpg", "b.jpg")):
        _img(str(co / "images" / f), (60, 80), 30 + n)
    out["coco"] = str(co)

    for n, name in enumerate(("f1", "f0", "f2")):
        _img(str(root / "drive" / (name + ".jpg")), (40, 60), 40 + n)
    out["drive"] = str(root / "drive")
    return out


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Each package's pickles under its own DATA_DIR, IS_RPN and
    REGION_PROPOSAL at their defaults, empty get_imdb caches."""
    for c, sub in ((jcfg, "jax"), (tcfg, "port")):
        monkeypatch.setattr(c, "DATA_DIR", str(tmp_path / sub))
        monkeypatch.setattr(c, "IS_RPN", True)
        monkeypatch.setattr(c, "REGION_PROPOSAL", "RPN")
    monkeypatch.setattr(JK, "_IMDB_FACTORY", {})
    monkeypatch.setattr(TK, "_IMDB_FACTORY", {})
    return tmp_path


def _set(name, value, monkeypatch):
    for c in (jcfg, tcfg):
        monkeypatch.setattr(c, name, value)


def _same(a, b):
    """Two roidbs (or entries, or results) equal key by key, arrays bit for
    bit with their dtypes."""
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


def _files(d):
    out = {}
    for base, _, names in os.walk(d):
        for n in names:
            with open(os.path.join(base, n)) as f:
                out[os.path.relpath(os.path.join(base, n), d)] = f.read()
    return out


def test_imdb_base_flip_recall_merge(trees, caches):
    """append_flipped_images (widths read from the JPEGs), the SubCNN
    evaluate_proposals (AR, overlaps, recalls, thresholds, an image without
    candidates adding no gt) and evaluate_recall, merge_roidbs."""
    dbs = [M.PascalVOC("trainval", "2007", trees["voc"]) for M in (JP, TP)]
    for db in dbs:
        db.append_flipped_images()
    _same(dbs[0].roidb, dbs[1].roidb)
    assert dbs[1].num_images == 6 and dbs[1].roidb[4]["flipped"]
    rng = np.random.RandomState(2)
    cands = [e["boxes"].astype(np.float32) + rng.uniform(-8, 8, (len(e[
        "boxes"]), 4)).astype(np.float32) for e in dbs[0].roidb]
    cands[1] = np.zeros((0, 4), np.float32)
    # the base's SubCNN form (PascalVOC overrides the name with its own)
    got, want = (M.Imdb.evaluate_proposals(db, cands)
                 for M, db in ((TP, dbs[1]), (JP, dbs[0])))
    _same(list(got), list(want))
    assert 0 < got[0] < 1 and len(got[1]) > 5
    _same(dbs[1].evaluate_recall(cands), dbs[0].evaluate_recall(cands))
    a = [{k: v for k, v in e.items()} for e in dbs[0].roidb]
    b = copy.deepcopy(a)
    _same(TP.Imdb.merge_roidbs(a, copy.deepcopy(a)),
          JP.Imdb.merge_roidbs(b, copy.deepcopy(b)))


def test_voc_proposal_roidbs_and_recall(trees, caches):
    """region_proposal_roidb (text files, the degenerate row dropped, gt
    merged after the proposals), selective_search_roidb (the .mat's
    [y1 x1 y2 x2] 1-based boxes) and evaluate_proposals' recall at 0.5."""
    dbs = [M.PascalVOC("trainval", "2007", trees["voc"]) for M in (JP, TP)]
    rp = [db.region_proposal_roidb() for db in dbs]
    _same(rp[0], rp[1])
    assert (rp[1][0]["gt_overlaps"].max(1) > 0).sum() > 5
    _same([db.selective_search_roidb() for db in dbs][0],
          dbs[1].selective_search_roidb())
    # a second read comes from the pickle, the same roidb
    _same(dbs[1].region_proposal_roidb(), rp[1])
    all_boxes = [[[] for _ in range(3)] for _ in range(21)]
    for i, e in enumerate(rp[0]):
        cls = e["gt_overlaps"].argmax(1)
        for c in set(cls) - {0}:
            b = e["boxes"][cls == c].astype(np.float32)
            all_boxes[c][i] = np.hstack([b, np.ones((len(b), 1), np.float32)])
    got, want = (db.evaluate_proposals(all_boxes) for db in dbs[::-1])
    assert got == want and 0 < got <= 1


def test_boxes_grid_and_subcnn_helpers(trees, tmp_path):
    """get_boxes_grid for both nets, the SubCNN mapping, exemplar and
    proposal parsers, and the anchor and grid coverage counts."""
    for kw in (dict(), dict(scale=2.0, net_name="CaffeNet",
                            aspects=(1, 0.5), kernel_size=3)):
        _same(list(TB.get_boxes_grid(100, 130, **kw)),
              list(JB.get_boxes_grid(100, 130, **kw)))
    mapping = os.path.join(trees["pascal3d"], "voxel_exemplars",
                           "mapping.txt")
    names, az = TS.parse_subclass_mapping(mapping, value_col=2)
    jnames, jaz = JS.parse_subclass_mapping(mapping, value_col=2)
    assert names == jnames
    _same(az, jaz)
    cti = {c: i for i, c in enumerate(JE.PASCAL3D_CLASSES)}
    _same(TS.subclass_mapping_to_class_ind(names, cti),
          JS.subclass_mapping_to_class_ind(names, cti))
    ex = os.path.join(trees["pascal3d"], "voxel_exemplars", "img1.txt")
    for zb in (True, False):
        _same(TS.load_voxel_exemplar_annotation(ex, cti, 13, zero_based=zb),
              JS.load_voxel_exemplar_annotation(ex, cti, 13, zero_based=zb))
    prop = os.path.join(trees["pascal3d"], "region_proposals", "RPN",
                        "training", "img1.txt")
    _same(TS.load_rpn_proposals(prop), JS.load_rpn_proposals(prop))
    boxes = np.array([[100, 100, 180, 160], [10, 10, 40, 90],
                      [300, 50, 420, 140]], np.float32)
    cls = np.array([1, 2, 1], np.int32)
    for fn, kw in (("anchor_coverage", dict(scale=1.0, fg_thresh=0.5)),
                   ("anchor_coverage", dict(scale=0.5, fg_thresh=0.7)),
                   ("grid_coverage", dict(scales=(1.0, 2.0), fg_thresh=0.3)),
                   ("grid_coverage", dict(scales=(1.0,), fg_thresh=0.5))):
        _same(list(getattr(TS, fn)(boxes, cls, 375, 500, 3, **kw)),
              list(getattr(JS, fn)(boxes, cls, 375, 500, 3, **kw)))


def test_coco_ap(trees):
    """evaluate_category at every IoU threshold and evaluate_coco_bbox's
    stats on detections that hit, miss and half-overlap."""
    gt = {1: np.array([[10, 10, 30, 30], [50, 50, 20, 20]], float),
          2: np.array([[0, 0, 40, 40]], float),
          3: np.zeros((0, 4))}
    dets = {1: (np.array([[10, 10, 30, 30], [52, 50, 20, 16],
                          [70, 0, 5, 5]], float), np.array([.9, .8, .95])),
            2: (np.array([[0, 0, 40, 24]], float), np.array([.7])),
            3: (np.array([[1, 1, 5, 5]], float), np.array([.3]))}
    _same(TC.evaluate_category(gt, dets), JC.evaluate_category(gt, dets))
    by_cls_gt = {1: gt, 2: {1: gt[2], 2: np.zeros((0, 4))}}
    by_cls_dets = {1: dets, 2: {1: dets[2], 2: (np.zeros((0, 4)),
                                                np.zeros(0))}}
    names = ["__background__", "a", "b"]
    _same(TC.evaluate_coco_bbox(by_cls_gt, by_cls_dets, names, log=None),
          JC.evaluate_coco_bbox(by_cls_gt, by_cls_dets, names, log=None))


def test_kitti_tracking(trees, caches, monkeypatch):
    """label_02 gt (Van rows skipped), voxel-exemplar gt (a frame without
    a file has no objects), the region-proposal roidb (an empty proposal
    file included) and the result writer with the subclass alpha."""
    for ve in (False, True):
        got, want = (M.KittiTracking("training", "0000", trees["tracking"],
                                     use_voxel_exemplars=ve).gt_roidb()
                     for M in (TE, JE))
        _same(got, want)
    _set("IS_RPN", False, monkeypatch)
    dbs = [M.KittiTracking("training", "0000", trees["tracking"],
                           use_voxel_exemplars=True) for M in (JE, TE)]
    _same(dbs[0].roidb, dbs[1].roidb)
    assert len(dbs[1].roidb[0]["boxes"]) > 1
    _same(dbs[1].subclass_mapping, dbs[0].subclass_mapping)
    all_boxes = [[np.zeros((0, 6))] * 3 for _ in range(4)]
    all_boxes[1][0] = np.array([[10, 20, 60, 70, 0.9, 5],
                                [12, 22, 50, 60, 0.4, 9]], float)
    for db, sub in zip(dbs, ("j", "t")):
        db.evaluate_detections(all_boxes, str(caches / sub))
    assert _files(caches / "t") == _files(caches / "j")
    assert _files(caches / "t")["000000.txt"].startswith("Car -1 -1 0.7")


def test_coco(trees, caches):
    """The instances json (crowd rows dropped, categories sorted by id),
    the results json and the AP stats on a val split."""
    dbs = [M.Coco("val", "2014", trees["coco"]) for M in (JE, TE)]
    _same(dbs[0].roidb, dbs[1].roidb)
    assert dbs[1].classes == ("__background__", "car", "dog")
    all_boxes = [[[], []], [np.array([[40, 5, 59, 29, .8]]), []],
                 [np.array([[10, 10, 39, 39, .9], [0, 0, 9, 9, .2]]),
                  np.array([[5, 5, 22, 24, .7]])]]
    got, want = (db.evaluate_detections(all_boxes, str(caches / sub),
                                        log=None)
                 for db, sub in ((dbs[1], "t"), (dbs[0], "j")))
    assert got.pop("results_json").startswith(str(caches / "t"))
    want.pop("results_json")
    _same(got, want)
    assert _files(caches / "t") == _files(caches / "j")


def test_image_list_datasets(trees, caches):
    """nissan / nthu: sorted image names, empty gt, the detections
    writer."""
    for name in ("nissan", "nthu"):
        dbs = [M.ImageListDataset(name, trees["drive"]) for M in (JE, TE)]
        assert dbs[1].image_index == dbs[0].image_index == ["f0", "f1", "f2"]
        _same(dbs[0].roidb, dbs[1].roidb)
        all_boxes = [[[]] * 3, [np.array([[1, 2, 3, 4, .5]]), [], []]]
        paths = [db.evaluate_detections(all_boxes, str(caches / sub))
                 for db, sub in zip(dbs, ("j", "t"))]
        assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    assert _files(caches / "t") == _files(caches / "j")


def test_pascal3d(trees, caches, monkeypatch, capsys):
    """train gt from the voxel exemplars, val gt from the XML (with the
    anchor-coverage printout of IS_RPN), the region-proposal roidb of
    IS_RPN off, and the three result writers (azimuth from the mapping)."""
    devkit = os.path.join(trees["pascal3d"], "VOCdevkit2012")
    for split in ("train", "val"):
        got, want = (M.Pascal3D(split, devkit).roidb for M in (TE, JE))
        _same(got, want)
    out = capsys.readouterr().out
    assert out.count("car: Recall") == 4
    _set("IS_RPN", False, monkeypatch)
    dbs = [M.Pascal3D("train", devkit) for M in (JE, TE)]
    _same(dbs[0].roidb, dbs[1].roidb)
    assert len(dbs[1].roidb[0]["boxes"]) > 2
    all_boxes = [[np.zeros((0, 6))] * 2 for _ in range(13)]
    all_boxes[6][0] = np.array([[11, 21, 61, 81, .9, 3],
                                [5, 30, 40, 70, .5, 5]], float)
    all_boxes[5][1] = np.array([[70, 10, 115, 60, .8, 4]], float)
    for db, sub in zip(dbs, ("j", "t")):
        db.evaluate_detections(all_boxes, str(caches / sub))
        db.evaluate_detections_one_file(all_boxes, str(caches / sub))
        db.evaluate_proposals(all_boxes, str(caches / sub / "props"))
    assert _files(caches / "t") == _files(caches / "j")


@pytest.mark.parametrize("model", ["selective_search", "edge_boxes",
                                   "rpn_vgg16"])
def test_imagenet3d(trees, caches, monkeypatch, model):
    """gt with and without viewpoints (inf), the region-proposal roidb of
    IS_RPN off in each stored box format, a test split without labels and
    the result writers."""
    got, want = (M.Imagenet3D("train", trees["imagenet3d"]).roidb
                 for M in (TE, JE))
    _same(got, want)
    _set("IS_RPN", False, monkeypatch)
    _set("REGION_PROPOSAL", model, monkeypatch)
    for split in ("train", "test"):
        dbs = [M.Imagenet3D(split, trees["imagenet3d"]) for M in (JE, TE)]
        _same(dbs[0].roidb, dbs[1].roidb)
    all_boxes = [[np.zeros((0, 9))] for _ in range(101)]
    all_boxes[19][0] = np.array([[10, 20, 60, 80, .9, 0, 30, 10, -5]], float)
    for db, sub in zip(dbs, ("j", "t")):
        db.evaluate_detections(all_boxes, str(caches / sub))
        db.evaluate_proposals(all_boxes, str(caches / sub / "props"))
    assert _files(caches / "t") == _files(caches / "j")


# name -> (tree, get_imdb keyword of its root)
NAMES = {"kitti_tracking_training_0000": ("tracking", "kitti_path"),
         "coco_2014_val": ("coco", "kitti_path"),
         "pascal3d_train": ("pascal3d", "devkit_path"),
         "pascal3d_val": ("pascal3d", "devkit_path"),
         "imagenet3d_train": ("imagenet3d", "devkit_path"),
         "nissan": ("drive", "kitti_path"), "nthu": ("drive", "devkit_path")}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_get_imdb_names(trees, caches, name):
    """Every name of the JAX package's get_imdb that the port lacked: the
    same class, name, classes and roidb; one instance per name and root."""
    tree, where = NAMES[name]
    root = trees[tree]
    if tree == "pascal3d":
        root = os.path.join(root, "VOCdevkit2012")
    got, want = (M.get_imdb(name, **{where: root}) for M in (TK, JK))
    assert type(got).__name__ == type(want).__name__
    assert (got.name, got.classes, got.image_index) == (
        want.name, want.classes, want.image_index)
    _same(got.roidb, want.roidb)
    assert TK.get_imdb(name, **{where: root}) is got
