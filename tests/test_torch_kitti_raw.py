"""The port's KITTI-raw source against the JAX package's on CPU:
tools/tracklet2label (equal .npy files from one tracklet XML), the KittiRaw
imdb (equal roidb, calib and paths), the get_imdb route to it, and the
train step's minibatch built from its roidb."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu import geometry as JG  # noqa: E402
from mv3d_tf_tpu.data.kitti_raw import KittiRaw as JKittiRaw  # noqa: E402
from mv3d_tf_tpu_torch.config import cfg as tcfg  # noqa: E402
from mv3d_tf_tpu_torch.data import kitti as TK  # noqa: E402
from mv3d_tf_tpu_torch.data import synthetic  # noqa: E402
from mv3d_tf_tpu_torch.data.kitti_raw import KittiRaw  # noqa: E402
from mv3d_tf_tpu_torch.data.loader import get_minibatch  # noqa: E402
from mv3d_tf_tpu_torch.tools import tracklet2label as T2L  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = "2011_09_26_drive_0001"

# tests/test_tools.py:55-72's tracklet, and a second object: a Car of three
# poses from frame 3 and a Pedestrian that the type filter drops
XML = """<?xml version="1.0"?>
<boost_serialization><tracklets class_id="0" version="0">
 <count>3</count>
 <item>
  <objectType>Car</objectType>
  <h>1.5</h><w>1.6</w><l>4.0</l>
  <first_frame>2</first_frame>
  <poses>
   <count>2</count>
   <item><tx>10.0</tx><ty>1.0</ty><tz>-0.8</tz>
         <rx>0</rx><ry>0</ry><rz>0.5</rz></item>
   <item><tx>11.0</tx><ty>1.1</ty><tz>-0.8</tz>
         <rx>0</rx><ry>0</ry><rz>0.6</rz></item>
  </poses>
 </item>
 <item>
  <objectType>Car</objectType>
  <h>1.4</h><w>1.7</w><l>3.9</l>
  <first_frame>3</first_frame>
  <poses>
   <count>3</count>
   <item><tx>20.0</tx><ty>-3.0</ty><tz>-0.9</tz><rz>-1.2</rz></item>
   <item><tx>20.5</tx><ty>-3.1</ty><tz>-0.9</tz><rz>-1.1</rz></item>
   <item><tx>21.0</tx><ty>-3.2</ty><tz>-0.9</tz><rz>3.0</rz></item>
  </poses>
 </item>
 <item>
  <objectType>Pedestrian</objectType>
  <h>1.7</h><w>0.6</w><l>0.8</l>
  <first_frame>2</first_frame>
  <poses>
   <count>1</count>
   <item><tx>5.0</tx><ty>2.0</ty><tz>-0.9</tz><rz>0.0</rz></item>
  </poses>
 </item>
</tracklets></boost_serialization>"""


def _jax_tracklet2label(argv, monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import tracklet2label as JT2L
        monkeypatch.setattr(sys, "argv", ["tracklet2label.py"] + argv)
        JT2L.main()
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))


def test_tracklet2label_matches_jax(tmp_path, monkeypatch, capsys):
    xml = tmp_path / "tracklet_labels.xml"
    xml.write_text(XML)
    port, ref = tmp_path / "port", tmp_path / "jax"
    T2L.main(["--xml", str(xml), "--out", str(port)])
    _jax_tracklet2label(["--xml", str(xml), "--out", str(ref)], monkeypatch)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("wrote 4 frames (5 boxes)")
    files = sorted(os.listdir(ref))
    assert files == ["%010d.npy" % i for i in (2, 3, 4, 5)]
    assert sorted(os.listdir(port)) == files
    for f in files:
        got, want = np.load(port / f), np.load(ref / f)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want), f
    assert np.load(port / files[1]).shape == (2, 24)
    c = np.load(port / files[0])[0].reshape(3, 8)
    np.testing.assert_allclose(c[0].mean(), 10.0, atol=1e-5)
    np.testing.assert_allclose(c[2].mean(), -0.8 + 0.75, atol=1e-5)


@pytest.fixture(scope="module")
def raw_root(tmp_path_factory):
    """One raw sequence: the gt of tests/test_datasets_extra.py:151 in frame
    0 and tracklet2label's yawed boxes in frames 2-5, each frame with the
    image, raster and scan of a 1-frame synthetic tree, and its calib."""
    tmp = tmp_path_factory.mktemp("kitti_raw")
    tree = synthetic.generate(str(tmp / "tree"), num_frames=1,
                              cars_per_frame=2, seed=4, image_hw=(40, 48))
    obj = os.path.join(tree, "object", "training")
    seq = tmp / "root" / SEQ
    (seq / "gt_boxes3d").mkdir(parents=True)
    box = np.asarray(JG.lidar_3d_to_corners(
        np.array([[20.0, 3.0, -0.8, 4.0, 1.6, 1.5]], np.float32)))
    np.save(seq / "gt_boxes3d" / ("%010d.npy" % 0), box)
    xml = tmp / "tracklet_labels.xml"
    xml.write_text(XML)
    T2L.main(["--xml", str(xml), "--out", str(seq / "gt_boxes3d")])
    for sub, ext in (("image_2", ".png"), ("lidar_bv", ".npy"),
                     ("velodyne", ".bin")):
        (seq / sub).mkdir()
        for i in (0, 2, 3, 4, 5):
            shutil.copy(os.path.join(obj, sub, "000000" + ext),
                        seq / sub / ("%010d%s" % (i, ext)))
    shutil.copy(os.path.join(obj, "calib", "000000.txt"), seq / "calib.txt")
    return str(tmp / "root")


def test_kitti_raw_roidb_matches_jax(raw_root):
    got, want = KittiRaw(SEQ, raw_root), JKittiRaw(SEQ, raw_root)
    assert got.name == want.name == "kitti_raw_" + SEQ
    assert got.num_images == want.num_images == 5
    assert got.num_classes == want.num_classes == 2
    for i in range(5):
        for path in ("image_path_at", "lidar_path_at", "velodyne_path_at"):
            assert getattr(got, path)(i) == getattr(want, path)(i)
            assert os.path.isfile(getattr(got, path)(i))
        assert np.array_equal(got.calib_at(i), want.calib_at(i))
    for g, w in zip(got.roidb, want.roidb):
        assert sorted(g) == sorted(w)
        for key in w:
            if key == "flipped":
                assert g[key] is w[key] is False
                continue
            assert g[key].dtype == w[key].dtype, key
            assert np.array_equal(g[key], w[key]), key
    e = got.roidb[0]
    np.testing.assert_allclose(e["boxes_3D"][0, :3], [20, 3, -0.8], atol=1e-4)
    np.testing.assert_allclose(e["boxes_3D"][0, 3:], [4.0, 1.6, 1.5],
                               atol=1e-4)
    assert [len(r["gt_classes"]) for r in got.roidb] == [1, 1, 2, 1, 1]


def test_get_imdb_routes_kitti_raw(raw_root, tmp_path, monkeypatch):
    """kitti_raw_<seq> resolves to KittiRaw under kitti_path, one instance
    per (name, root); its prepared roidb makes the train step's minibatch."""
    monkeypatch.setattr(tcfg, "DATA_DIR", str(tmp_path))
    imdb = TK.get_imdb("kitti_raw_" + SEQ, kitti_path=raw_root)
    assert isinstance(imdb, KittiRaw) and imdb.num_images == 5
    assert TK.get_imdb("kitti_raw_" + SEQ, kitti_path=raw_root) is imdb
    other = os.path.join(str(tmp_path), "elsewhere")
    shutil.copytree(raw_root, other)
    assert TK.get_imdb("kitti_raw_" + SEQ, kitti_path=other) is not imdb
    roidb = TK.prepare_roidb(imdb)
    batch = get_minibatch(roidb[2])
    assert batch["gt_valid"].sum() == 2
    assert batch["bev"].shape == (601, 601, 9)
    np.testing.assert_array_equal(batch["gt_boxes_corners"][:2, :24],
                                  roidb[2]["boxes_corners"])
    assert np.array_equal(batch["calib"], imdb.calib_at(2))


_IMPORTS = """
import sys
from mv3d_tf_tpu_torch.data import kitti, kitti_eval, kitti_raw
from mv3d_tf_tpu_torch.tools import (accuracy_eval, profile_bev,
                                     profile_stages, profile_train,
                                     profiling, trace_detect, trace_train,
                                     tracklet2label)
from mv3d_tf_tpu_torch.utils import native, weights
native.get_lib(), native.get_bev_lib(), native.get_eval_lib()
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "mv3d_tf_tpu")]
assert not bad, "loaded: %s" % bad
print("ok")
"""


def test_new_modules_load_without_the_jax_package():
    """This slice's modules, and the C++ libraries, load with nothing of
    jax or the JAX package imported."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORTS], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"
