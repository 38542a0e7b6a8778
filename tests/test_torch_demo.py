"""The port's demo (tools/demo_mv.py with utils/draw.py) against the JAX
package's: each drawing bit for bit on the same inputs, the calib reader,
and the demo CLI on the CPU over a one-frame synthetic tree, with and
without its lidar_bv raster, loading nothing of jax or the JAX package."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from mv3d_tf_tpu.utils import draw as JD  # noqa: E402
from mv3d_tf_tpu_torch.data import synthetic  # noqa: E402
from mv3d_tf_tpu_torch.tools import demo_mv as TDEMO  # noqa: E402
from mv3d_tf_tpu_torch.utils import draw as TD  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corners(rng, n):
    """n lidar boxes 8-40 m ahead as (n, 24) corners (x0..7, y0..7, z0..7),
    the layout of geometry.lidar_3d_to_corners."""
    ctr = np.stack([rng.uniform(8, 40, n), rng.uniform(-8, 8, n),
                    np.full(n, -0.9)], 1)
    dx = np.array([1, 1, -1, -1] * 2) * 2.0
    dy = np.array([1, -1, -1, 1] * 2) * 0.8
    dz = np.array([-1] * 4 + [1] * 4) * 0.75
    return np.concatenate([ctr[:, :1] + dx, ctr[:, 1:2] + dy,
                           ctr[:, 2:] + dz], 1).astype(np.float32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return synthetic.generate(str(tmp_path_factory.mktemp("kitti")),
                              num_frames=2, cars_per_frame=2, seed=3)


def test_load_calib_file_matches_jax(tree, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    spec = importlib.util.spec_from_file_location(
        "jax_demo_mv", os.path.join(REPO, "tools", "demo_mv.py"))
    jdemo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jdemo)
    for index in ("000000", "000001"):
        path = os.path.join(tree, "object", "training", "calib",
                            index + ".txt")
        got, want = TDEMO.load_calib_file(path), jdemo.load_calib_file(path)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert got[0, 0] > 0 and got[3].any()


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_scale_and_boxes_match_jax(rng, dtype):
    a = rng.uniform(-1, 3, (40, 50)).astype(np.float32)
    for lo, hi in ((0.0, 2.0), (-2.0, 1.0)):
        np.testing.assert_array_equal(TD.scale_to_255(a, lo, hi),
                                      JD.scale_to_255(a, lo, hi))
    image = (rng.rand(60, 90, 3) * 300 - 20).astype(dtype)
    boxes = rng.uniform(-10, 100, (7, 4)).astype(np.float32)
    for kw in ({}, {"color": (255, 0, 9), "width": 3}):
        got = TD.show_image_boxes(image, boxes, **kw)
        np.testing.assert_array_equal(got, JD.show_image_boxes(image, boxes,
                                                               **kw))
        assert got.dtype == np.uint8 and got.shape == (60, 90, 3)
    gray = TD.show_image_boxes(image[..., 0], boxes)
    np.testing.assert_array_equal(gray, JD.show_image_boxes(image[..., 0],
                                                            boxes))


def test_lidar_corners_and_bev_match_jax(tree, rng):
    calib = TDEMO.load_calib_file(os.path.join(
        tree, "object", "training", "calib", "000000.txt"))
    image = (rng.rand(375, 1242, 3) * 255).astype(np.uint8)
    cnr = _corners(rng, 6)
    got = TD.show_lidar_corners(image, cnr, calib)
    np.testing.assert_array_equal(got, JD.show_lidar_corners(image, cnr,
                                                             calib))
    assert (got != image).any()
    bev = np.load(os.path.join(tree, "object", "training", "lidar_bv",
                               "000000.npy"))
    boxes = rng.uniform(0, 600, (5, 4)).astype(np.float32)
    got = TD.show_bev_detections(bev, boxes)
    np.testing.assert_array_equal(got, JD.show_bev_detections(bev, boxes))
    assert got.shape == (601, 601, 3)


def test_pointcloud_3d_matches_jax(tree, rng):
    scan = np.fromfile(os.path.join(tree, "object", "training", "velodyne",
                                    "000000.bin"), np.float32).reshape(-1, 4)
    sets = [_corners(rng, 3), _corners(rng, 2)]
    colors = [(64, 255, 64), (255, 64, 255)]
    got = TD.show_pointcloud_3d(scan, sets, colors=colors)
    np.testing.assert_array_equal(
        got, JD.show_pointcloud_3d(scan, sets, colors=colors))
    assert got.shape == (500, 1000, 3) and got.any()
    for kw in (dict(azim_deg=30.0, elev_deg=-30.0, size=(200, 300)),
               dict(cam_pos=(-5.0, 2.0, 3.0), focal=300.0)):
        np.testing.assert_array_equal(
            TD.show_pointcloud_3d(scan[:, :3], sets[:1], **kw),
            JD.show_pointcloud_3d(scan[:, :3], sets[:1], **kw))
    empty = np.zeros((0, 4), np.float32)
    np.testing.assert_array_equal(TD.show_pointcloud_3d(empty),
                                  JD.show_pointcloud_3d(empty))


_CLI = """
import os, sys
from mv3d_tf_tpu_torch.config import cfg
from mv3d_tf_tpu_torch.data import synthetic
from mv3d_tf_tpu_torch.tools.demo_mv import main
tmp = sys.argv[1]
root = synthetic.generate(os.path.join(tmp, "kitti"), num_frames=2,
                          cars_per_frame=2, seed=4, image_hw=(96, 128))
obj = os.path.join(root, "object", "training")
cfg.TPU.IMAGE_SHAPE = (96, 128, 3)     # the BEV stays 601x601
for name, drop in (("bv", False), ("scan", True)):
    if drop:
        os.remove(os.path.join(obj, "lidar_bv", "000000.npy"))
    out = os.path.join(tmp, name)
    written = main(["--root", obj, "--index", "000000", "--out", out,
                    "--device", "cpu", "--dtype", "float32", "--conf", "0.0"])
    sizes = [os.path.getsize(p) for p in written]
    print(name, sorted(os.path.basename(p) for p in written), min(sizes))
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "mv3d_tf_tpu")]
assert not bad, "loaded: %s" % bad
print("ok")
"""


def test_demo_cli_on_the_cpu_without_jax(tmp_path):
    """The demo's main on the CPU over a one-frame tree (96x128 image, a
    601x601 BEV): with the lidar_bv raster, then rasterizing the scan;
    each run writes the three PNGs of class 1, none empty."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _CLI, str(tmp_path)],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    pngs = "['000000_cls1_3d.png', '000000_cls1_bev.png', '000000_cls1_img.png']"
    for name in ("bv", "scan"):
        line = [l for l in lines if l.startswith(name + " ")]
        assert len(line) == 1 and pngs in line[0], lines[-8:]
        assert int(line[0].rsplit(" ", 1)[1]) > 100
    assert sum("Detection took" in l for l in lines) == 2
