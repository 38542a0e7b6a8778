"""The port's host code in C++ (mv3d_tf_tpu_torch/native/*.cc through
utils/native.py) against its numpy versions and the JAX package on CPU:
the velodyne loader and the host BEV raster bit for bit, the AP matcher
within 1e-9 with equal gt counts, the routing of evaluate_ap_difficulty,
the atomic build under two processes at once, and the refusal to go on
without a compiler."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu.data import kitti_eval as JKE  # noqa: E402
from mv3d_tf_tpu.ops import bev as J  # noqa: E402
from mv3d_tf_tpu.utils import native as JN  # noqa: E402
from mv3d_tf_tpu_torch.data import kitti_eval as TKE  # noqa: E402
from mv3d_tf_tpu_torch.ops import bev as T  # noqa: E402
from mv3d_tf_tpu_torch.utils import native as TN  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKET = 1024
PAD = 4096      # one padded point count: JAX's device raster compiles once


def _points(rng, n):
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.rand(n) * 80 - 10
    pts[:, 1] = rng.rand(n) * 80 - 40
    pts[:, 2] = rng.rand(n) * 4 - 3
    pts[:, 3] = rng.rand(n)
    return pts


def _boundary_points():
    """tests/test_torch_bev.py's 16 points at float32(h) and
    float32(h + 0.3) for the 8 slice starts h, each alone in its cell."""
    pts = np.zeros((16, 4), np.float32)
    for i, h in enumerate(J.SLICE_STARTS):
        for j, z in enumerate((np.float32(h), np.float32(h + 0.3))):
            k = 2 * i + j
            pts[k] = [10.05 + 2.0 * i + j, -5.05 + 10.0 * j, z,
                      0.05 + 0.05 * k]
    pts[0, 1], pts[1, 1] = 0.0, -0.0
    return pts


@pytest.fixture
def scans(tmp_path):
    """Four .bin files from a seeded RandomState: 777 points, 2000 (longer
    than BUCKET), 50, and 300 with a trailing partial record (2 floats)."""
    rng = np.random.RandomState(11)
    paths = []
    for i, n in enumerate((777, 2000, 50, 300)):
        path = str(tmp_path / "{:06d}.bin".format(i))
        data = _points(rng, n).ravel()
        if i == 3:
            data = np.concatenate([data, np.float32([7.0, 8.0])])
        data.tofile(path)
        paths.append(path)
    return paths


def test_loaders_agree(scans, tmp_path):
    """C++, numpy and the JAX package's loader give equal arrays; a missing
    file raises on every route, naming it."""
    got = TN.load_velodyne_batch(scans, bucket=BUCKET, n_threads=3)
    plain = TN.load_velodyne_batch_np(scans, bucket=BUCKET, n_threads=3)
    ref = JN.load_velodyne_batch(scans, bucket=BUCKET, n_threads=3)
    for g, p, r in zip(got, plain, ref):
        assert g.dtype == p.dtype == r.dtype
        assert np.array_equal(g, p) and np.array_equal(g, r)
    assert got[1].sum(1).tolist() == [777, BUCKET, 50, 300]
    for i, path in enumerate(scans):
        for one in (TN.load_velodyne_padded(path, bucket=BUCKET),
                    TN.load_velodyne_padded_np(path, bucket=BUCKET)):
            assert np.array_equal(one[0], ref[0][i])
            assert np.array_equal(one[1], ref[1][i])
    empty = TN.load_velodyne_batch([], bucket=16)
    assert empty[0].shape == (0, 16, 4) and empty[1].shape == (0, 16)
    missing = str(tmp_path / "missing.bin")
    with pytest.raises(IOError, match="missing.bin"):
        TN.load_velodyne_batch(scans[:1] + [missing], bucket=16)
    with pytest.raises(IOError, match="missing.bin"):
        TN.load_velodyne_padded(missing, bucket=16)
    with pytest.raises(OSError):
        TN.load_velodyne_batch_np([missing], bucket=16)


@pytest.mark.parametrize("case", ["seeded", "boundary"])
def test_raster_bit_for_bit(case):
    """The C++ raster equals the port's numpy twin and JAX's device raster
    (float32 slice bounds) bit for bit."""
    pts = (_points(np.random.RandomState(5), 3000) if case == "seeded"
           else _boundary_points())
    got = TN.point_cloud_2_top_host(pts)
    assert got.dtype == np.float32 and got.shape == (601, 601, 9)
    assert np.array_equal(got, T.point_cloud_2_top_np(pts))
    padded, valid = J.pad_points(pts, PAD)
    assert np.array_equal(got, np.asarray(J.point_cloud_2_top(padded, valid)))
    assert np.count_nonzero(got) > (1000 if case == "seeded" else 20)


def test_raster_differs_from_jax_cpp_only_on_boundaries():
    """The stated difference: JAX's C++ raster resolves slices in float64
    against h_min + c * float(0.3). Of the 16 boundary points it puts 12
    one slice lower (each moves its height entry to the next channel) and
    keeps float32(0.4) in the last slice, which it is past in float32
    (its height and reflectance entries): 26 entries, all in boundary
    points' cells. Off the boundaries the two agree."""
    rng = np.random.RandomState(5)
    scan = _points(rng, 20000)
    bnd = _boundary_points()
    both = np.concatenate([scan, bnd])
    assert np.array_equal(TN.point_cloud_2_top_host(scan),
                          JN.point_cloud_2_top_host(scan))
    diff = TN.point_cloud_2_top_host(both) != JN.point_cloud_2_top_host(both)
    assert np.count_nonzero(diff) == 26
    rows = (-bnd[:, 0] / np.float32(0.1)).astype(np.int32) + 600
    cols = (-bnd[:, 1] / np.float32(0.1)).astype(np.int32) + 300
    cells = set(zip(rows.tolist(), cols.tolist()))
    assert set(zip(*np.nonzero(diff.any(-1)))) <= cells


def test_bev_raster_files(tmp_path):
    """The threaded file raster against a per-file loop of the numpy twin;
    a missing file raises IOError naming it."""
    rng = np.random.RandomState(6)
    paths, refs = [], []
    for i in range(5):
        pts = _points(rng, rng.randint(100, 3000))
        path = str(tmp_path / "{:06d}.bin".format(i))
        pts.tofile(path)
        paths.append(path)
        refs.append(T.point_cloud_2_top_np(pts))
    got = TN.bev_raster_files(paths, n_threads=3)
    assert np.array_equal(got, np.stack(refs))
    with pytest.raises(IOError, match="nope.bin"):
        TN.bev_raster_files(paths[:1] + [str(tmp_path / "nope.bin")])


def _rand_frames(rng, n_frames, kind, mod, max_d=25, max_g=12):
    """tests/test_kitti_eval_native.py's frames, with mod's IoU callables."""
    frames = []
    D = 6 if kind == 1 else 4
    iou = mod.iou_3d_aabb if kind == 1 else mod.iou_2d
    for _ in range(n_frames):
        nd, ng = rng.randint(0, max_d), rng.randint(0, max_g)
        span, size, lo = (40, 6, 0.5) if kind == 1 else (500, 60, 5)
        d0, g0 = rng.rand(nd, D // 2) * span, rng.rand(ng, D // 2) * span
        dets = np.concatenate([d0, d0 + rng.rand(nd, D // 2) * size + lo], 1)
        gts = np.concatenate([g0, g0 + rng.rand(ng, D // 2) * size + lo], 1)
        for d in range(min(nd, ng)):
            if rng.rand() < 0.5:
                dets[d, :D] = gts[d, :D] + rng.randn(D) * 0.5
        frames.append({
            "dets": dets.astype(np.float32),
            "scores": rng.rand(nd).astype(np.float32),
            "det_heights": (rng.rand(nd) * 80 + 5).astype(np.float32),
            "gts": gts.astype(np.float32),
            "levels": rng.randint(1, 5, ng).astype(np.int32),
            "iou": iou,
        })
    return frames


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("difficulty", ["easy", "moderate", "hard"])
def test_ap_native_matches_numpy_and_jax(kind, difficulty):
    thr = 0.5 if kind == 0 else 0.25
    port = _rand_frames(np.random.RandomState(17 + kind), 30, kind, TKE)
    jax_ = _rand_frames(np.random.RandomState(17 + kind), 30, kind, JKE)
    nat = TKE.evaluate_ap_difficulty(port, thr, difficulty)
    plain = TKE.evaluate_ap_difficulty(port, thr, difficulty,
                                       use_native=False)
    ref = JKE.evaluate_ap_difficulty(jax_, thr, difficulty, use_native=True)
    assert set(nat) == {"ap", "num_gt"} and "recall" in plain
    assert nat["num_gt"] == plain["num_gt"] == ref["num_gt"] > 0
    assert abs(nat["ap"] - plain["ap"]) < 1e-9
    assert abs(nat["ap"] - ref["ap"]) < 1e-9
    assert plain["ap"] > 0


def test_ap_empty_and_ignored_cases():
    """tests/test_kitti_eval_native.py's cases: no detections; no frames;
    a det matching only an ignored (level-4) gt is neither TP nor FP and a
    short unmatched det is ignored."""
    nodet = [{"dets": np.zeros((0, 4), np.float32),
              "scores": np.zeros(0, np.float32),
              "det_heights": np.zeros(0, np.float32),
              "gts": np.array([[0, 0, 50, 50]], np.float32),
              "levels": np.array([1], np.int32), "iou": TKE.iou_2d}]
    for native in (True, False):
        res = TKE.evaluate_ap_difficulty(nodet, 0.5, "hard", native)
        assert res["ap"] == 0.0 and res["num_gt"] == 1
    assert TN.eval_ap_native([], 0, 0.5, 25.0, 3) == (0.0, 0)
    frames = [{"dets": np.array([[100, 100, 160, 160], [300, 300, 360, 360],
                                 [500, 10, 520, 20]], np.float32),
               "scores": np.array([0.9, 0.8, 0.7], np.float32),
               "det_heights": np.array([61.0, 61.0, 11.0], np.float32),
               "gts": np.array([[100, 100, 160, 160],
                                [300, 300, 360, 360]], np.float32),
               "levels": np.array([4, 1], np.int32), "iou": TKE.iou_2d}]
    for diff in ("easy", "hard"):
        nat = TKE.evaluate_ap_difficulty(frames, 0.7, diff)
        plain = TKE.evaluate_ap_difficulty(frames, 0.7, diff,
                                           use_native=False)
        assert nat["ap"] == plain["ap"] == 1.0


def test_ap_other_iou_takes_the_numpy_loop(monkeypatch):
    """Routing, not a fallback: an IoU callable other than the module's own
    never reaches the C++ matcher."""
    def refuse(*a, **k):
        raise AssertionError("the C++ matcher was called")

    frames = _rand_frames(np.random.RandomState(3), 8, 0, TKE)
    want = TKE.evaluate_ap_difficulty(frames, 0.5, "hard", use_native=False)
    monkeypatch.setattr(TN, "eval_ap_native", refuse)
    wrapped = [dict(fr, iou=lambda a, b: TKE.iou_2d(a, b)) for fr in frames]
    assert TKE.evaluate_ap_difficulty(wrapped, 0.5, "hard")["ap"] == want["ap"]
    with pytest.raises(AssertionError, match="C\\+\\+ matcher"):
        TKE.evaluate_ap_difficulty(frames, 0.5, "hard")


_BUILD = """
import sys
from mv3d_tf_tpu_torch.utils import native
native.BUILD_DIR = sys.argv[1]
import numpy as np
top = native.point_cloud_2_top_host(np.array([[10, 0, -1, 0.5]], np.float32))
print(float(top[500, 300, 3]))
"""


def test_two_processes_build_one_fresh_directory(tmp_path):
    """Two processes build the raster library into one empty directory at
    once: both load a whole library, and no temporary file is left."""
    build = str(tmp_path / "build")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, build],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        assert out.strip() == "1.0"
    names = os.listdir(build)
    assert len(names) == 1 and names[0].startswith("libbev_raster_")
    assert names[0].endswith(".so")


@pytest.mark.parametrize("fault", ["missing g++", "failed build"])
def test_no_build_raises(fault, tmp_path, monkeypatch):
    """Without a compiler, or with a source that does not compile, the
    first use raises; nothing falls back to numpy."""
    monkeypatch.setattr(TN, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(TN, "_libs", {})
    if fault == "missing g++":
        monkeypatch.setattr(TN, "GXX", str(tmp_path / "no-such-g++"))
        match = "g\\+\\+ not found"
    else:
        src = tmp_path / "src"
        src.mkdir()
        (src / "bev_raster.cc").write_text("this is not C++\n")
        monkeypatch.setattr(TN, "SOURCES", str(src))
        match = "g\\+\\+ failed"
    with pytest.raises(RuntimeError, match=match):
        TN.point_cloud_2_top_host(np.zeros((1, 4), np.float32))
    assert not os.path.exists(tmp_path / "build") or not os.listdir(
        tmp_path / "build")
