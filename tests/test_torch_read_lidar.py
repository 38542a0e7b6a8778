"""The port's LiDAR front end as a whole on CPU: the read_lidar CLI
(mv3d_tf_tpu_torch/tools/read_lidar.py) against the JAX package's batched
rasterizer, the host I/O and make_bird_view, the port's own config, and the
import and device rules (no module of the JAX package loaded; the card by
default)."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu.ops import bev as J  # noqa: E402
from mv3d_tf_tpu.utils import native as JN  # noqa: E402
from mv3d_tf_tpu_torch.data.blob import make_bird_view  # noqa: E402
from mv3d_tf_tpu_torch.models import mv3d as TM  # noqa: E402
from mv3d_tf_tpu_torch.ops import bev as T  # noqa: E402
from mv3d_tf_tpu_torch.tools import read_lidar  # noqa: E402
from mv3d_tf_tpu_torch.utils import native as TN  # noqa: E402
from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,  # noqa: E402
                                             params_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKET = 8192
COUNTS = {"000000": 9000, "000001": BUCKET, "000002": 5000}  # above/at/below


def _write_scans(root, counts, seed=0):
    """KITTI-layout velodyne/<idx>.bin scans of bench.py's traffic."""
    rng = np.random.RandomState(seed)
    vel = root / "velodyne"
    vel.mkdir(parents=True)
    paths = []
    for idx, n in counts.items():
        pts = np.empty((n, 4), np.float32)
        pts[:, 0] = rng.rand(n) * 80 - 10
        pts[:, 1] = rng.rand(n) * 80 - 40
        pts[:, 2] = rng.rand(n) * 4 - 3
        pts[:, 3] = rng.rand(n)
        pts.tofile(str(vel / (idx + ".bin")))
        paths.append(str(vel / (idx + ".bin")))
    return paths


def _fresh(path, name):
    """A config module loaded anew from its file: the defaults, whatever
    other tests did to the imported one."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_same_tree(a, b, where="cfg"):
    assert type(a) is type(b) or (isinstance(a, dict) and isinstance(b, dict)), \
        where
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same_tree(a[k], b[k], where + "." + k)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert a == b, where


def test_config_is_a_copy_of_the_jax_config():
    port = _fresh(os.path.join(REPO, "mv3d_tf_tpu_torch", "config.py"), "pc")
    jax_cfg = _fresh(os.path.join(REPO, "mv3d_tf_tpu", "config.py"), "jc")
    _assert_same_tree(port.cfg, jax_cfg.cfg)
    assert port.get_cfg() is port.cfg
    port.cfg_from_list(["TEST.NMS", "0.3", "TPU.MAX_GT", "16"])
    jax_cfg.cfg_from_list(["TEST.NMS", "0.3", "TPU.MAX_GT", "16"])
    _assert_same_tree(port.cfg, jax_cfg.cfg)
    with pytest.raises(AssertionError):
        port.cfg_from_list(["TEST.NMS", "'high'"])


def test_host_io_matches_jax_native(tmp_path):
    paths = _write_scans(tmp_path, COUNTS)
    got = TN.load_velodyne_batch(paths, bucket=BUCKET, n_threads=2)
    ref = JN.load_velodyne_batch(paths, bucket=BUCKET, n_threads=2)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    assert got[1].sum(1).tolist() == [BUCKET, BUCKET, 5000]
    for i, p in enumerate(paths):
        one = TN.load_velodyne_padded(p, bucket=BUCKET)
        assert np.array_equal(one[0], ref[0][i])
        assert np.array_equal(one[1], ref[1][i])
    empty = TN.load_velodyne_batch([], bucket=16)
    assert empty[0].shape == (0, 16, 4) and empty[1].shape == (0, 16)
    with pytest.raises(OSError):
        TN.load_velodyne_padded(str(tmp_path / "missing.bin"), bucket=16)


def test_read_lidar_cli_matches_jax(tmp_path, capsys):
    """Three scans, batch 2: every lidar_bv/*.npy equals the JAX package's
    point_cloud_2_top_batch on the same padded input, by the torch scatter
    (--device cpu) and by the numpy twin (--host)."""
    paths = _write_scans(tmp_path, COUNTS)
    pts, val = JN.load_velodyne_batch(paths, bucket=BUCKET)
    ref = np.asarray(J.point_cloud_2_top_batch(pts, val))
    out_dir = tmp_path / "lidar_bv"
    common = ["--root", str(tmp_path), "--batch", "2", "--bucket",
              str(BUCKET)]
    for extra in (["--device", "cpu"], ["--host"]):
        read_lidar.main(common + extra)
        lines = capsys.readouterr().out.splitlines()
        assert lines[:3] == ["Processed: %s.bin" % i for i in sorted(COUNTS)]
        assert lines[-1].startswith("3 scans in ")
        assert lines[-1].endswith(" scans/s")
        assert sorted(os.listdir(out_dir)) == [i + ".npy"
                                               for i in sorted(COUNTS)]
        for b, idx in enumerate(sorted(COUNTS)):
            top = np.load(str(out_dir / (idx + ".npy")))
            assert top.dtype == np.float32 and top.shape == (601, 601, 9)
            assert np.array_equal(top, ref[b]), (extra, idx)
        for f in out_dir.iterdir():
            f.unlink()
    read_lidar.main(common + ["--device", "cpu", "--count", "1"])
    assert os.listdir(out_dir) == ["000000.npy"]


def test_make_bird_view(tmp_path):
    (path,) = _write_scans(tmp_path, {"000007": 20000}, seed=3)
    got = make_bird_view(path, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    scan = J.load_velodyne(path)
    assert np.array_equal(got.numpy(), T.point_cloud_2_top_np(scan))
    assert np.array_equal(got.numpy(), J.point_cloud_2_top_np(scan))


def test_front_end_runs_without_the_jax_package(tmp_path):
    _write_scans(tmp_path, {"000000": 300})
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from mv3d_tf_tpu_torch.data.blob import make_bird_view\n"
        "from mv3d_tf_tpu_torch.ops.bev import point_cloud_2_top_batch\n"
        "from mv3d_tf_tpu_torch.tools import read_lidar\n"
        "pts = np.zeros((1, 8, 4), np.float32); pts[0, 0] = [10, 0, -1, .5]\n"
        "top = point_cloud_2_top_batch(pts, np.ones((1, 8), bool),\n"
        "                              device='cpu')\n"
        "assert top[0, 500, 300, 8] == 0.5\n"
        "root = sys.argv[1]\n"
        "read_lidar.main(['--root', root, '--device', 'cpu', '--bucket',\n"
        "                 '512'])\n"
        "assert make_bird_view(root + '/velodyne/000000.bin',\n"
        "                      device='cpu').shape == (601, 601, 9)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'mv3d_tf_tpu')]\n"
        "assert not bad, 'loaded: %s' % bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
    assert (tmp_path / "lidar_bv" / "000000.npy").exists()


def test_entry_points_default_to_the_card(tmp_path):
    """Without device=, the entry points and constructors ask for "cuda":
    where there is no card, they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device works here")
    (path,) = _write_scans(tmp_path, {"000000": 100})
    pts, val = T.pad_points(J.load_velodyne(path), 128)
    calls = {
        "point_cloud_2_top_batch": lambda: T.point_cloud_2_top_batch(
            pts[None], val[None]),
        "point_cloud_2_top": lambda: T.point_cloud_2_top(pts, val),
        "make_bird_view": lambda: make_bird_view(path),
        "read_lidar": lambda: read_lidar.main(["--root", str(tmp_path)]),
        "params_from_jax": lambda: params_from_jax(
            he_normal_params(0, fc_dim=8)),
        "init_params": lambda: TM.init_params(torch.Generator(), fc_dim=8),
    }
    for name, call in calls.items():
        with pytest.raises((AssertionError, RuntimeError)):
            call()
            pytest.fail(name + " ran without a card")
    assert not (tmp_path / "lidar_bv" / "000000.npy").exists()
