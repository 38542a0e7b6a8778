"""Multi-host evaluation in the port (mv3d_tf_tpu_torch/parallel/
multihost.py, solver.test_net(frame_indices), tools.test_net --host_id /
--merge_shards): shard ranges and names equal to the JAX package's; two
processes of the port (no jax loaded) each writing a shard with the JAX
tests' deterministic fake detector, merged into a detections.pkl
byte-identical to the port's and the JAX package's single-process run; and
the CLI's shards and merge byte-identical to its plain run."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu.parallel import multihost as JMH  # noqa: E402
from mv3d_tf_tpu_torch.parallel import multihost as MH  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NO_JAX = (
    "bad = [m for m in sys.modules if m.split('.')[0] in\n"
    "       ('jax', 'jaxlib', 'mv3d_tf_tpu')]\n"
    "assert not bad, 'loaded: %s' % bad\n"
    "print('ok')\n")

# tests/test_multihost.py:32-43, on whatever array type the loop passes
_FAKE = r"""
def fake_detect(params, bev, image, calib):
    s = float(np.asarray(bev).sum()) % 7.0
    P = 4
    return {"scores": np.full((P, 2), 0.1 + s / 10.0, np.float32),
            "boxes_bv": np.tile(np.arange(8, dtype=np.float32) * (1 + s),
                                (P, 1)),
            "boxes_cnr": np.zeros((P, 48), np.float32) + s,
            "boxes_cnr_r": np.ones((P, 48), np.float32) * s,
            "rois_3d": np.zeros((P, 7), np.float32),
            "valid": np.ones((P,), bool)}
"""

_SHARD = r"""
import sys
import numpy as np
from mv3d_tf_tpu_torch.config import cfg
from mv3d_tf_tpu_torch.data.kitti import KittiMV3D, prepare_roidb
from mv3d_tf_tpu_torch.parallel.multihost import run_host_shard
""" + _FAKE + r"""
cfg.ROOT_DIR = sys.argv[1]
root, host_id, host_count = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
imdb = KittiMV3D("train", kitti_path=root)
prepare_roidb(imdb)
run_host_shard(None, imdb, host_id, host_count, detect_fn=fake_detect,
               log=lambda *a: None)
""" + _NO_JAX


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread in this worker while the module runs: its shapes
    are tiny, and under xdist's parallel workers the default thread pool
    oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


def test_shard_indices_and_paths_match_jax():
    for n, h in ((10, 3), (8, 8), (5, 2), (7, 1), (0, 2), (3, 5)):
        got = [MH.shard_indices(n, i, h) for i in range(h)]
        assert got == [JMH.shard_indices(n, i, h) for i in range(h)]
        assert sum(got, []) == list(range(n))
        assert MH.shard_path("d", 1, h) == JMH.shard_path("d", 1, h)
    with pytest.raises(AssertionError):
        MH.shard_indices(4, 2, 2)


def test_two_process_merge_is_byte_identical(tmp_path):
    from mv3d_tf_tpu.config import cfg as jcfg
    from mv3d_tf_tpu.data.kitti import KittiMV3D as JKitti
    from mv3d_tf_tpu.data.kitti import prepare_roidb as j_prepare
    from mv3d_tf_tpu.solver import test_net as j_test_net
    from mv3d_tf_tpu_torch.config import cfg, get_output_dir
    from mv3d_tf_tpu_torch.data import synthetic
    from mv3d_tf_tpu_torch.data.kitti import KittiMV3D, prepare_roidb
    from mv3d_tf_tpu_torch.solver import test_net

    root = synthetic.generate(str(tmp_path / "kitti"), num_frames=5,
                              cars_per_frame=2, seed=7)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SHARD, str(tmp_path / "port"), root, str(h),
         "2"], cwd=str(tmp_path), env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for h in range(2)]
    scope = {"np": np}
    exec(_FAKE, scope)
    fake = scope["fake_detect"]
    saved = cfg.ROOT_DIR, jcfg.ROOT_DIR
    try:
        cfg.ROOT_DIR = str(tmp_path / "port")
        imdb = KittiMV3D("train", kitti_path=root)
        prepare_roidb(imdb)
        out_dir = get_output_dir(imdb, "default")
        test_net(None, imdb, detect_fn=fake, log=lambda *a: None)
        single = {}
        for name in ("detections.pkl", "detections_cnr.pkl"):
            with open(os.path.join(out_dir, name), "rb") as f:
                single[name] = f.read()

        jcfg.ROOT_DIR = str(tmp_path / "jax")
        jimdb = JKitti("train", kitti_path=root)
        j_prepare(jimdb)
        j_test_net(None, jimdb, detect_fn=fake, log=lambda *a: None)
        with open(os.path.join(str(tmp_path / "jax"), "output", "default",
                               jimdb.name, "default", "detections.pkl"),
                  "rb") as f:
            jax_single = f.read()

        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-1500:]
            assert out.strip().endswith("ok")
        merged = MH.merge_shards(imdb, 2, log=lambda *a: None,
                                 evaluate=False)
        for name in single:
            with open(os.path.join(out_dir, name), "rb") as f:
                assert f.read() == single[name], name
        assert single["detections.pkl"] == jax_single
        assert sum(len(b) > 0 for b in merged[0][1]) == imdb.num_images
        with open(MH.shard_path(out_dir, 1, 2), "rb") as f:
            payload = pickle.load(f)
        assert payload["indices"] == MH.shard_indices(imdb.num_images, 1, 2)
        assert set(payload) == {"host_id", "host_count", "indices", "boxes",
                                "boxes_cnr"}
    finally:
        cfg.ROOT_DIR, jcfg.ROOT_DIR = saved


_CLI = r"""
import functools, os, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
from mv3d_tf_tpu_torch import solver
from mv3d_tf_tpu_torch.config import cfg
from mv3d_tf_tpu_torch.data import synthetic
from mv3d_tf_tpu_torch.models import mv3d
from mv3d_tf_tpu_torch.tools.test_net import main
tmp = sys.argv[1]
root = synthetic.generate(os.path.join(tmp, "kitti"), num_frames=4,
                          cars_per_frame=2, seed=3)
# small frames: an 81x81 raster, an 88x120 image, fc 64
bv = os.path.join(root, "object", "training", "lidar_bv")
for name in os.listdir(bv):
    np.save(os.path.join(bv, name), np.load(os.path.join(bv, name))[:81, :81])
cfg.TPU.IMAGE_SHAPE = (88, 120, 3)
solver.build_detect_batch_fn = functools.partial(
    solver.build_detect_batch_fn, feat_h=10, feat_w=10)
mv3d.init_params = functools.partial(mv3d.init_params, fc_dim=64)
args = ["--device", "cpu", "--imdb", "kitti_val", "--kitti_path", root,
        "--dtype", "float32"]
sets = ["--set", "ROOT_DIR", tmp, "DATA_DIR", os.path.join(tmp, "data"),
        "TEST.RPN_PRE_NMS_TOP_N", "50", "TEST.RPN_POST_NMS_TOP_N", "10"]
out = os.path.join(tmp, "output", "default", "kitti_val", "default")
names = ("detections.pkl", "detections_cnr.pkl")
main(args + sets)
plain = [open(os.path.join(out, n), "rb").read() for n in names]
for n in names:
    os.remove(os.path.join(out, n))
for h in ("0", "1"):
    main(args + ["--host_id", h, "--host_count", "2"] + sets)
main(args + ["--host_count", "2", "--merge_shards"] + sets)
assert [open(os.path.join(out, n), "rb").read() for n in names] == plain
print("frames", len(pickle.loads(plain[0])[1]))
""" + _NO_JAX


def test_cli_shards_and_merge_equal_the_plain_run(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _CLI, str(tmp_path)],
                          cwd=str(tmp_path), env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "wrote shard " in proc.stdout
    assert "Evaluating merged detections (2 hosts)" in proc.stdout
    assert "frames 2" in proc.stdout
    assert proc.stdout.strip().endswith("ok")


def test_batch_slots_keep_the_whole_runs_rows():
    """solver._batch_slots: the whole run's batches (the tail's empty rows
    None, padded later), and a shard's frames in the same rows."""
    from mv3d_tf_tpu_torch.solver import _batch_slots
    assert _batch_slots(list(range(10)), 4) == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8, 9, None, None]]
    assert _batch_slots([4, 5, 6, 7], 8) == [
        [None, None, None, None, 4, 5, 6, 7]]
    assert _batch_slots([3, 4, 5], 4) == [[None, None, None, 3],
                                         [4, 5, None, None]]
    for n, h, b in ((10, 3, 4), (8, 2, 8), (7, 2, 3)):
        rows = {}
        for i in range(h):
            for slots in _batch_slots(MH.shard_indices(n, i, h), b):
                rows.update({f: s for s, f in enumerate(slots)
                             if f is not None})
        assert rows == {f: f % b for f in range(n)}
