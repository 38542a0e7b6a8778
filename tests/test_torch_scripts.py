"""The port's train -> test pipeline scripts (mv3d_tf_tpu_torch/scripts/)
under bash, with a stub ``python3`` first on PATH that records its argv
and, as train_net, prints the ``Wrote snapshot to: <path>`` lines that
utils/checkpoint.save_checkpoint prints. Checks the CLIs each script calls,
their device flags, the cfg, the snapshot handed to test_net, the log under
experiments/logs/, and the dataset cases against the JAX package's scripts
(experiments/scripts/), which get a stub ``python``."""

import os
import os.path as osp
import subprocess

import pytest

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
PORT = osp.join(ROOT, "mv3d_tf_tpu_torch", "scripts")
JAX = osp.join(ROOT, "experiments", "scripts")
CFG = "experiments/cfgs/faster_rcnn_end2end.yml"

# records its argv NUL-separated, one file a call; as train_net it writes
# two snapshots and exits with $STUB_TRAIN_RC
STUB = r"""#!/bin/bash
n=$(ls "$STUB_CALLS" | wc -l)
printf '%s\0' "$@" > "$STUB_CALLS/call_$n"
case "$*" in
  *train_net*)
    echo "Wrote snapshot to: $STUB_SNAPS/VGGnet_fast_rcnn_iter_2.pt"
    echo "iter: 3 / 3"
    echo "Wrote snapshot to: $STUB_SNAPS/VGGnet_fast_rcnn_iter_3.pt"
    exit "${STUB_TRAIN_RC:-0}"
    ;;
esac
echo "BEV AP@0.7 (car, R40): 0.0000  [0 gt]"
"""


@pytest.fixture
def run(tmp_path):
    """run(script, *args, train_rc=0) -> (returncode, [argv of each call],
    stdout) from a fresh working directory."""
    stubs = tmp_path / "bin"
    stubs.mkdir()
    for name in ("python3", "python"):
        (stubs / name).write_text(STUB)
        (stubs / name).chmod(0o755)

    def go(script, *args, train_rc=0):
        calls = tmp_path / "calls"
        calls.mkdir(exist_ok=True)
        for f in calls.iterdir():
            f.unlink()
        work = tmp_path / "work"
        work.mkdir(exist_ok=True)
        if script.startswith(JAX):   # the port's scripts make their log dir
            (work / "experiments" / "logs").mkdir(parents=True,
                                                  exist_ok=True)
        env = dict(os.environ, PATH="%s:%s" % (stubs, os.environ["PATH"]),
                   STUB_CALLS=str(calls), STUB_SNAPS=str(tmp_path / "snaps"),
                   STUB_TRAIN_RC=str(train_rc))
        proc = subprocess.run(["bash", script] + list(args), cwd=work,
                              env=env, capture_output=True, text=True,
                              timeout=60)
        argvs = [(calls / ("call_%d" % i)).read_text().split("\0")[:-1]
                 for i in range(len(list(calls.iterdir())))]
        return proc.returncode, argvs, proc.stdout
    return go


def _flags(argv):
    """An argv from its --device flag on: the flags both packages pass."""
    return argv[argv.index("--device") if "--device" in argv else 0:]


def test_mv3d_trains_then_tests_the_last_snapshot(run, tmp_path):
    rc, (train, test), out = run(osp.join(PORT, "mv3d.sh"), "cuda", "0",
                                 "none", "kitti_train", "3", "/data/kitti")
    assert rc == 0
    assert train == ["-m", "mv3d_tf_tpu_torch.tools.train_net",
                     "--device", "cuda", "--device_id", "0",
                     "--imdb", "kitti_train", "--iters", "3", "--cfg", CFG,
                     "--network", "MV3D_train", "--kitti_path", "/data/kitti"]
    snap = str(tmp_path / "snaps" / "VGGnet_fast_rcnn_iter_3.pt")
    assert test == ["-m", "mv3d_tf_tpu_torch.tools.test_net",
                    "--device", "cuda", "--device_id", "0",
                    "--weights", snap, "--imdb", "kitti_val", "--cfg", CFG,
                    "--network", "MV3D_test", "--kitti_path", "/data/kitti"]
    assert osp.isfile(osp.join(ROOT, CFG))
    logs = sorted(os.listdir(tmp_path / "work" / "experiments" / "logs"))
    assert len(logs) == 2 and logs[0].startswith("mv3d_kitti_train_")
    text = (tmp_path / "work" / "experiments" / "logs" / logs[0]).read_text()
    assert "Logging output to" in text and snap in text
    assert "BEV AP@0.7" in out


def test_mv3d_weights_cpu_and_default_iters(run):
    rc, (train, test), _ = run(osp.join(PORT, "mv3d.sh"), "cpu", "0",
                               "vgg16.npy", "kitti_trainval")
    assert rc == 0
    assert _flags(train)[:8] == ["--device", "cpu", "--device_id", "0",
                                 "--weights", "vgg16.npy",
                                 "--imdb", "kitti_trainval"]
    assert train[train.index("--iters") + 1] == "50001"
    assert "--kitti_path" not in train + test
    assert test[test.index("--imdb") + 1] == "kitti_val"


def test_a_failed_train_run_stops_the_pipeline(run):
    rc, argvs, _ = run(osp.join(PORT, "mv3d.sh"), "cpu", "0", "none",
                       "kitti_train", "2", train_rc=3)
    assert rc != 0 and len(argvs) == 1


@pytest.mark.parametrize("dataset,train_imdb,test_imdb,iters", [
    ("pascal_voc", "voc_2007_trainval", "voc_2007_test", "70000"),
    ("coco", "coco_2014_train", "coco_2014_minival", "490000")])
def test_faster_rcnn_end2end(run, tmp_path, dataset, train_imdb, test_imdb,
                             iters):
    extra = ["--set", "EXP_DIR", "e2e"]
    rc, (train, test), _ = run(osp.join(PORT, "faster_rcnn_end2end.sh"),
                               "cuda", "1", "VGGnet", dataset, *extra)
    assert rc == 0
    assert train == ["-m", "mv3d_tf_tpu_torch.tools.train_net",
                     "--device", "cuda", "--device_id", "1",
                     "--weights", "data/pretrain_model/VGG_imagenet.npy",
                     "--imdb", train_imdb, "--iters", iters, "--cfg", CFG,
                     "--network", "VGGnet_train"] + extra
    snap = str(tmp_path / "snaps" / "VGGnet_fast_rcnn_iter_3.pt")
    assert test == ["-m", "mv3d_tf_tpu_torch.tools.test_net",
                    "--device", "cuda", "--device_id", "1",
                    "--weights", snap, "--imdb", test_imdb, "--cfg", CFG,
                    "--network", "VGGnet_test"] + extra
    logs = os.listdir(tmp_path / "work" / "experiments" / "logs")
    assert any(f.startswith("faster_rcnn_end2end_VGGnet_--set_EXP_DIR_e2e_")
               for f in logs)
    # the JAX package's script calls the same train_net flags
    rc, argvs, _ = run(osp.join(JAX, "faster_rcnn_end2end.sh"), "cuda", "1",
                       "VGGnet", dataset, *extra)
    assert argvs[0] == ["tools/train_net.py"] + _flags(train)


@pytest.mark.parametrize("script,args", [
    ("mv3d.sh", ["cuda", "0", "none", "kitti_test"]),
    ("faster_rcnn_end2end.sh", ["cuda", "0", "VGGnet", "kitti"])])
def test_an_unknown_dataset_exits_1_as_in_jax(run, script, args):
    for where in (PORT, JAX):
        rc, argvs, out = run(osp.join(where, script), *args)
        assert (rc, argvs) == (1, []) and "No dataset given" in out


def test_mv3d_dataset_cases_match_jax(run):
    for dataset in ("kitti_train", "kitti_trainval"):
        args = ["cuda", "0", "w.npy", dataset, "5", "/k"]
        _, port, _ = run(osp.join(PORT, "mv3d.sh"), *args)
        _, jax, _ = run(osp.join(JAX, "mv3d.sh"), *args)
        assert jax[0] == ["tools/train_net.py"] + _flags(port[0])
