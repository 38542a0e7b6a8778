"""The port's evaluation CLIs (tools/test_net.py, tools/quant_check.py) in
subprocesses: --help, test_net's refusals of bad arguments, and test_net end
to end on the CPU over a synthetic tree the port writes, with no module of
jax or the JAX package loaded."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("mv3d_tf_tpu_torch.tools.test_net",
         "mv3d_tf_tpu_torch.tools.quant_check")
_NO_JAX = (
    "bad = [m for m in sys.modules if m.split('.')[0] in\n"
    "       ('jax', 'jaxlib', 'mv3d_tf_tpu')]\n"
    "assert not bad, 'loaded: %s' % bad\n"
    "print('ok')\n")


def _run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("module", TOOLS)
def test_cli_help(module, tmp_path):
    proc = _run(["-m", module, "--help"], str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "--kitti_path" in proc.stdout and "--device" in proc.stdout


def test_test_net_refusals(tmp_path):
    """No arguments prints the help and exits 1 (tools/test_net.py:55-57);
    the legacy 2D network VGGnet_test is taken and goes on to the dataset,
    where a name of no dataset raises KeyError."""
    code = (
        "import sys\n"
        "from mv3d_tf_tpu_torch.tools.test_net import main\n"
        "for argv, want in (([], '1'),\n"
        "                   (['--network', 'VGGnet_test', '--imdb',\n"
        "                     'coco2014'], 'Unknown dataset')):\n"
        "    try:\n"
        "        main(argv)\n"
        "    except (SystemExit, KeyError) as e:\n"
        "        msg = str(e.code if isinstance(e, SystemExit) else e)\n"
        "        assert want in msg, (argv, msg)\n"
        "    else:\n"
        "        raise AssertionError(argv)\n" + _NO_JAX)
    proc = _run(["-c", code], str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")


def test_test_net_end_to_end_on_the_cpu(tmp_path):
    """The port writes a 2-frame synthetic tree, then test_net evaluates
    its val split in float32 on the CPU at full width (601x601 BEV, 384x1248
    image) with a small proposal budget: the three pickles and the AP
    tables, with outputs under tmp_path."""
    root = str(tmp_path / "kitti")
    code = (
        "import sys\n"
        "from mv3d_tf_tpu_torch.data import synthetic\n"
        "from mv3d_tf_tpu_torch.tools.test_net import main\n"
        "synthetic.generate(%r, num_frames=2, cars_per_frame=2, seed=1)\n"
        "main(['--device', 'cpu', '--imdb', 'kitti_val', '--kitti_path', %r,\n"
        "      '--dtype', 'float32', '--set', 'ROOT_DIR', %r,\n"
        "      'DATA_DIR', %r, 'TEST.RPN_PRE_NMS_TOP_N', '200',\n"
        "      'TEST.RPN_POST_NMS_TOP_N', '20'])\n" % (
            root, root, str(tmp_path), str(tmp_path / "data")) + _NO_JAX)
    proc = _run(["-c", code], str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")
    assert "im_detect: 1/1" in proc.stdout
    assert "BEV AP@0.7" in proc.stdout and "quality mode" in proc.stdout
    out = tmp_path / "output" / "default" / "kitti_val" / "default"
    for name in ("detections.pkl", "detections_cnr.pkl",
                 "detections_cnr_r.pkl"):
        assert (out / name).is_file(), name
