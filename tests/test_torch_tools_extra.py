"""The port's last MV3D tools (mv3d_tf_tpu_torch/tools/{gpu_selfcheck,
prenms_knee,bench_ab,microbench_int8,profile_detect,profile_loo}.py) on the
CPU at tiny shapes: --help, the refusals of TPU knobs, one short run each
with the keys of its printed result, and gpu_selfcheck's checks on the plain
versions with check 6 on a small golden that the JAX package writes here.

``write_detect_golden`` writes such a golden: the JAX package's
build_detect_fn in float32 on the CPU, on utils/weights.he_normal_params
(seed) and a RandomState(seed) frame (tools/tpu_selfcheck.py:200-203) with
check 5's calib (tpu_selfcheck.py:149-153), the recipe stored beside the
outputs. tests/golden_torch_fullshape.npz is its full-shape output (601x601x9
BEV, 384x1248x3 image, pre-NMS 6000, post-NMS 300), written once by

    python -c "import sys; sys.path[:0] = ['tests', '.']; import conftest; \\
        import test_torch_tools_extra as t; t.write_detect_golden(t.GOLDEN)"

and not recomputed here (a minute of CPU)."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden_torch_fullshape.npz")
TOOLS = ("gpu_selfcheck", "prenms_knee", "bench_ab", "microbench_int8",
         "profile_detect", "profile_loo")
_NO_JAX = (
    "bad = [m for m in sys.modules if m.split('.')[0] in\n"
    "       ('jax', 'jaxlib', 'mv3d_tf_tpu')]\n"
    "assert not bad, 'loaded: %s' % bad\n"
    "print('ok')\n")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread in this worker while the module runs: its shapes
    are tiny, and under xdist's parallel workers the default thread pool
    oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def selfcheck_calib():
    """tools/tpu_selfcheck.py:149-153 (rows P2, zeros, R0, Tr_velo_to_cam)."""
    calib = np.zeros((4, 12), np.float32)
    calib[0] = [707.0, 0, 601.8, 45.7, 0, 707.0, 183.1, -0.34,
                0, 0, 1.0, 0.005]
    calib[2, :9] = np.eye(3, dtype=np.float32).reshape(-1)
    calib[3] = [0.0002, -0.9999, -0.0106, -0.002, 0.0104, 0.0106,
                -0.9999, -0.075, 0.9999, 0.0002, 0.0105, -0.272]
    return calib


def write_detect_golden(path, seed=7, bev_shape=(601, 601, 9),
                        image_shape=(384, 1248, 3), fc_dim=2048,
                        pre_nms_top_n=6000, post_nms_top_n=300):
    """The JAX package's float32 single-frame detector on the recipe's frame
    and parameters, with the recipe, as an npz at path."""
    from mv3d_tf_tpu.eval import build_detect_fn
    from mv3d_tf_tpu_torch.utils.weights import he_normal_params
    rng = np.random.RandomState(seed)
    bev = rng.rand(*bev_shape).astype(np.float32)
    image = (rng.rand(*image_shape) * 255).astype(np.float32)
    calib = selfcheck_calib()
    feat = (bev_shape[0] // 8, bev_shape[1] // 8)
    detect = build_detect_fn(feat_h=feat[0], feat_w=feat[1],
                             pre_nms_top_n=pre_nms_top_n,
                             post_nms_top_n=post_nms_top_n)
    out = detect(he_normal_params(seed, fc_dim=fc_dim), bev, image, calib)
    recipe = {"function": "mv3d_tf_tpu.eval.build_detect_fn",
              "dtype": "float32", "device": "cpu",
              "params": "mv3d_tf_tpu_torch.utils.weights.he_normal_params",
              "seed": seed, "fc_dim": fc_dim,
              "frame": "np.random.RandomState(seed): bev = rand(*bev_shape), "
                       "image = rand(*image_shape) * 255",
              "bev_shape": list(bev_shape), "image_shape": list(image_shape),
              "feat_hw": list(feat), "pre_nms_top_n": pre_nms_top_n,
              "post_nms_top_n": post_nms_top_n}
    np.savez_compressed(
        path, recipe=np.array(json.dumps(recipe)), calib=calib,
        scores=np.asarray(out["scores"], np.float32),
        boxes_bv=np.asarray(out["boxes_bv"], np.float32),
        valid=np.asarray(out["valid"]))
    return path


def _tool(name):
    import importlib
    return importlib.import_module("mv3d_tf_tpu_torch.tools." + name)


@pytest.mark.parametrize("name", TOOLS)
def test_cli_help(name, capsys):
    with pytest.raises(SystemExit) as e:
        _tool(name).main(["--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out


@pytest.mark.parametrize("name, argv, want", [
    ("bench_ab", ["--rois-per-step", "12"], "Pallas ROI pool"),
    ("bench_ab", ["--pool-cwin", "8"], "Pallas ROI pool"),
    ("bench_ab", ["--pool-bins", "shared"], "Pallas ROI pool"),
    ("bench_ab", ["--conv-impl", "pallas"], "TPU lowering"),
    ("bench_ab", ["--conv-impl", "hybrid"], "TPU lowering"),
    ("bench_ab", ["--conv-impl", "dots"], "TPU lowering"),
    ("bench_ab", ["--conv-impl", "im2col"], "TPU lowering"),
    ("bench_ab", ["--stem", "s2d_int8"], "needs --int8"),
    ("microbench_int8", ["--pallas"], "TPU's Pallas kernels"),
])
def test_tpu_knobs_are_refused(name, argv, want):
    with pytest.raises(SystemExit, match=want):
        _tool(name).main(argv + ["--device", "cpu"])


def test_tools_import_no_jax(tmp_path):
    code = ("import sys\n"
            "from mv3d_tf_tpu_torch.parallel import dryrun, mesh, multihost\n"
            "from mv3d_tf_tpu_torch.tools import (bench_ab, gpu_selfcheck,\n"
            "    microbench_int8, prenms_knee, profile_detect, profile_loo)\n"
            + _NO_JAX)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


@pytest.fixture(scope="module")
def he8():
    """The port's he_normal_params(0, fc_dim=8) on the CPU, made once for
    the module (each tool call takes a copy)."""
    from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,
                                                  params_from_jax)
    return params_from_jax(he_normal_params(0, fc_dim=8), device="cpu")


@pytest.fixture
def small(monkeypatch, he8):
    """tools/profiling's reference shapes shrunk: a 41x41 BEV, a 40x48
    image, fc 8, a train budget of 40/10 proposals and 8 rois, and 20
    detection rois a frame in place of 300 (the 5x5 map has 100 anchors)."""
    import functools
    from mv3d_tf_tpu_torch import eval as E
    from mv3d_tf_tpu_torch import quant as Q
    from mv3d_tf_tpu_torch.tools import profile_loo, profiling
    def he_params(device, seed=0):
        assert seed == 0 and torch.device(device).type == "cpu"
        return copy.deepcopy(he8)

    monkeypatch.setattr(profiling, "he_params", he_params)
    monkeypatch.setattr(profiling, "BEV_HW", (41, 41))
    monkeypatch.setattr(profiling, "IMAGE_HW", (40, 48))
    monkeypatch.setattr(profiling, "FC_DIM", 8)
    monkeypatch.setattr(profiling, "TRAIN_PRE_NMS", 40)
    monkeypatch.setattr(profiling, "TRAIN_POST_NMS", 10)
    monkeypatch.setattr(profiling, "TRAIN_ROIS", 8)
    monkeypatch.setattr(E, "build_detect_batch_fn", functools.partial(
        E.build_detect_batch_fn, post_nms_top_n=20))
    monkeypatch.setattr(Q, "calibrate_pooled_features", functools.partial(
        Q.calibrate_pooled_features, post_nms_top_n=20))
    monkeypatch.setattr(profile_loo, "P_ROIS", 20)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv, keys", [
    (["--batch", "2"], {"ms_per_batch", "frames_per_s"}),
    (["--batch", "2", "--int8", "--stem", "s2d_int8", "--int8-head",
      "--int8-rpn", "--nms", "blocked_fixed"], {"ms_per_batch"}),
    (["--train"], {"ms_per_step", "loss"}),
    (["--train", "--batch", "2", "--stem", "s2d"], {"ms_per_step", "loss"}),
])
def test_bench_ab_runs(small, capsys, argv, keys):
    res = _tool("bench_ab").main(argv + ["--iters", "1", "--device", "cpu"])
    assert _last_json(capsys) == res
    assert keys <= set(res) and res["device"] == "cpu"
    assert all(np.isfinite(res[k]) for k in keys)


def test_profile_detect_runs(small, capsys):
    res = _tool("profile_detect").main(["--batch", "2", "--iters", "1",
                                        "--device", "cpu"])
    assert _last_json(capsys)["prefixes"] == [list(p) for p in
                                              res["prefixes"]]
    assert [p[0][:2] for p in res["prefixes"]] == ["P1", "P2", "P3", "P4",
                                                   "P5"]
    assert res["bf16_full_ms"] > 0


def test_profile_loo_runs(small, capsys):
    mod = _tool("profile_loo")
    res = mod.main(["--batch", "1", "--iters", "1", "--device", "cpu"])
    assert set(res["ms"]) == set(mod.VARIANTS)
    assert _last_json(capsys) == res
    res = mod.main(["--batch", "1", "--iters", "1", "--device", "cpu",
                    "--variants", "stem only,proposal/nms"])
    assert set(res["ms"]) == {"stem only", "no proposal/nms"}


def test_microbench_int8_runs(monkeypatch, capsys):
    mod = _tool("microbench_int8")
    monkeypatch.setattr(mod, "SHAPES", ((12, 12, 16, 16, "a"),
                                        (6, 10, 32, 32, "b")))
    rows = mod.main(["--batch", "1", "--gemm", "64", "--iters", "1",
                     "--device", "cpu"])
    assert _last_json(capsys) == rows
    assert len(rows) == 3 + 4 * 2
    assert {r["impl"] for r in rows[3:7]} == {
        "s8 conv kernel", "im2col + s8 GEMM kernel", "im2col + torch._int_mm",
        "bf16 conv2d (cuDNN)"}
    assert all(r["tops"] > 0 and r["peak_share"] > 0 for r in rows)


def test_prenms_knee_runs(monkeypatch, capsys, tmp_path):
    """Over a 4-frame synthetic tree cut to an 81x81 raster and an 88x120
    image, fc 16, K 50 then 20 (the baseline's agreement is 1)."""
    import functools
    from mv3d_tf_tpu_torch import eval as E
    from mv3d_tf_tpu_torch.config import cfg
    from mv3d_tf_tpu_torch.data import synthetic
    from mv3d_tf_tpu_torch.models import mv3d
    root = synthetic.generate(str(tmp_path / "kitti"), num_frames=4,
                              cars_per_frame=2, seed=3)
    bv = os.path.join(root, "object", "training", "lidar_bv")
    for name in os.listdir(bv):
        np.save(os.path.join(bv, name), np.load(os.path.join(bv, name))[:81,
                                                                          :81])
    monkeypatch.setitem(cfg.TPU, "IMAGE_SHAPE", (88, 120, 3))
    monkeypatch.setattr(cfg, "DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setattr(E, "build_detect_batch_fn", functools.partial(
        E.build_detect_batch_fn, feat_h=10, feat_w=10))
    monkeypatch.setattr(mv3d, "init_params", functools.partial(
        mv3d.init_params, fc_dim=16))
    rows = _tool("prenms_knee").main([
        "--kitti_path", root, "--frames", "2", "--batch", "2", "--ks", "50",
        "20", "--device", "cpu"])
    assert _last_json(capsys) == rows
    assert [r["pre_nms"] for r in rows] == [50, 20]
    assert rows[0]["keep_agree_vs_50"] == 1.0
    assert set(rows[1]) == {"pre_nms", "ms_per_batch", "keep_agree_vs_50",
                            "bev_ap@0.5", "bev_ap@0.7", "first_call_ms",
                            "valid_mean"}
    assert all(0.0 <= r["bev_ap@0.5"] <= 1.0 for r in rows)


def test_gpu_selfcheck_on_the_plain_versions(monkeypatch, capsys, tmp_path):
    """Every check on the CPU's plain versions at small shapes, check 6 on a
    golden that the JAX package writes here (81x81 BEV, 88x120 image, fc
    16): the port's float32 detector agrees with it within the bands."""
    mod = _tool("gpu_selfcheck")
    golden = write_detect_golden(
        str(tmp_path / "golden.npz"), bev_shape=(81, 81, 9),
        image_shape=(88, 120, 3), fc_dim=16, pre_nms_top_n=50,
        post_nms_top_n=10)
    monkeypatch.setitem(mod.SHAPES, "bev", (2, 4096))
    monkeypatch.setitem(mod.SHAPES, "roi_map", (10, 10, 16))
    monkeypatch.setitem(mod.SHAPES, "rois", 12)
    monkeypatch.setitem(mod.SHAPES, "stem", (1, 12, 40, 9))
    monkeypatch.setitem(mod.SHAPES, "nms_feat", 10)
    monkeypatch.setitem(mod.SHAPES, "nms", (100, 20))
    monkeypatch.setitem(mod.SHAPES, "conv3x3", (1, 9, 10, 64, 32))
    monkeypatch.setitem(mod.SHAPES, "conv2x2", (1, 11, 13, 64, 32))
    monkeypatch.setitem(mod.SHAPES, "gemm", (20, 64, 32))
    assert mod.main(["--device", "cpu", "--golden", golden]) == 0
    out = capsys.readouterr().out
    assert out.count("[ok]") == 14 and "[FAIL]" not in out
    assert "ALL OK" in out and "6 float32 detector" in out
    # a golden that disagrees fails check 6 and exits 1
    g = dict(np.load(golden))
    g["boxes_bv"] = g["boxes_bv"] + 2.0
    np.savez(str(tmp_path / "bad.npz"), **g)
    monkeypatch.setitem(mod.SHAPES, "bev", (1, 64))
    with pytest.raises(SystemExit) as e:
        mod.main(["--device", "cpu", "--golden", str(tmp_path / "bad.npz")])
    assert e.value.code == 1
    assert "[FAIL] 6 float32 detector" in capsys.readouterr().out


def test_fullshape_golden_carries_its_recipe():
    g = np.load(GOLDEN)
    recipe = json.loads(str(g["recipe"]))
    assert recipe["function"] == "mv3d_tf_tpu.eval.build_detect_fn"
    assert recipe["dtype"] == "float32" and recipe["seed"] == 7
    assert recipe["bev_shape"] == [601, 601, 9]
    assert recipe["image_shape"] == [384, 1248, 3]
    assert (recipe["fc_dim"], recipe["pre_nms_top_n"],
            recipe["post_nms_top_n"]) == (2048, 6000, 300)
    np.testing.assert_array_equal(g["calib"], selfcheck_calib())
    assert g["scores"].shape == (300, 2) and g["boxes_bv"].shape == (300, 8)
    assert g["valid"].dtype == bool and int(g["valid"].sum()) == 300
    assert np.isfinite(g["scores"]).all() and np.isfinite(g["boxes_bv"]).all()
