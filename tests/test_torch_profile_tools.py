"""The port's trace and profile tools on CPU: trace_detect.parse_trace on a
hand-written Chrome trace (top ops, hand kernels, idle gaps; the host lane
when a trace has no device events), then each tool's main with --device
cpu at small shapes (tools/profiling's reference shapes patched to a 41x41
BEV, a 40x48 image, fc 8 and a train budget of 40/10 proposals and 8
rois), printing its table. chip_smoke.py runs them on the card at the
reference shapes, where their times mean something."""

import copy
import json

import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu_torch.tools import (profile_bev, profile_stages,  # noqa: E402
                                     profile_train, profiling, trace_detect,
                                     trace_train)

ROI = ("void (anonymous namespace)::roi_pool_kernel<float>(float const*, "
       "float const*, float*, int)")
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_parse_trace_device_lane(tmp_path):
    """Kernels at 0-10 and 5-15 us (overlapping), 30-35 and a memcpy at
    50-52: total 27 us, busy 22 of a 52 us span, two 15 us gaps; host ops
    and flow events are not the device's."""
    events = [
        {"ph": "X", "cat": "kernel", "name": ROI, "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": GEMM, "ts": 5, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": ROI, "ts": 30, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 50,
         "dur": 2},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0,
         "dur": 500, "pid": 1, "tid": 1},
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 3},
    ]
    lines = []
    res = trace_detect.parse_trace(_trace(tmp_path, events), top=2, steps=2,
                                   log=lines.append)
    assert res["lane"] == "device"
    assert res["total_ms"] == pytest.approx(0.027)
    assert res["busy_ms"] == pytest.approx(0.022)
    assert res["span_ms"] == pytest.approx(0.052)
    assert res["idle_share"] == pytest.approx(1 - 22 / 52)
    assert res["ops"][0] == ("roi_pool_kernel<float>", pytest.approx(0.015), 2)
    assert res["hand"] == {"roi_pool_kernel<float>": (pytest.approx(0.015),
                                                      2)}
    assert res["gaps"] == [(pytest.approx(0.015), pytest.approx(0.015)),
                           (pytest.approx(0.035), pytest.approx(0.015))]
    text = "\n".join(lines)
    assert "roi_pool_kernel<float>" in lines[2] and GEMM[:40] in lines[3]
    assert "Memcpy" not in text                  # top=2
    assert "  roi_pool_kernel<float>" in text    # the hand-kernel section
    assert lines[0].startswith("device total: 0.027 ms over 2 steps")


def test_parse_trace_host_lane(tmp_path):
    """No device event: the top-level host ops of each thread, nested ones
    left out."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0,
         "dur": 100, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::convolution", "ts": 10,
         "dur": 80, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 150,
         "dur": 50, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 20,
         "dur": 10, "pid": 1, "tid": 2},
    ]
    res = trace_detect.parse_trace(_trace(tmp_path, events), log=lambda *a:
                                   None)
    assert res["lane"] == "host" and res["hand"] == {}
    assert dict((n, (ms, c)) for n, ms, c in res["ops"]) == {
        "aten::conv2d": (pytest.approx(0.1), 1),
        "aten::add": (pytest.approx(0.06), 2)}


_HE = {}
_he_params = profiling.he_params


def _cached_he_params(device, seed=0):
    """A copy of one He-scaled parameter set per (device, seed): the tools
    here make five, and each takes seconds on the CPU."""
    key = (str(device), seed)
    if key not in _HE:
        _HE[key] = _he_params(device, seed)
    return copy.deepcopy(_HE[key])


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(profiling, "he_params", _cached_he_params)
    monkeypatch.setattr(profiling, "BEV_HW", (41, 41))
    monkeypatch.setattr(profiling, "IMAGE_HW", (40, 48))
    monkeypatch.setattr(profiling, "FC_DIM", 8)
    monkeypatch.setattr(profiling, "TRAIN_PRE_NMS", 40)
    monkeypatch.setattr(profiling, "TRAIN_POST_NMS", 10)
    monkeypatch.setattr(profiling, "TRAIN_ROIS", 8)


def test_trace_tools_on_the_cpu(small, tmp_path, capsys):
    """trace_detect (B=2) and trace_train, one traced step each, then
    --parse-only of trace_detect's file: the host-op table."""
    res = trace_detect.main(["--batch", "2", "--steps", "1", "--pre-nms",
                             "50", "--out", str(tmp_path / "td"), "--top",
                             "5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert res["lane"] == "host" and len(res["ops"]) > 5
    assert "traced 1 steps at" in out and "op " in out
    assert "hand kernels (csrc/) in the trace:\n  none" in out
    again = trace_detect.main(["--parse-only", "--steps", "1", "--out",
                               str(tmp_path / "td")])
    assert again["ops"] == res["ops"]
    res = trace_train.main(["--steps", "1", "--out", str(tmp_path / "tt"),
                            "--device", "cpu", "--nms", "blocked_fixed"])
    out = capsys.readouterr().out
    assert "first step:" in out and "traced 1 steps at" in out
    assert any(n.startswith("autograd::") for n, _, _ in res["ops"])


def test_profile_tools_on_the_cpu(small, tmp_path, capsys):
    """profile_stages (B=2, with its trace), profile_bev (B=2, 4096 points)
    and profile_train (its four variants), one timed iteration each."""
    times = profile_stages.main(["--batch", "2", "--iters", "1", "--trace",
                                 str(tmp_path / "ps"), "--device", "cpu"])
    out = capsys.readouterr().out
    for stage in ("trunks (both)", "proposal layer (NMS)", "roi pool x2",
                  "fusion head + decode", "WHOLE call"):
        assert stage in times and stage in out
    assert "stage sum" in out and "device busy: not measured" in out
    assert (tmp_path / "ps" / "trace.json").is_file()
    times = profile_bev.main(["--batch", "2", "--points", "4096", "--iters",
                              "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert list(times) == ["elementwise prep", "stable sort + gathers",
                           "placement", "WHOLE point_cloud_2_top_batch"]
    assert "scans/s" in out
    ms = profile_train.main(["--iters", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert list(ms) == ["full", "small_nms", "plain_pool", "f32"]
    for what in ("proposal/NMS budget share", "plain pool over the kernels",
                 "f32 over bf16"):
        assert "-> " + what in out
