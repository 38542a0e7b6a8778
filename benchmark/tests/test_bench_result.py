"""The run's result line and its guards: the keys the contract names, the
comparison's numbers last, no result without a card, and the check of
loaded modules by whole top-level names."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.lib import harness as H
from benchmark.lib import timing
from benchmark.lib import trace as T
from benchmark.tests import small

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cell, traced, monkeypatch=None):
    return H.run_cell(cell, 2**31 + 3, 0.2, traced, device="cpu",
                      cell_files=small.cell_files(cell))


def test_untraced_line_keys_and_checks_last(capsys):
    out = _run("mv3d.detect_b8", False)
    assert list(out) == KEYS + ["checks"]
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    H.report(out)
    lines = capsys.readouterr()
    last = json.loads(lines.out.strip().splitlines()[-1])
    assert list(last)[-1] == "checks"
    assert lines.err.strip().splitlines()[-1].startswith("check ")


def test_traced_line_has_breakdown_and_per_layer(monkeypatch):
    # the traced readers time on a card; here a host clock and a made-up
    # profile stand in for them
    monkeypatch.setattr(timing, "stage_ms", timing.host_ms)
    monkeypatch.setattr(T, "profile", lambda fn, calls: (
        fn(), {"busy_s": 0.25, "window_s": 1.0,
               "device_ops": [["k", 0.25]], "idle_gaps": [["h", 0.75]]})[1])
    out = _run("mv3d.detect_b8", True)
    assert list(out) == KEYS + ["breakdown", "checks"]
    _, _, _, _, _, per_layer, _ = H.load_cell("mv3d.detect_b8")
    assert set(out["metrics"]) == set(per_layer)
    assert out["device"]["busy_s"] == 0.25
    assert out["metrics"]["device_idle.detect"]["value"] == 75.0
    assert out["metrics"]["device_idle.detect"]["unit"] == "%"


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("mv3d_tf_tpu_torch.x", "jaxtyping", "flax_like.y"):
        monkeypatch.setitem(sys.modules, name, object())
    assert H.forbidden_modules() == []
    for name in ("jax.numpy", "mv3d_tf_tpu.eval", "flax", "jaxlib"):
        monkeypatch.setitem(sys.modules, name, object())
    assert H.forbidden_modules() == ["flax", "jax.numpy", "jaxlib",
                                     "mv3d_tf_tpu.eval"]


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "mv3d.detect_b8", "--seed", "1", "--seconds", "1"],
                       cwd=H.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 2 and p.stdout == ""


def test_reference_imports_neither_the_port_nor_jax():
    code = ("import sys; sys.path.insert(0, %r); import importlib, pkgutil;"
            "import benchmark.reference as r;"
            "[importlib.import_module('benchmark.reference.' + m.name)"
            " for m in pkgutil.iter_modules(r.__path__)];"
            "print(sorted({k.split('.')[0] for k in sys.modules}))"
            % H.ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=dict(os.environ))
    assert p.returncode == 0, p.stderr
    top = set(eval(p.stdout))
    assert not top & {"jax", "jaxlib", "flax", "mv3d_tf_tpu",
                      "mv3d_tf_tpu_torch"}
