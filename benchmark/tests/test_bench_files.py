"""BENCHMARK.json against the contract, and every cell's files found by
name: its configuration, traffic, driver, limits and per-layer readers."""

import json
import os
import re

import pytest

from benchmark.lib import harness as H

SPEC = H.load_json(H.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(H.ROOT, "BENCHMARK.json")) <= 65536
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51


def test_check_fits_the_day_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source", "workloads"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves", "workloads"})):
        for e in SPEC[group]:
            assert set(e) <= keys, (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")
            key = (group if group in ("configs", "workloads")
                   else "metric", e["name"])
            assert key not in names
            names.add(key)


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in SPEC["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c, work, cfg, traffic, e2e, per_layer, units = H.load_cell(cell)
    assert cfg["name"] == c["config"] and cfg["reduced"] == []
    assert c["chips"] == 1
    assert H.driver_class(work["driver"]) is not None
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    for m in per_layer:
        assert callable(H.metric_reader(m))
        moved = next(p["moves"] for p in SPEC["per_layer"] if p["name"] == m)
        assert moved in e2e, (m, moved)
    assert work["limits"] and all(isinstance(v, (int, float))
                                  for v in work["limits"].values())


def test_every_config_used_and_file_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/configs/")
        cfg = H.load_json(H.ROOT, c["file"])
        assert cfg["reduced"] == c["reduced"]


def test_traffic_files_are_data():
    for w in SPEC["workloads"]:
        path = os.path.join(H.BENCH, "traffic", w["traffic"] + ".json")
        with open(path) as f:
            assert "kind" in json.load(f)
