"""BENCHMARK.json, the cells and the configurations: each parses, keeps
the contract's keys and names, and every per-layer metric names one
end-to-end metric that every cell reporting it also reports."""
import json
import re

import pytest

from nwsbench import counts, harness

BENCH = harness.read_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["nwsbench"] and BENCH["command"][1] == "nwsbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    # a full check: 2 + 14 runs a cell of run_seconds + 60, 2 x 90 s a cell to compile
    # and 1200 spare fit 43200 s even at 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parses(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    body, config = harness.load_cell(cell)
    assert body["name"] == cell and body["config"] == entry["config"] == config["name"]
    assert body["traffic"] == entry["traffic"] and entry["chips"] == 1
    assert (harness.HERE / "traffic" / f"{body['traffic']}.py").exists()
    assert set(body["checks"]) and all(v > 0 for v in body["checks"].values())
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert body["traffic"] in config["block"] and body["traffic"] in config["launch_counters"]


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_parses(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    body = harness.read_json(harness.ROOT / entry["file"])
    assert entry["file"].startswith("nwsbench/") and body["name"] == config
    assert entry["reduced"] == body["reduced"] == []
    assert counts.n_params(body["model"]) == body["parameters"]
    assert any(w["config"] == config for w in BENCH["workloads"])


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric(metric):
    spec = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert spec["moves"] in e2e
    for cell in spec.get("workloads", CELLS):
        assert cell in CELLS
        assert cell in e2e[spec["moves"]].get("workloads", CELLS)
    assert (harness.HERE / "metrics" / f"{metric}.py").exists()
    if metric.split(".")[0].endswith("_roofline") or "mfu" in metric:
        assert spec["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_and_a_layer(cell):
    e2e = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
