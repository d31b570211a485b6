"""BENCHMARK.json resolves to its files by name, and its names and units
keep to the characters allowed."""

import json
import pathlib
import re

import pytest

from mvsbench import harness

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mvsbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + [w["name"] for w in BENCH["workloads"]]
                         + [c["name"] for c in BENCH["configs"]])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"]), metric
    assert metric["better"] in ("lower", "higher")
    assert (harness.HERE / "metrics" / f"{metric['name']}.py").is_file()
    for w in metric.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    path = REPO / config["file"]
    assert path.is_file() and config["file"].startswith("mvsbench/configs/")
    data = json.loads(path.read_text())
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"] == []
    assert path.name == f"{config['name']}.json"


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(workload):
    cell = harness.load_cell(workload["name"], 1.0)
    assert workload["chips"] == 1
    assert (harness.HERE / "drivers" / f"{cell.traffic['kind']}.py").is_file()
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
    for m in cell.end_to_end + cell.per_layer:
        harness.reader(m["name"])
    assert {"prob_gap"} <= set(cell.limits) or {"step1_prob_gap", "loss_gap"} <= set(cell.limits)


def test_layers_named_alike():
    """Metrics of one layer give the same layer name."""
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"Features", "Matching", "Regularisation", "Plane sweep", "Kernels", "Model step",
                      "Device", "Train step"}
