"""BENCHMARK.json against the contract's shapes, and every cell's files found by name."""

import json
import re

import pytest

from vo_bench import run

BENCH = json.loads((run.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vo_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_allowed(kind):
    names = [x["name"] for x in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    allowed = {"name", "unit", "better", "source", "workloads"} | (
        {"bound"} if metric in BENCH["end_to_end"] else {"layer", "moves"})
    assert set(metric) <= allowed
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells


def test_every_config_is_used_and_lies_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("vo_bench/") and (run.REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert json.loads((run.REPO / c["file"]).read_text())["name"] == c["name"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_are_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"} and cell["chips"] == 1
    assert NAME.match(cell["traffic"]) and LINE.match(cell["why"])
    spec = run.cell_spec(cell["name"])
    assert spec["traffic"]["name"] == cell["traffic"]
    assert spec["limits"]["workload"] == cell["name"]
    assert {m["name"] for m in spec["end_to_end"]} >= {"fps", "setup_s"}
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert (run.ROOT / "metrics" / f"{m['name']}.py").is_file()


def test_each_pair_of_config_and_traffic_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
