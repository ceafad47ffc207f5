"""BENCHMARK.json against its own rules, and every file it names found by
name."""
import json
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer",
               "moves", "workloads"}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]


def names():
    out = [c["name"] for c in BENCH["configs"]]
    out += [w["name"] for w in BENCH["workloads"]]
    out += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    out += [w["config"] for w in BENCH["workloads"]]
    out += [w["traffic"] for w in BENCH["workloads"]]
    out += [k for c in BENCH["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("name", names())
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert set(m) <= METRIC_KEYS
    assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
    if "_roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_unique_names():
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in BENCH[group]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(ms) == len(set(ms))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_each_of_its_cells_reports(m):
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    assert TEXT.match(m["layer"])
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m["workloads"]) <= cells
    for cell in m["workloads"]:
        assert reports(e2e[m["moves"]], cell)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files_and_metrics(w):
    assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    here = harness.HERE
    for path in (here / "traffic" / f"{w['traffic']}.json",
                 here / "limits" / f"{w['name']}.json"):
        assert path.exists(), path
    e2e = [m["name"] for m in BENCH["end_to_end"] if reports(m, w["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m, w["name"]) for m in BENCH["per_layer"])


def test_few_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(c):
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    assert len(c["reduced"]) <= 16
    got = json.loads((harness.ROOT / c["file"]).read_text())
    assert got["name"] == c["name"] and got["source"] == c["source"]
    assert got["reduced"] == c["reduced"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])
