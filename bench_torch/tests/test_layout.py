"""BENCHMARK.json against the contract's form, and every file it names
found by name."""

import json
import os
import re

import pytest

from bench_torch import harness, traffic

from .conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["bench_torch"]
    assert all(LINE.match(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append((section, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert LINE.match(e[key]), (e["name"], key)
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_metrics_form():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["source"] in SOURCES and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e
        reporting = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(reporting), m["name"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.Cell.find(ROOT, cell)
    assert os.path.isfile(os.path.join(ROOT, "bench_torch", "references",
                                       f"{c.config['reference']}.py"))
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        path = os.path.join(ROOT, "bench_torch", "metrics",
                            f"{m['name']}.py")
        assert callable(harness._module(path).read), m["name"]


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert cfg["file"] == f"bench_torch/configs/{cfg['name']}.json"
    body = json.load(open(os.path.join(ROOT, cfg["file"])))
    assert body["name"] == cfg["name"]
    assert cfg["reduced"] == []          # the datasets' full scale
    assert {w["config"] for w in BENCH["workloads"]} >= {cfg["name"]}
    harness.system_config(body["program"])       # the program takes it


@pytest.mark.parametrize("mix", sorted({w["traffic"]
                                        for w in BENCH["workloads"]}))
def test_traffic_files(mix):
    spec = traffic.load(ROOT, mix)
    assert spec["top_k"] > 0 and spec["calls"] > 0
