"""The benchmark's files agree with each other and with BENCHMARK.json."""

import json
import re

import pytest

from conftest import CHECKOUT
from bftbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.Bench()


def spec():
    with open(CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.mark.parametrize("cell", BENCH.cells())
def test_workload_names_files_that_exist(cell):
    w = BENCH.data("workloads", cell)
    config = BENCH.data("configs", w["config"])
    mix = BENCH.data("traffic", w["traffic"])
    driver = BENCH.module("drivers", config["driver"])
    assert hasattr(BENCH.module("traffic", mix["kind"]), "generate")
    assert set(w["end_to_end"]) == {harness.SETUP, *driver.UNITS}
    for m in w["per_layer"]:
        mod = BENCH.module("metrics", m)
        assert UNIT.match(mod.UNIT) and callable(mod.read)
    for key in config["reduced"]:
        assert key in config


def test_benchmark_json_matches_the_files():
    s = spec()
    assert s["command"] == ["python3", "bftbench/run.py"]
    assert s["paths"] == ["bftbench"]
    assert {c["name"] for c in s["configs"]} == {
        BENCH.data("workloads", w["name"])["config"] for w in s["workloads"]}
    for c in s["configs"]:
        data = BENCH.data("configs", c["name"])
        assert c["file"] == f"bftbench/configs/{c['name']}.json"
        assert (c["source"], c["reduced"]) == (data["source"],
                                               data["reduced"])
    assert {w["name"] for w in s["workloads"]} <= set(BENCH.cells())
    for w in s["workloads"]:
        data = BENCH.data("workloads", w["name"])
        assert {k: w[k] for k in ("config", "traffic", "chips", "why")} == {
            k: data[k] for k in ("config", "traffic", "chips", "why")}
    e2e = {m["name"]: m for m in s["end_to_end"]}
    for w in s["workloads"]:
        data = BENCH.data("workloads", w["name"])
        listed = {n for n, m in e2e.items()
                  if w["name"] in m.get("workloads", [w["name"]])}
        assert listed == set(data["end_to_end"])
        driver = BENCH.module("drivers", BENCH.data(
            "configs", data["config"])["driver"])
        for n in data["end_to_end"]:
            assert e2e[n]["unit"] == {**driver.UNITS, "setup_s": "s"}[n]
    listed = [w["name"] for w in s["workloads"]]
    assert {m["name"] for m in s["per_layer"]} == {
        m for w in listed for m in BENCH.data("workloads", w)["per_layer"]}
    for m in s["per_layer"]:
        cells = [w for w in listed
                 if m["name"] in BENCH.data("workloads", w)["per_layer"]]
        assert m["workloads"] == cells
        assert m["unit"] == BENCH.module("metrics", m["name"]).UNIT
        assert m["moves"] in e2e
        for cell in cells:      # every cell reporting it reports what it moves
            assert m["moves"] in BENCH.data("workloads", cell)["end_to_end"]


def test_names_units_and_bounds_keep_to_the_contract():
    s = spec()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in s["workloads"]]:
        assert NAME.match(n), n
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in s["end_to_end"])
    assert 1 <= s["run_seconds"] <= 51
    for w in s["workloads"]:
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
