"""`BENCHMARK.json` and the files it names: the contract's static rules,
and every cell's configuration, traffic, driver and readers found by
name."""

import json
import math
import re

import pytest

from perfbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FILE = re.compile(r"^[A-Za-z0-9_.\-/]+$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def spec():
    return core.load_spec()


def test_top_level_keys(spec):
    assert set(spec) == TOP
    assert spec["command"] == ["python3", "perfbench/run.py"]
    assert spec["paths"] == ["perfbench"]
    assert len(json.dumps(spec)) <= 64 * 1024


def test_run_seconds_fit_24_cells(spec):
    rs = spec["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(spec):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    for group in ("configs", "workloads"):
        got = [n for g, n in names if g == group]
        assert len(got) == len(set(got))
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


def test_entry_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and FILE.match(c["file"])
        assert (core.ROOT / c["file"]).exists()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_config_is_used_and_pairs_are_unique(spec):
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(spec["workloads"]) // 4)


def test_metrics_name_what_they_move(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for w in m.get("workloads", []):
            assert w in cells
            assert core.applies(e2e[m["moves"]], w, [])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or m["name"].startswith("mfu"):
            assert m["unit"] == "%"
    # the layer's name is written alike wherever a layer recurs
    layers = {}
    for m in spec["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in core.load_spec()
                                  ["workloads"]])
def test_cell_files_load_and_name_each_other(spec, cell):
    c = core.load_cell(spec, cell)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    driver = core.load_driver(c.traffic["driver"])
    assert callable(driver.run) and callable(driver.judge)
    assert callable(driver.judge_control)
    for m in c.per_layer:
        assert callable(core.load_reader(m["name"]))
    assert set(c.config["limits"]) and c.config["reference"]
    assert (core.ROOT / c.config["reference"]).exists()


def test_bounds_are_shares(spec):
    for m in spec["end_to_end"]:
        assert not math.isnan(m["bound"])
