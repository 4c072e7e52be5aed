"""BENCHMARK.json keeps to the benchmark's contract, and every file it
names is found by name: each cell's configuration and traffic mix, each
traffic kind's loop, each metric's reader."""

import json
import math
import os
import re

import pytest
from conftest import ROOT, benchmark

from futbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = benchmark()


def test_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["futbench"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [x["name"] for x in BENCH[group]]
        assert len(group_names) == len(set(group_names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("futbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(ROOT, "futbench", "metrics", f"{m['name']}.py"))


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        spec = run.cell_spec(ROOT, w["name"])
        e2e = {m["name"] for m in spec["e2e"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]
        for m in spec["per_layer"]:
            assert w["name"] in [x["name"] for x in BENCH["workloads"]]
            assert m["moves"] in e2e


def test_run_seconds_fits_the_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load_by_name(cell):
    spec = run.cell_spec(ROOT, cell)
    config = run.load_json("configs", spec["config"])
    traffic = run.load_json("traffic", spec["traffic"])
    assert config["name"] == spec["config"]
    loop = run.load_module("loops", traffic["kind"])
    assert hasattr(loop, "Cell")
    for m in spec["e2e"] + spec["per_layer"]:
        assert callable(run.load_module("metrics", m["name"]).read)


def test_configs_state_their_source():
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        assert config["source"] == c["source"] and config["reduced"] == c["reduced"]
        assert config["compute_dtype"] == "bfloat16"


def test_file_is_small():
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert math.isfinite(BENCH["run_seconds"])
