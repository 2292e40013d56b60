"""BENCHMARK.json and the files it names: every cell, configuration, traffic
mix and metric is found by name, and the file keeps to the contract's form."""
import json
import os
import re

import pytest

from cebench import spec
from cebench.tests.conftest import BENCHMARK, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(BENCHMARK) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "-m", "cebench.run"]
    assert b["paths"] == ["cebench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(BENCHMARK) <= 64 * 1024


def test_names_units_and_keys():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cebench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in {e["name"] for e in b["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_is_found_by_name(cell):
    c = spec.load_cell(cell, BENCHMARK)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    spec.load_module("chains", c.config["chain"])
    traffic = spec.load_module("traffic", c.traffic["kind"])
    assert callable(traffic.run) and callable(traffic.end_to_end)
    for m in c.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
        assert m["moves"] in reported
    # an end-to-end metric taken from the card is read by a reader of its own
    for m in c.end_to_end:
        if m["source"] == "device_trace":
            assert callable(spec.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("cfg", [c["name"] for c in bench()["configs"]])
def test_configuration_file(cfg):
    c = spec.read_json("configs", cfg + ".json")
    assert c["name"] == cfg and c["reduced"] == []
    assert {"source", "assumed", "guarantee", "limits", "chain"} <= set(c)
    assert len(c["source"]) <= 200


def test_unknown_names_are_refused():
    with pytest.raises(spec.SpecError):
        spec.load_cell("no_such_cell", BENCHMARK)
    with pytest.raises(spec.SpecError):
        spec.load_module("metrics", "../run")
    with pytest.raises(spec.SpecError):
        spec.load_module("metrics", "no_such_metric")


def test_the_open_loop_cell_kept_for_later_loads_from_its_files():
    cell = spec.load_workload("pusch100_open")
    assert cell.traffic == {"kind": "open_periodic", "rate_slots_per_s": 450, "max_batch": 16}
    traffic = spec.load_module("traffic", cell.traffic["kind"])
    assert traffic.warm_batches(cell.traffic) == list(range(1, 17))
    assert traffic.pool_slots(cell.traffic) == 32
    assert "pusch100_open" not in {w["name"] for w in bench()["workloads"]}
