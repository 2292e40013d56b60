"""A cell's description, read from the data files by name.

`BENCHMARK.json` (at the checkout's root) lists the cells and the metrics;
`cebench/workloads/<cell>.json` names the cell's configuration and traffic
mix; `cebench/configs/<config>.json` holds the deployment as it is run;
`cebench/traffic/<mix>.json` the mix's parameters and its `kind`, whose
generator is `cebench/traffic/<kind>.py`. Metric readers are
`cebench/metrics/<metric>.py`. Nothing here imports torch or the program.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
_NAME_OK = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")


class SpecError(ValueError):
    """A cell, a file or a metric that the data files do not describe."""


def check_name(name: str) -> str:
    """A name as BENCHMARK.json allows it (letters, digits, `_`, `.`, `-`; at
    most 64, not starting with `.` or `-`): it names a file below."""
    if not (isinstance(name, str) and 0 < len(name) <= 64 and set(name) <= _NAME_OK
            and name[0] not in ".-"):
        raise SpecError(f"not a name: {name!r}")
    return name


def read_json(*parts: str) -> dict:
    path = os.path.join(HERE, *parts)
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"no file {os.path.relpath(path, os.path.dirname(HERE))}") from None


def load_module(kind: str, name: str) -> ModuleType:
    """`cebench/<kind>/<name>.py` as a module (a name may hold dots)."""
    path = os.path.join(HERE, kind, check_name(name) + ".py")
    if not os.path.isfile(path):
        raise SpecError(f"no file cebench/{kind}/{name}.py")
    spec = importlib.util.spec_from_file_location(f"cebench.{kind}.{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell of BENCHMARK.json with everything its files say."""

    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<mix>.json: "kind" and its parameters
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_workload(name: str) -> Cell:
    """The cell `name` from its own files alone (cebench/workloads/<name>.json),
    on one chip and with no metrics: for the tools that run a cell the
    benchmark does not list (sweep.py)."""
    wl = read_json("workloads", check_name(name) + ".json")
    return Cell(name=name, chips=1,
                config=read_json("configs", check_name(wl["config"]) + ".json"),
                traffic=read_json("traffic", check_name(wl["traffic"]) + ".json"),
                end_to_end=[], per_layer=[])


def load_cell(name: str, benchmark_path: str = "BENCHMARK.json") -> Cell:
    """The cell `name` of the BENCHMARK.json at `benchmark_path`."""
    try:
        with open(benchmark_path) as f:
            bench = json.load(f)
    except FileNotFoundError:
        raise SpecError(f"no {benchmark_path}") from None
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SpecError(f"BENCHMARK.json has no cell {name!r}")
    cell = load_workload(name)
    wl = read_json("workloads", name + ".json")
    for key in ("config", "traffic"):
        if wl[key] != entry[key]:
            raise SpecError(f"cell {name}: {key} is {entry[key]!r} in BENCHMARK.json, "
                            f"{wl[key]!r} in cebench/workloads/{name}.json")
    cell.chips = int(entry["chips"])
    cell.end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
    cell.per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return cell
