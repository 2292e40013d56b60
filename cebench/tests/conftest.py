"""Small cells for the CPU: the benchmark's own configurations at 24 PRB (and,
for the PUSCH chain, an NR BG2 Z=32 code in place of BG1 Z=384, whose
decoder has no CPU route), run through `run.run_cell(device="cpu")`. A cell
kept in its files for a later PR (`ce40_closed4`) is loaded from them and
reports the closed loop's end-to-end metrics."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from cebench import spec  # noqa: E402

BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")


def small_cell(name: str) -> spec.Cell:
    with open(BENCHMARK) as f:
        bench = json.load(f)
    if any(w["name"] == name for w in bench["workloads"]):
        cell = spec.load_cell(name, BENCHMARK)
    else:
        cell = spec.load_workload(name)
        cell.end_to_end = [m for m in bench["end_to_end"] if m["name"] in ("slots_per_s", "setup_s")]
    cfg = dict(cell.config, n_prbs=24)
    if cfg["chain"] == "pusch_decoded":
        cfg.update(ldpc_bg=2, ldpc_z=32, e_bits_per_block=636, n_filler=16,
                   decoder=dict(cfg["decoder"], c2v_dtype=None))
    else:
        cfg.update(n_rx=4)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, cells=2)
    return cell


@pytest.fixture
def pusch_cell():
    return small_cell("pusch100_closed8")


@pytest.fixture
def ce_cell():
    return small_cell("ce40_closed4")
