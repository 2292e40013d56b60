"""The 2-layer 256QAM deployment's files and the reading of the card's time
outside K3: the configuration and its cell load from BENCHMARK.json, the
transport sizing is TS 38.214 / 38.212's at MCS 20 of Table 5.1.3.1-2, the
configuration differs from the 1-layer one only where the deployment does,
and `kernel_ms_per_slot.outside_k3` is the kernels' union less K3's, over the
window's cell-slots, and nothing off the rule of `k3_roofline_pct`."""
import os

import pytest

from cebench import spec, trace
from cebench.gen import slots
from cebench.run import TraceContext
from cebench.window import Call, Window

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
outside_k3 = spec.load_module("metrics", "kernel_ms_per_slot.outside_k3")


def test_the_cell_and_its_configuration_load_from_benchmark_json():
    cell = spec.load_cell("pusch100_2l256_closed8", os.path.join(ROOT, "BENCHMARK.json"))
    cfg = cell.config
    assert cell.chips == 1 and cell.traffic == {"kind": "closed", "cells": 8}
    assert (cfg["name"], cfg["chain"], cfg["n_layers"], cfg["modulation"]) == (
        "pusch_n78_100mhz_4rx_2l256", "pusch_decoded", 2, "256qam")
    assert cfg["reduced"] == [] and cfg["limits"] == {
        "payload_bit_errors": 0, "blocks_not_ok": 0, "scalar_rel_err": 1e-05}
    assert [m["name"] for m in cell.end_to_end] == ["kernel_ms_per_slot", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {"k3_roofline_pct",
                                                   "kernel_ms_per_slot.outside_k3"}
    closed8 = spec.load_cell("pusch100_closed8", os.path.join(ROOT, "BENCHMARK.json"))
    assert "kernel_ms_per_slot.outside_k3" in {m["name"] for m in closed8.per_layer}


def test_the_configuration_differs_from_the_one_layer_file_only_where_the_deployment_does():
    one = spec.read_json("configs", "pusch_n78_100mhz_4rx.json")
    two = spec.read_json("configs", "pusch_n78_100mhz_4rx_2l256.json")
    differ = {k for k in set(one) | set(two) if one.get(k) != two.get(k)}
    assert differ == {"name", "source", "deployment", "n_layers", "modulation", "mcs_index",
                      "mcs_table", "e_bits_per_block", "n_filler", "assumed"}
    for k in ("cfo_hz", "tdl_taps", "channel", "rnti_n_id"):
        assert two["assumed"][k] == one["assumed"][k]


def test_the_layout_is_42_blocks_of_12480_bits_filling_the_slot():
    cfg = spec.read_json("configs", "pusch_n78_100mhz_4rx_2l256.json")
    lay = slots.pusch_layout(cfg)
    assert (lay.c_words, lay.tx_bits, lay.k, lay.n) == (42, 12480, 8448, 26112)
    assert lay.c_words * lay.tx_bits == 524_160 == 273 * 120 * 2 * 8
    # TS 38.212 5.2.2 at TBS 352,440: K' = (B + 24 C) / C, K = 22 Z
    assert (352_440 + 24 + 24 * 42) // 42 == 8416 == 8448 - cfg["n_filler"]
    # the payload a block: K' less its CRC24B (the TB CRC24A left out)
    assert 42 * (8416 - 24) == 352_440 + 24


def _window(slots_a_call=(8, 8)):
    return Window(t0=0.0, calls=[Call(float(i), i + 0.5, list(range(n)))
                                 for i, n in enumerate(slots_a_call)])


def _ctx(ops, counters, chain="pusch_decoded", win=None, t1=1000.0):
    cell = spec.Cell(name="x", chips=1, config={"chain": chain}, traffic={}, end_to_end=[],
                     per_layer=[])
    return TraceContext(cell=cell, window=win or _window(), device_name="x",
                        timeline=trace.Timeline(t0=0.0, t1=t1, device=ops), counters=counters)


RULE = {"launches.ldpc_stream": 2, "launches.ldpc": 0}


def test_outside_k3_is_the_kernels_union_less_k3s_over_the_slots():
    k3 = "void ldpc::layered_kernel_pair<__nv_bfloat16, 27>(ldpc::Args)"
    ops = [
        ("kernel", "receiver_a", 10.0, 30.0),
        ("kernel", "receiver_b", 20.0, 40.0),  # overlaps receiver_a: [10, 40) once
        ("gpu_memcpy", "Memcpy HtoD", 0.0, 100.0),  # a copy: not a kernel
        ("kernel", k3, 40.0, 140.0),
        ("kernel", "scan_outer_dim", 140.0, 150.0),
        ("kernel", "receiver_a", 200.0, 230.0),
        ("kernel", k3, 230.0, 330.0),
        ("kernel", "pack", 990.0, 1010.0),  # clipped to the window's end: 10 us
    ]
    got = outside_k3.read(_ctx(ops, RULE))
    # (30 + 10 + 30 + 10) us outside K3, over 16 cell-slots, in ms
    assert got == pytest.approx(80e-3 / 16)


@pytest.mark.parametrize("case", ["chain", "k3_launches", "k4_launched", "no_k3_kernel",
                                  "no_calls", "no_timeline"])
def test_outside_k3_reads_nothing_off_its_rule(case):
    k3 = [("kernel", "layered_kernel_pair", 10.0, 20.0), ("kernel", "x", 20.0, 30.0)]
    ctx = {
        "chain": lambda: _ctx(k3, RULE, chain="ce_factored"),
        "k3_launches": lambda: _ctx(k3, dict(RULE, **{"launches.ldpc_stream": 3})),
        "k4_launched": lambda: _ctx(k3, dict(RULE, **{"launches.ldpc": 1})),
        "no_k3_kernel": lambda: _ctx(k3[1:], RULE),
        "no_calls": lambda: _ctx(k3, RULE, win=Window(t0=0.0)),
        "no_timeline": lambda: TraceContext(cell=_ctx(k3, RULE).cell, window=_window(),
                                            device_name="x", counters=RULE),
    }[case]()
    assert outside_k3.read(ctx) is None
    assert outside_k3.read(_ctx(k3, RULE)) == pytest.approx(10e-3 / 16)
