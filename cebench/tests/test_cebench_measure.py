"""The arithmetic of the measurements, on made-up records: the rate and the
percentiles cover every call and slot of the window, the idle share is the
complement of the union of the device's operations, a gap is named by the
host event inside it, the card's time a cell-slot is the union of the
kernels' intervals over every slot, the host-paced rate is read from the
untraced window, and K3's count is chip_smoke's formula."""
import json

import numpy as np
import pytest

from cebench import roofline, spec, trace
from cebench.gen import ldpc_code, nr_ldpc
from cebench.run import Reservoir, TraceContext
from cebench.window import Call, Window

closed = spec.load_module("traffic", "closed")
open_periodic = spec.load_module("traffic", "open_periodic")
kernel_ms_per_slot = spec.load_module("metrics", "kernel_ms_per_slot")
host_paced = spec.load_module("metrics", "slots_per_s.host_paced")


def test_rate_is_every_slot_over_the_whole_window():
    win = Window(t0=10.0, calls=[Call(10.0, 10.5, [0, 1]), Call(10.5, 11.0, [2, 3]),
                                 Call(11.0, 12.0, [0, 1])])
    assert closed.end_to_end(win)["slots_per_s"] == pytest.approx(6 / 2.0)


def test_percentiles_cover_every_slot():
    rng = np.random.default_rng(0)
    calls, lat = [], []
    for i in range(200):
        due = [float(i), float(i) + 0.25][: 1 + i % 2]
        end = i + 0.5 + float(rng.exponential(0.1))
        calls.append(Call(start=i + 0.3, end=end, slots=list(range(len(due))), due=due))
        lat += [end - d for d in due]
    win = Window(t0=0.0, calls=calls)
    out = open_periodic.end_to_end(win)
    assert len(lat) == 300
    assert out["slot_p95_ms"] == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert out["slot_p50_ms"] == pytest.approx(np.percentile(lat, 50) * 1e3)


def test_closed_loop_calls_until_the_window_closes():
    seen = []
    win = closed.run(lambda ids: seen.append(list(ids)), {"cells": 3}, 0.05, n_pool=6)
    assert len(win.calls) == len(seen) > 1
    assert seen[0] == [0, 1, 2] and seen[1] == [3, 4, 5]
    assert win.slots == 3 * len(seen)


def test_open_loop_serves_every_due_slot_once():
    seen = []
    params = {"rate_slots_per_s": 400.0, "max_batch": 4}
    win = open_periodic.run(lambda ids: seen.extend(ids), params, 0.1, n_pool=8)
    assert win.slots == 40 and len(seen) == 40
    assert all(len(c.slots) <= 4 for c in win.calls)
    dues = [d for c in win.calls for d in c.due]
    assert np.allclose(np.diff(dues), 1 / 400.0)


def timeline():
    t = trace.Timeline(t0=0.0, t1=100.0)
    t.device = [("kernel", "k_a", 10.0, 20.0), ("kernel", "k_b", 15.0, 30.0),
                ("gpu_memcpy", "Memcpy HtoD", 50.0, 55.0), ("kernel", "k_a", 95.0, 120.0)]
    t.host = [("cebench.window", 0.0, 100.0), ("aten::to", 30.0, 50.0),
              ("cudaEventSynchronize", 31.0, 40.0), ("aten::empty", 60.0, 61.0)]
    return t


def test_idle_share_is_the_union_complement():
    t = timeline()
    assert t.busy_us() == pytest.approx(20 + 5 + 5)  # [10, 30], [50, 55], [95, 100]
    ctx = type("Ctx", (), {"timeline": t})()
    assert spec.load_module("metrics", "device_idle_pct.tput").read(ctx) == pytest.approx(70.0)


def test_gaps_are_named_by_the_host_event_inside():
    t = timeline()
    gaps = t.gaps()
    assert gaps[0] == (55.0, 95.0) and gaps[1] == (30.0, 50.0) and gaps[2] == (0.0, 10.0)
    assert t.name_gap(30.0, 50.0) == "aten::to"
    assert t.name_gap(55.0, 95.0) == "aten::empty"
    assert t.name_gap(0.0, 10.0) == "no host event"
    assert t.top_ops()[0] == ["k_a", pytest.approx(15e-6)]


def test_chrome_trace_is_read(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "cebench.window", "ts": 5, "dur": 50},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 5},
          {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": 20, "dur": 4},
          {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 20}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    t = trace.read_chrome_trace(str(p))
    assert (t.t0, t.t1) == (5.0, 55.0) and t.kernels() == [("k", 10.0, 15.0)]


def test_k3_count_is_chip_smokes_formula():
    code = nr_ldpc.nr_base_graph(1, 384)
    plan = ldpc_code.make_ldpc_plan(code)
    edges = sum(s >= 0 for row in code.base for s in row)
    assert len(plan.edges) == edges
    # chip_smoke.py ldpc_ops, layered: len(plan.edges) * z * batch * 9 * iters
    assert roofline.k3_ops(len(plan.edges), code.z, 96, 16) == edges * 384 * 96 * 9 * 16
    assert roofline.k3_bytes(code.n, 96) == 2 * 4 * 68 * 384 * 96
    t = roofline.least_time_s(roofline.k3_bytes(code.n, 96),
                              roofline.k3_ops(len(plan.edges), code.z, 96, 16),
                              "NVIDIA H100 80GB HBM3")
    assert t == pytest.approx(max(2 * 4 * 68 * 384 * 96 / 3.35e12, edges * 384 * 96 * 144 / 67e12))
    assert roofline.least_time_s(1.0, 1.0, "cpu") is None


def test_reservoir_keeps_a_uniform_sample():
    counts = np.zeros(100)
    for s in range(400):
        r = Reservoir(10, np.random.default_rng(s))
        for i in range(100):
            r.offer(i)
        assert len(r.items) == 10
        counts[r.items] += 1
    assert counts.min() > 0 and counts.max() < 4 * counts.mean()


def test_union_of_intervals():
    assert trace._union_us([]) == 0.0
    # ns: [0, 10) and [5, 20) overlap, [30, 40) stands apart, [40, 41) touches it
    assert trace._union_us([(0, 10_000), (5_000, 20_000), (30_000, 40_000),
                            (40_000, 41_000)]) == pytest.approx(31.0)


def test_card_time_is_every_kernel_over_every_slot():
    win = Window(t0=0.0, calls=[Call(0.0, 1.0, [0, 1]), Call(1.0, 2.0, [2, 3])])
    d = trace.DeviceTime(kernel_us=800.0, busy_us=900.0, copy_us=100.0, ops=12, kernels=10,
                         span_us=1.9e6)
    ctx = TraceContext(cell=None, window=win, device_name="x", device_time=d)
    assert kernel_ms_per_slot.read(ctx) == pytest.approx(0.8 / 4)
    # no device records (a CPU run, or a --trace 1 run): nothing to read
    assert kernel_ms_per_slot.read(TraceContext(cell=None, window=win, device_name="x")) is None


def test_host_paced_rate_reads_the_untraced_window():
    plain = Window(t0=0.0, calls=[Call(0.0, 1.0, [0, 1]), Call(1.0, 4.0, [2, 3])])
    traced = Window(t0=5.0, calls=[Call(5.0, 5.5, [0, 1])])
    ctx = TraceContext(cell=None, window=traced, device_name="x", host_window=plain)
    assert host_paced.read(ctx) == pytest.approx(4 / 4.0)
    assert host_paced.read(TraceContext(cell=None, window=traced, device_name="x")) is None
