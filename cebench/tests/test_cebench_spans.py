"""The readers of the program's spans and counters (cebench/program_spans.py and
the eight `metrics/` files that use it), on made-up totals: the six span
metrics partition the root spans' time, each reader returns None on an
empty window, on totals that are not the window's and on a context without
a window of spans (a `--trace 1` run of `cebench.run`); `spans_window` runs
`run.run_cell` with its program-traced window between the untraced and the
profiled one, the spans on in the last two only, every window judged and
counted; the idle time goes to the innermost span covering it; the clock
check finds the device's time inside the calls."""
import pytest
import torch

from cebench import program_spans, run, spans_window, spec, trace
from cebench.window import Call, Window
from srsran_ce_tpu_torch.utils import spans

READERS = {m: spec.load_module("metrics", m) for m in spans_window.METRICS}


def totals(calls=2, scale=1):
    """A window's made-up totals: per call one root of 1000 ns with its spans."""
    self_ns = {"serving.pack": 400, "serving.h2d": 20, "graphs.replay": 10,
               "serving.fetch_wait": 350, "serving.unpack": 80, "serving.process": 140}
    s = {n: {"count": calls, "total_ns": v * calls, "self_ns": v * calls, "roots": 0}
         for n, v in self_ns.items()}
    s["serving.process"].update(total_ns=1000 * calls, roots=calls)
    return {"spans": s, "counters": {"serving.h2d_bytes": 1_520_068 * 8 * calls * scale,
                                     "graphs.replay_ms": 2.4 * calls}}


def window(calls=2, slots=8):
    return Window(t0=0.0, calls=[Call(float(i), i + 0.5, list(range(slots)))
                                 for i in range(calls)])


def ctx(program, win):
    return spans_window.SpanContext(cell=None, window=win, device_name="x", program=program,
                                    program_window=win)


def test_the_six_partition_the_root_and_the_counters_read_per_slot():
    c = ctx(totals(), window())
    vals = {m: r.read(c) for m, r in READERS.items()}
    six = sum(vals[m] for m in program_spans.SPAN_METRICS)
    assert six == pytest.approx(2 * 1000 * 1e-6 / 16)  # the roots' time a cell-slot
    assert vals["host_ms_per_slot.pack"] == pytest.approx(2 * 400e-6 / 16)
    assert vals["h2d_mb_per_slot"] == pytest.approx(1.520068)
    assert vals["replay_ms_per_slot.events"] == pytest.approx(2 * 2.4 / 16)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_finds_nothing_to_read(metric):
    read = READERS[metric].read
    assert read(ctx(totals(), Window(t0=0.0))) is None  # an empty window
    assert read(ctx(totals(calls=3), window(calls=2))) is None  # totals of other calls
    empty = {"spans": {"serving.process": {"count": 2, "total_ns": 9, "self_ns": 9, "roots": 2}},
             "counters": {}}
    if metric != "host_ms_per_slot.process_self":
        assert read(ctx(empty, window())) is None  # the span or counter never recorded
    # a --trace 1 run's context: no window of spans
    assert read(run.TraceContext(cell=None, window=window(), device_name="x")) is None


class FakeTraffic:
    """A closed loop of `n` calls a window, each one cell-slot."""

    def __init__(self, n=3):
        self.n, self.t = n, 0.0

    def run(self, serve, mix, seconds, n_pool):
        win = Window(t0=self.t)
        for i in range(self.n):
            serve([i])
            win.calls.append(Call(self.t, self.t + 0.1, [i]))
            self.t += 0.1
        return win


def test_the_hook_runs_the_program_window_then_the_profiled_one():
    on = []

    def serve(ids):
        on.append(spans.on())
        with spans.span("serving.process"):
            pass

    def profile(fn):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            return fn(), "timeline"

    traffic, got = FakeTraffic(), []
    hook = spans_window.with_program_window(profile, spans, got)
    assert hook(lambda: traffic.run(serve, {}, 4.0, 4)) == (got[1][1], "timeline")
    assert [g[0] for g in got] == ["program", "profiled"] and on == [True] * 6
    assert not spans.on()
    assert got[0][1].t_close <= got[1][1].t0
    assert (got[0][3], got[1][3]) == (None, "timeline")
    for _, win, program, _, _ in got:
        assert program["spans"]["serving.process"]["roots"] == len(win.calls) == 3


def test_measure_adds_the_window_to_a_trace_run(pusch_cell, monkeypatch):
    """`measure` on the CPU, the card's profiler replaced by an empty timeline."""
    windows = []
    real_run = run.spec.load_module("traffic", pusch_cell.traffic["kind"]).run

    def profile(fn):
        return fn(), trace.Timeline(t0=0.0, t1=1.0)

    def load_module(kind, name, real=spec.load_module):
        mod = real(kind, name)
        if kind == "traffic":
            def counted(*a):
                windows.append((spans.on(), real_run(*a)))
                return windows[-1][1]
            mod.run = counted
        return mod

    monkeypatch.setattr(trace, "profile", profile)
    monkeypatch.setattr(run.spec, "load_module", load_module)
    out = spans_window.measure(pusch_cell, 2**31 + 77, 0.3, device="cpu")
    assert trace.profile is profile  # the hook is taken back
    assert [on for on, _ in windows] == [False, True, True]  # untraced, program, profiled
    assert out["correct"] and out["attempted"] == sum(w.slots for _, w in windows)
    assert out["program"]["calls"] == len(windows[1][1].calls) > 0
    m, row = out["program"]["metrics"], out["program"]
    assert m["h2d_mb_per_slot"] > 0
    # no card: no graph replayed, no event pair; the other five hold the calls' time
    assert m["host_ms_per_slot.replay"] is m["replay_ms_per_slot.events"] is None
    five = sum(m[k] for k in program_spans.SPAN_METRICS if k != "host_ms_per_slot.replay")
    assert five == pytest.approx(row["call_ms_per_slot"], rel=0.2)
    assert "slots_per_s.host_paced" in out["per_layer"]


def timeline():
    t = trace.Timeline(t0=0.0, t1=100.0)
    t.host = [("cebench.window", 0.0, 100.0), ("serving.process", 5.0, 45.0),
              ("serving.pack", 6.0, 15.0), ("serving.h2d", 15.0, 17.0), ("aten::to", 15.5, 16.5),
              ("graphs.replay", 18.0, 20.0), ("serving.fetch_wait", 21.0, 40.0),
              ("serving.unpack", 40.0, 44.0),
              ("serving.process", 50.0, 90.0), ("graphs.replay", 52.0, 53.0)]
    t.device = [("gpu_memcpy", "Memcpy HtoD", 16.0, 18.5), ("kernel", "k", 19.0, 39.0),
                ("kernel", "k", 53.5, 60.0), ("kernel", "k", 89.0, 91.0)]
    return t


def test_idle_time_goes_to_the_innermost_span():
    idle = program_spans.idle_by_span(timeline())
    # gaps [0, 16], [18.5, 19], [39, 53.5], [60, 89], [91, 100]
    assert idle == pytest.approx({
        program_spans.OUTSIDE: 5.0 + 5.0 + 9.0, "serving.process": 1.0 + 1.0 + 2.0 + 0.5 + 29.0,
        "serving.pack": 9.0, "serving.h2d": 1.0, "graphs.replay": 0.5 + 1.0,
        "serving.fetch_wait": 1.0, "serving.unpack": 4.0})
    assert sum(idle.values()) == pytest.approx(100.0 - timeline().busy_us())


def test_clock_check():
    c = program_spans.clock_check(timeline())
    busy = timeline().busy_us()
    assert c["busy_inside_process_pct"] == pytest.approx(100.0 * (busy - 1.0) / busy)
    assert (c["calls"], c["calls_checked"], c["first_kernel_before_replay"]) == (2, 2, 0)
    assert c["least_kernel_after_replay_us"] == pytest.approx(1.0)
    assert c["first_kernel_before_graph_launch"] == c["first_op_before_h2d"] == 0
    early = timeline()
    early.device.append(("kernel", "k", 51.0, 51.5))  # before the second call's replay
    early.host.append(("cudaGraphLaunch", 52.5, 52.8))
    c = program_spans.clock_check(early)
    assert c["first_kernel_before_replay"] == c["first_kernel_before_graph_launch"] == 1
    assert c["least_kernel_after_replay_us"] == pytest.approx(-1.0)
    early.device.append(("gpu_memcpy", "Memcpy HtoD", 14.0, 15.0))  # before its h2d span
    assert program_spans.clock_check(early)["first_op_before_h2d"] == 1
