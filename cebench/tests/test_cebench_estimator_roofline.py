"""The estimator's roofline share and the D2H counter's reader, on made-up
records: the work of one `ce_n78_40mhz_4port_32ant` problem at its published
widths is the hand count of cebench/roofline_estimator.py's terms; the share
is the window's least time over the union of its kernels; it reads nothing
off the CE chain, where an LDPC kernel ran, where the replays are not the
calls, or on a card without peaks; `d2h_mb_per_slot` reads the counter a
cell-slot."""
import pytest

from cebench import roofline, roofline_estimator, spec, trace
from cebench.run import TraceContext
from cebench.spans_window import SpanContext
from cebench.window import Call, Window

share = spec.load_module("metrics", "estimator_roofline_pct")
d2h = spec.load_module("metrics", "d2h_mb_per_slot")
H100 = "NVIDIA H100 80GB HBM3"


def ce_config():
    return spec.read_json("configs", "ce_n78_40mhz_4port_32ant.json")


def test_work_of_a_problem_at_published_widths():
    cfg = ce_config()
    assert roofline_estimator.smoothing_taps(cfg) == 15
    # 1272 subcarriers, 636 pilot REs a CDM group, 4 DM-RS symbols, 4 layers, 14 symbols
    work = roofline_estimator.problem(cfg)
    assert work.bytes == (8 * 4 * 1272 + 8 * 636 * 4 * 4 + 4
                          + 8 * 4 * 1272 + 8 * 14 + 4 * 5) == 162_952
    r, p, h = 636 * 4 * 2, 636 * 4 * 4, 636 * 4
    assert (r, p, h) == (5088, 10_176, 2544)
    ops = (4 * r + 6 * p + 8 * h + 6 * p + 2 * p + 2 * h + 4 * 15 * h
           + 5 * 4096 * 12 * 4 + 4 * 288 * 4 + 16 * p + 6 * r + 4 * h + 6 * 636 * 4)
    assert work.ops == ops == 1_547_328
    # a UE-slot (32 problems) is bound by its bytes on an H100: ~1.56 us
    t = roofline.least_time_s(32 * 162_952, 32 * 1_547_328, H100)
    assert t == pytest.approx(32 * 162_952 / 3.35e12) and 32 * 1_547_328 / 67e12 < t


def test_other_dmrs_types_are_refused():
    with pytest.raises(ValueError):
        roofline_estimator.problem(dict(ce_config(), dmrs_type=2))


def ce_cell():
    return spec.Cell(name="ce40_closed4", chips=1, config=ce_config(), traffic={}, end_to_end=[],
                     per_layer=[])


def context(cell=None, counters=None, device=H100, calls=2, device_ops=None):
    win = Window(t0=0.0, calls=[Call(float(i), i + 0.5, [0, 1, 2, 3]) for i in range(calls)])
    ops = device_ops if device_ops is not None else [
        ("kernel", "a", 100.0, 300.0), ("kernel", "b", 200.0, 400.0),  # union 300 us
        ("gpu_memcpy", "Memcpy HtoD", 400.0, 900.0),  # a copy: not kernel time
        ("kernel", "c", 950.0, 1100.0),  # 50 us of it inside the window
    ]
    tl = trace.Timeline(t0=0.0, t1=1000.0, device=ops)
    if counters is None:
        counters = {"graphs.replays": calls, "launches.ldpc": 0, "launches.ldpc_stream": 0}
    return TraceContext(cell=cell or ce_cell(), window=win, device_name=device, timeline=tl,
                        counters=counters)


def test_share_is_the_least_time_over_the_kernels_union():
    per_call = 4 * 32 * 162_952 / 3.35e12  # 4 UE-slots of 32 problems, bound by bytes
    assert share.read(context()) == pytest.approx(100.0 * 2 * per_call / 350e-6)


def test_share_reads_nothing_where_it_cannot_tell():
    pusch = spec.Cell(name="p", chips=1, config=dict(ce_config(), chain="pusch_decoded"),
                      traffic={}, end_to_end=[], per_layer=[])
    assert share.read(context(cell=pusch)) is None  # off the CE chain
    assert share.read(context(counters={"graphs.replays": 2, "launches.ldpc_stream": 1})) is None
    assert share.read(context(counters={"graphs.replays": 2, "launches.ldpc": 3})) is None
    assert share.read(context(counters={"graphs.replays": 3})) is None  # replays != calls
    assert share.read(context(counters={})) is None  # no graph counters
    assert share.read(context(device="cpu")) is None  # no peaks for the card
    assert share.read(context(calls=0)) is None
    assert share.read(context(device_ops=[("gpu_memcpy", "Memcpy", 0.0, 10.0)])) is None


def test_d2h_reader_reads_the_counter_a_slot():
    win = Window(t0=0.0, calls=[Call(0.0, 1.0, [0, 1, 2, 3]), Call(1.0, 2.0, [4, 5, 6, 7])])
    program = {"spans": {"serving.process": {"count": 2, "total_ns": 9, "self_ns": 9,
                                             "roots": 2}},
               "counters": {"serving.d2h_bytes": 8 * 1_303_680}}

    def ctx(prog, w=win):
        return SpanContext(cell=None, window=w, device_name="x", program=prog, program_window=w)

    assert d2h.read(ctx(program)) == pytest.approx(1.30368)
    assert d2h.read(ctx(dict(program, counters={}))) is None  # never counted
    assert d2h.read(ctx(program, Window(t0=0.0))) is None  # an empty window
    assert d2h.read(TraceContext(cell=None, window=win, device_name="x")) is None  # no spans
