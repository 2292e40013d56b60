"""The port's bench (`srsran_ce_tpu_torch/bench/throughput.py`, `cli bench`)
and scaling bench (`bench/scaling.py`, `cli scaling`) against the JAX
package's bench.py and bench_scaling.py, on the CPU.

Held here: the constants and the row list equal bench.py's (bench.py is
loaded from its file by importlib and never edited); every correctness gate
gives the JAX gate's verdict on a small seeded case of its row, the NMSE of
each within 1e-12 absolute of the JAX gate's (both are float32 estimates
against a float64 reference, ~1e-15..1e-14: the bound is that of a wrong
gate, not of rounding); each row's byte count (the byte floor times the
bandwidth) equals bench.py's; the product count carried from batch 1 and 2
equals the count of a call at the batch; the min-of-K statistics equal
bench.py's SlopeRow.stats; the scaling plan's worlds; `cli bench` and
`cli scaling` raise on this host without a card.
"""
import importlib.util
import pathlib

import pytest
import torch

from srsran_ce_tpu.utils import synthetic as jsyn
from srsran_ce_tpu_torch.bench import scaling as tscaling
from srsran_ce_tpu_torch.bench import throughput as tb
from srsran_ce_tpu_torch.utils import synthetic as tsyn
from srsran_ce_tpu_torch.validation import cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jbench():
    spec = importlib.util.spec_from_file_location("bench_for_port_tests", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_constants_equal_bench_py(jbench):
    assert tb.BENCH_CONFIGS == jbench.BENCH_CONFIGS
    assert (tb.HEADLINE, tb.REPS, tb.REPS_LONGER, tb.TRIALS, tb.K_SLOPES, tb.SPREAD_WARN) == (
        jbench.HEADLINE, jbench.REPS, jbench.REPS_LONGER, jbench.TRIALS, jbench.K_SLOPES,
        jbench.SPREAD_WARN)
    assert set(tb.QUALITY_GATES) == set(jbench.QUALITY_GATES)


C2 = dict(n_prbs=106, n_layers=4, comb=2, scs_hz=30e3)
C3 = dict(n_prbs=273, n_layers=1, comb=2, scs_hz=30e3, interp="cnn")
Q = dict(n_prbs=52, n_layers=2, comb=2, scs_hz=30e3)
#: bench.py's row list, line by line
BENCH_PY_ROWS = [
    # bench.py:597-600, BENCH_CONFIGS (:66-75) with their batch sweeps
    ("c0_baseline_52prb", [dict(kwargs=dict(n_prbs=52, n_layers=1, comb=2, scs_hz=15e3), batch=b)
                           for b in (128, 256)]),
    ("c1_tensorized_52prb", [dict(kwargs=dict(n_prbs=52, n_layers=1, comb=2, scs_hz=30e3),
                                  batch=b) for b in (64, 256)]),
    ("c2_mmse_4port_106prb", [dict(kwargs=C2, batch=b) for b in (128, 256)]),
    ("c3_cnn_273prb", [dict(kwargs=C3, batch=b) for b in (64, 128)]),
    ("c4_hopped_24prb", [dict(kwargs=dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3,
                                          two_hops=True), batch=b) for b in (256, 4096)]),
    # bench.py:605-613
    ("c2_mmse_4port_106prb_factored", [dict(kwargs=C2, batch=b, out_layout="factored")
                                       for b in (128, 256)]),
    ("c3_cnn_273prb_factored", [dict(kwargs=C3, batch=b, out_layout="factored")
                                for b in (64, 128)]),
    # bench.py:614-625
    ("c2_receiver_4rx4l", [dict(kwargs=C2, batch=b, n_rx=4) for b in (64, 128)]),
    ("c2_receiver_4rx4l_llr256", [dict(kwargs=C2, batch=b, n_rx=4, modulation="256qam")
                                  for b in (64, 128)]),
    # bench.py:629-632, :637-640
    ("c2_mmse_4port_106prb_pallas", [dict(kwargs=C2, batch=128, kernels="pallas")]),
    ("c2_mmse_4port_106prb_pallas_front", [dict(kwargs=C2, batch=128, kernels="pallas_front")]),
    # bench.py:645-672
    ("q_base_52prb_2l", [dict(kwargs=Q, batch=128)]),
    ("q_wiener_52prb_2l", [dict(kwargs=dict(Q, smoothing="wiener"), batch=128)]),
    ("q_time_interp_52prb_2l", [dict(kwargs=dict(Q, time_interp="linear", doppler_hz=300.0),
                                     batch=128)]),
    ("q_tracked_52prb_2l", [dict(kwargs=Q, batch=128, tracked=True)]),
    ("q_learned2d_52prb", [dict(kwargs=dict(Q, smoothing="learned2d", time_interp="linear",
                                            doppler_hz=300.0), batch=128, params="P2D")]),
]


def test_row_specs_equal_bench_py():
    assert tb.row_specs("P2D") == BENCH_PY_ROWS
    # the decode rows: bench.py:876-880 and :966-969
    assert tb.NR_ROWS == (("nr_bg2_z208", 2, 208, 16, 128, True), ("nr_bg1_z52", 1, 52, 16, 128, True),
                          ("nr_bg1_z384", 1, 384, 16, 32, False))
    assert tb.STREAM_ROWS == (("nr_bg1_z384_streamed", 384, 8, 128),
                              ("nr_bg1_z240_streamed", 240, 8, 128))


def _cases(kw, seed=1234):
    return (jsyn.make_case(seed=seed, snr_db=30.0, **kw),
            tsyn.make_case(seed=seed, snr_db=30.0, **kw))


SMALL_Q = dict(n_prbs=8, n_layers=2, comb=2, scs_hz=30e3)
GATE_CASES = {
    "q_base_52prb_2l": SMALL_Q,
    "q_wiener_52prb_2l": dict(SMALL_Q, smoothing="wiener"),
    "q_time_interp_52prb_2l": dict(SMALL_Q, time_interp="linear", doppler_hz=300.0),
    "q_tracked_52prb_2l": SMALL_Q,
    "q_learned2d_52prb": dict(SMALL_Q, smoothing="learned2d", time_interp="linear",
                              doppler_hz=300.0),
}


@pytest.mark.parametrize("name", sorted(GATE_CASES))
def test_quality_gate_gives_the_jax_verdict(jbench, name):
    from srsran_ce_tpu_torch.models import denoiser

    jcase, tcase = _cases(GATE_CASES[name])
    two_d = name == "q_learned2d_52prb"
    jp = jbench._load_params2d() if two_d else None
    tp = denoiser.load_shipped("2d", device="cpu") if two_d else None
    want = jbench.QUALITY_GATES[name](jcase, 2, jp)  # raises when the JAX gate fails
    got = tb.QUALITY_GATES[name](tcase, 2, tp, CPU)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


@pytest.mark.parametrize("kernels", ["xla", "pallas_front"])
def test_oracle_gates_match_jax(jbench, kernels):
    jcase, tcase = _cases(dict(n_prbs=12, n_layers=4, comb=2, scs_hz=30e3))
    a = jbench._nmse_vs_oracle_serve(jcase, 4, kernels="xla")
    b = tb._nmse_vs_oracle_serve(tcase, 4, CPU, kernels=kernels)
    assert b < 4e-11 and abs(a - b) <= 1e-12
    assert abs(tb._nmse_vs_oracle(tcase, 4, CPU) - jbench._nmse_vs_oracle(jcase, 4)) <= 1e-12


def test_a_failed_gate_raises():
    with pytest.raises(tb.GateFailed):
        tb._gate(False, "x")


BYTE_ROWS = [
    ("c2", dict(kwargs=C2, batch=8)),
    ("c4", dict(kwargs=dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, two_hops=True), batch=8)),
    ("factored_two_hops", dict(kwargs=dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3,
                                           two_hops=True), batch=8, out_layout="factored")),
    ("receiver", dict(kwargs=dict(C2, n_prbs=12), batch=8, n_rx=4)),
    ("llr256", dict(kwargs=dict(C2, n_prbs=12), batch=8, n_rx=4, modulation="256qam")),
    ("tracked", dict(kwargs=dict(Q, n_prbs=12), batch=8, tracked=True)),
]


@pytest.mark.parametrize("label,kw", BYTE_ROWS, ids=[r[0] for r in BYTE_ROWS])
def test_byte_floor_counts_bench_py_bytes(jbench, label, kw):
    _, jmeta = jbench.make_row(label, **kw)
    row, meta = tb.make_row(label, device=CPU, **kw)
    assert meta["grid_res"] == jmeta["grid_res"]
    assert meta["floor_s"] * tb.HBM_BW == pytest.approx(jmeta["floor_s"] * jbench.HBM_BW, rel=1e-12)


def test_product_count_is_linear_in_the_batch():
    from torch.utils.flop_counter import FlopCounterMode

    row, meta = tb.make_row("q", kwargs=dict(Q, n_prbs=8), batch=3, device=CPU)
    body, carry = tb.row_chain(meta["case"], 3, CPU, **meta["opts"])
    body(carry)
    with FlopCounterMode(display=False) as fc:
        body(carry)
    assert tb.product_flops(meta) == fc.get_total_flops() > 0


@pytest.mark.parametrize("slopes", [[3.0e-4, 1e-9, 2.8e-4, 2.5e-5, 3.1e-4], [2.0e-4, 2.2e-4, 1.9e-4],
                                    [2.0e-4, 2.5e-4, 2.1e-4], [1e-9, 1e-9]])
def test_slope_row_stats_equal_bench_py(jbench, slopes):
    jrow = jbench.SlopeRow("t", lambda reps: None, ())
    trow = tb.SlopeRow("t", lambda c: c, torch.zeros(1))
    jrow.slopes = list(slopes)
    trow.slopes = list(slopes)
    assert trow.stats() == jrow.stats()
    assert trow.escalate() and trow.rep_points == jbench.REPS_LONGER[0]


def test_scaling_world_plan_is_bench_scaling_py_sweep():
    """bench_scaling.py's sweep on 8 devices: dp and sp at every size, the
    same total dp batch on one device beside each larger world, the sp
    proxy at ceil(273 / n) PRB, config[4] at 1, 2 and the largest size
    (bench_scaling.py:295-420); on one card only the world of 1."""
    assert tscaling.WORLD_SIZES == (1, 2, 4, 8) and tscaling.PER_DEVICE_BATCH == 16
    plan = tscaling.world_plan([1, 2, 4, 8])
    assert plan[1] == [("dp", 1), ("sp", 1), ("config4", 1), ("dp", 1, 32), ("dp", 1, 64),
                       ("dp", 1, 128), ("narrow", 273, 2), ("narrow", 137, 2), ("narrow", 69, 2),
                       ("narrow", 35, 2)]
    assert plan[2] == [("dp", 2), ("sp", 2), ("config4", 2)]
    assert plan[4] == [("dp", 4), ("sp", 4)]
    assert plan[8] == [("dp", 8), ("sp", 8), ("config4", 8)]
    assert tscaling.world_plan([1]) == {1: [("dp", 1), ("sp", 1), ("config4", 1),
                                            ("narrow", 273, 2)]}
    assert {t[0] for ts in plan.values() for t in ts} == set(tscaling.MEASURES)


@pytest.mark.parametrize("cmd", ["bench", "scaling"])
def test_cli_on_cuda_raises_without_a_card(tmp_path, cmd):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([cmd, "--device", "cuda", "--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()
