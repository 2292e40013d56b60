"""The port's deep fuzz and failure forensics against the JAX package's, on the CPU.

- `deepfuzz.draw_geometry`: the kwargs of 50 draws equal to the JAX draws';
- `check_geometry` for draws 0-3 (106 PRB x 1 layer through 273 PRB x 4
  layers) in float64: ok, NMSE against the oracle below GEOMETRY_NMSE_BOUND
  = 1e-18 (the JAX package's bound; measured ~1e-31), the same kwargs as
  the JAX check;
- `coded_trial` 0-2 (trial 2 decodes on the device path): the exact payload,
  the same configuration as the JAX trial;
- `run_header_fuzz(120)`: all pass; `synth_vectors.generate_fuzz_header` text
  and intent identical to the JAX generator's;
- `conformance.debug_case` on a healthy case and with an injected 0.8∠37°
  gain, held as tests/test_debug_forensics.py holds the JAX one, its report
  equal to JAX's (strings and shapes equal, numbers within relative 1e-9,
  absolute 1e-13 at the rounding floor of a healthy case);
- `run_all` / `cli selftest --deep --device cpu` at small counts: all pass,
  the sharded sweep reported as not run, asking for it raises; the entry
  points default to the card.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_ce_tpu.utils import vectors as jvec
from srsran_ce_tpu.validation import conformance as jconf
from srsran_ce_tpu.validation import deepfuzz as jdf
from srsran_ce_tpu.validation import synth_vectors as jsv
from srsran_ce_tpu_torch.utils import vectors as tvec
from srsran_ce_tpu_torch.validation import cli
from srsran_ce_tpu_torch.validation import conformance as tconf
from srsran_ce_tpu_torch.validation import deepfuzz as tdf
from srsran_ce_tpu_torch.validation import synth_vectors as tsv


def test_draw_geometry_equals_jax():
    for seed in range(50):
        got = tdf.draw_geometry(np.random.default_rng(seed))
        want = jdf.draw_geometry(np.random.default_rng(seed))
        assert got == want and [type(v) for v in got.values()] == [type(v) for v in want.values()]


@pytest.mark.parametrize("draw", range(4))
def test_check_geometry(draw):
    row = tdf.check_geometry(draw, device="cpu")
    assert row["ok"], row
    assert row["nmse"] < tdf.GEOMETRY_NMSE_BOUND == jdf.GEOMETRY_NMSE_BOUND
    want = jdf.draw_geometry(np.random.default_rng(0xCE_F0 + draw))
    assert row["kwargs"] == {k: list(v) if isinstance(v, tuple) else v for k, v in want.items()}


@pytest.mark.parametrize("trial", range(3))
def test_coded_trial(trial):
    row = tdf.coded_trial(trial, device="cpu")
    assert row["ok"], row["config"]
    assert row["config"]["dev"] == (trial == 2)
    assert row["config"] == jdf.coded_trial(trial)["config"]


def test_header_fuzz(tmp_path):
    report = tdf.run_header_fuzz(120, tmp_dir=str(tmp_path))
    assert report["n_pass"] == report["n_cases"] == 120, report["failures"]


def test_generate_fuzz_header_equals_jax():
    got, got_exp = tsv.generate_fuzz_header(np.random.default_rng(20260820), 40)
    want, want_exp = jsv.generate_fuzz_header(np.random.default_rng(20260820), 40)
    assert got == want
    for g, w in zip(got_exp, want_exp):
        assert {k: v for k, v in g.items() if k != "hops"} == {k: v for k, v in w.items() if k != "hops"}
        for (gs, gp, gr), (ws, wp, wr) in zip(g["hops"], w["hops"]):
            assert list(gs) == list(ws) and np.array_equal(gp, wp) and np.array_equal(gr, wr)


def _suite(tmp_path):
    return tsv.generate_suite(tmp_path, [dict(n_prbs=24, n_layers=2, comb=2, scs_hz=30e3)],
                              seed0=7100)


def assert_report_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_report_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_report_equal(g, w)
    elif isinstance(want, float):
        # relative 1e-9; an absolute 1e-13 at the rounding floor of a healthy
        # case (rms ~1e-15, NMSE ~1e-30, a gain angle ~3e-8 degrees)
        assert abs(got - want) <= 1e-9 * max(abs(want), 1e-4), (got, want)
    else:
        assert got == want


@pytest.mark.parametrize("gain", [None, 0.8 * np.exp(1j * np.deg2rad(37.0))])
def test_debug_case_matches_jax(tmp_path, gain):
    header = _suite(tmp_path)
    case = tvec.parse_test_header(header)[0]
    if gain is not None:
        path = tmp_path / f"port_channel_estimator_test_output_ch_est{case.idx}.dat"
        ent = tvec.load_entries(path)
        tvec.write_entries(path, ent["sym"], ent["port"], ent["sc"], ent["value"] * gain)
        assert not tconf.run_case(case, tmp_path, device="cpu").passed
    rep = tconf.debug_case(case, tmp_path, device="cpu")
    best = rep["candidates"][0]
    if gain is None:
        assert best["nmse"] < 1e-9
        assert abs(best["gain_abs"] - 1.0) < 1e-4 and abs(best["gain_deg"]) < 0.1
        assert rep["n_layers"] == 2 and rep["dmrs_coords"][0]["dmrs_symbols"]
    else:
        assert abs(best["gain_abs"] - 0.8) < 1e-3
        assert abs(best["gain_deg"] - 37.0) < 0.1
        assert best["nmse_after_gain"] < 1e-9 < best["nmse"]
    want = jconf.debug_case(jvec.parse_test_header(header)[0], tmp_path)
    assert_report_equal(rep, want)


def test_cli_debug_case(tmp_path, capsys):
    _suite(tmp_path)
    report = tmp_path / "d.json"
    assert cli.main(["validate", "--data-dir", str(tmp_path), "--debug-case", "0", "--device", "cpu",
                     "--report", str(report)]) == 0
    out = capsys.readouterr().out
    assert "case 0: 2 layer(s)" in out and "best gain" in out
    assert json.loads(report.read_text())["candidates"]
    assert cli.main(["validate", "--data-dir", str(tmp_path), "--debug-case", "7",
                     "--device", "cpu"]) == 2


def test_selftest_deep_on_cpu(tmp_path, capsys):
    report = tmp_path / "deep.json"
    assert cli.main(["selftest", "--deep", "--geometry-n", "3", "--coded-n", "3", "--header-n", "20",
                     "--device", "cpu", "--report", str(report)]) == 0
    out = capsys.readouterr().out
    assert "deep selftest: ALL PASS" in out and "sp: not run" in out
    rep = json.loads(report.read_text())
    assert rep["all_pass"] and rep["sp"] == {"ported": False} and rep["float64"]
    assert rep["device"] == "cpu" and rep["geometry"]["nmse_max"] < tdf.GEOMETRY_NMSE_BOUND
    assert [rep[k]["n_cases"] for k in ("geometry", "coded", "header")] == [3, 3, 20]
    with pytest.raises(NotImplementedError, match="queue 1, item 10"):
        cli.main(["selftest", "--deep", "--sp-n", "2", "--device", "cpu"])


def test_fuzz_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _suite(tmp_path)
    case = tvec.parse_test_header(tmp_path / "port_channel_estimator_test_data.h")[0]
    for call in (lambda: tdf.check_geometry(0), lambda: tdf.coded_trial(0),
                 lambda: tdf.run_all(1, 1, 1), lambda: tconf.debug_case(case, tmp_path)):
        with pytest.raises(RuntimeError, match=r"device=cuda: no CUDA device here"):
            call()
    for argv in (["selftest", "--deep"], ["validate", "--data-dir", str(tmp_path), "--debug-case", "0"]):
        with pytest.raises(RuntimeError, match=r"--device cuda: no CUDA device here"):
            cli.main(argv)


def test_sanitizers():
    """utils/debug: `checked` raises naming the first non-finite output field
    (cfo_hz may be NaN), `assert_finite_result` as the JAX function does."""
    from srsran_ce_tpu.utils import debug as jdebug
    from srsran_ce_tpu_torch.models import estimator
    from srsran_ce_tpu_torch.utils import debug, synthetic

    case = synthetic.make_case(seed=3, n_prbs=4, n_layers=1, n_dmrs_syms=1)
    fn = debug.checked(estimator.build_ri(case.hop1, case.hop2, case.config, 1))
    rg = torch.as_tensor(estimator.split_ri(case.received_rg))
    pil = torch.as_tensor(estimator.split_ri(case.pilots))
    res = fn(rg, pil, case.beta)
    assert bool(torch.isnan(res.cfo_hz))  # one DM-RS symbol: no CFO, allowed
    debug.assert_finite_result(res)
    jdebug.assert_finite_result(res)
    bad = torch.full_like(rg, float("inf"))
    with pytest.raises(FloatingPointError, match="non-finite values in channel_est_rg"):
        fn(bad, pil, case.beta)
    # a NaN is the maximum of the TA argmax, as in jnp.argmax
    from srsran_ce_tpu_torch.ops import mathx
    x = torch.tensor([[1.0, float("nan"), 3.0, float("nan")], [1.0, 3.0, 3.0, 2.0]])
    assert mathx.argmax_last(x).tolist() == np.asarray(jnp.argmax(x.numpy(), axis=-1)).tolist() == [1, 1]
    res.rsrp = torch.tensor(float("nan"))
    for check in (debug.assert_finite_result, jdebug.assert_finite_result):
        with pytest.raises(FloatingPointError, match="non-finite values in rsrp"):
            check(res)
