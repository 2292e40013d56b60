"""The port's conformance path (`srsran_ce_tpu_torch/validation/`) against the
JAX package's.

`selftest --device cpu` replays the twelve-case hermetic suite (written from
the float64 oracle in srsRAN's on-disk format) through the port's vector
pipeline: all twelve within -40 dB, and in fact within -140 dB (float64 end to
end; the suite's pilots and grids are stored as complex64, which bounds it).
`run_case` is held against the JAX runner on the same files: the same best
pilot ordering, NMSE equal to relative 1e-6 (both float64 estimates of
complex64-rounded inputs, scored against a complex64 golden; the NMSE is
~1e-15, so 1e-6 of it is far below either estimate's error).
"""
import numpy as np
import pytest

from srsran_ce_tpu.utils import vectors as jvectors
from srsran_ce_tpu.validation import conformance as jconf
from srsran_ce_tpu_torch.utils import vectors
from srsran_ce_tpu_torch.validation import cli, conformance, synth_vectors


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    d = tmp_path_factory.mktemp("suite")
    header = synth_vectors.generate_suite(d, cli.SELFTEST_SPECS)
    return d, header


def test_selftest_cpu_12_of_12(capsys):
    assert cli.main(["selftest", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "selftest: 12/12 within -40.0 dB (device cpu)" in out
    assert out.count("[PASS]") == 12 and "[FAIL]" not in out


def test_run_suite_is_float64_tight(suite):
    d, header = suite
    report = conformance.run_suite(header, d, device="cpu")
    assert report["n_cases"] == report["n_pass"] == 12
    worst_db = max(10 * np.log10(r["nmse"]) for r in report["results"])
    assert worst_db < -140.0, worst_db


@pytest.mark.parametrize("idx", [2, 6, 10], ids=["two_hops", "two_rx_ports", "dmrs_type2_4l"])
def test_run_case_matches_jax(suite, idx):
    d, header = suite
    case = {c.idx: c for c in vectors.parse_test_header(header)}[idx]
    jcase = {c.idx: c for c in jvectors.parse_test_header(header)}[idx]
    mine = conformance.run_case(case, d, device="cpu")
    ref = jconf.run_case(jcase, d)
    assert mine.passed and ref.passed
    assert (mine.ordering, mine.n_layers) == (ref.ordering, ref.n_layers)
    np.testing.assert_allclose([mine.nmse, mine.rms_err, mine.max_err],
                               [ref.nmse, ref.rms_err, ref.max_err], rtol=1e-6)


def test_hop_grouping_matches_jax(suite):
    _, header = suite
    for case, jcase in zip(vectors.parse_test_header(header), jvectors.parse_test_header(header)):
        mine, ref = conformance._group_hops(case), jconf._group_hops(jcase)
        assert len(mine) == len(ref)
        for hm, hr in zip(mine, ref):
            for a, b in zip(hm, hr):
                np.testing.assert_array_equal(a, b)
            h1 = conformance.build_hop_config(*hm, case.start_symbol, case.n_alloc_syms)
            h2 = jconf.build_hop_config(*hr, jcase.start_symbol, jcase.n_alloc_syms)
            assert repr(h1) == repr(h2)


def test_cli_device_is_explicit(capsys, tmp_path):
    """--device cuda without a CUDA device is an error, not a quiet move to the
    CPU; validate without vectors says they are not shipped."""
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["selftest"])
    assert cli.main(["validate", "--data-dir", str(tmp_path), "--device", "cpu"]) == 2
    assert "not shipped" in capsys.readouterr().err


def test_failed_case_is_recorded(suite, tmp_path):
    """A case whose files are missing is recorded as failed with its message;
    the suite keeps going."""
    d, header = suite
    (tmp_path / header.name).write_text(header.read_text())
    for f in d.glob("*0.dat"):  # case 0 only (case 10's files end in 10.dat)
        if not f.name.endswith("10.dat"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
    report = conformance.run_suite(tmp_path / header.name, tmp_path, case_filter=[0, 1])
    assert report["n_cases"] == 2 and report["n_pass"] == 1
    failed = [r for r in report["results"] if not r["passed"]]
    assert failed[0]["idx"] == 1 and failed[0]["message"]
