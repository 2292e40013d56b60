"""The comparison that decides `correct`, on the CPU at 24 PRB: the reference
agrees with `serving.process(device="cpu")` on both configurations; the
control (the float64 estimator on TF32-rounded inputs in the program's place)
fails the limits; and a run whose timed path is broken underneath reads
`correct` false, once for each fault these cells can have: an answer altered
where it is produced, and half of a call's problems left out, the rest's
answers standing in for them. (The cells keep no state between steps and run
on one chip, so the other two faults do not apply.)"""
import dataclasses

import numpy as np
import pytest

from cebench import calibrate, run

SEED = 2**31 + 4242


def run_small(cell, seconds=0.3):
    return run.run_cell(cell, SEED, seconds, False, device="cpu", t_start=run.clock(),
                        log=lambda *a, **k: None)


@pytest.mark.parametrize("which", ["pusch", "ce"])
def test_program_agrees_with_the_reference(which, pusch_cell, ce_cell):
    cell = pusch_cell if which == "pusch" else ce_cell
    out = run_small(cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    for k, c in out["checks"].items():
        assert c["value"] <= c["limit"], k
    # a CPU run reads the host's clock; a metric taken from the card needs one
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end
                                   if m["source"] == "host_clock"}


@pytest.mark.parametrize("which", ["pusch", "ce"])
def test_control_fails(which, pusch_cell, ce_cell):
    cell = pusch_cell if which == "pusch" else ce_cell
    got = calibrate.control_numbers(cell, SEED)
    limits = cell.config["limits"]
    assert any(got["numbers"][k] > limits[k] for k in limits)
    assert got["failed"] == got["judged"] > 0


def altered(result):
    """The result with one answer changed where it is produced."""
    if hasattr(result, "info"):
        info = result.info.copy()
        info[0, 0] ^= 1
        return dataclasses.replace(result, info=info)
    prof = result.profiles.copy()
    prof[0, 0, prof.shape[2] // 2] *= 1.01
    return dataclasses.replace(result, profiles=prof)


def half_left_out(results):
    """Half of the problems left out: the first half's answers stand in for
    the rest (a call of one problem returns the same)."""
    h = (len(results) + 1) // 2
    return results[:h] + [results[i % h] for i in range(h, len(results))]


@pytest.mark.parametrize("which", ["pusch", "ce"])
@pytest.mark.parametrize("fault", ["altered", "half_left_out"])
def test_broken_timed_path_reads_not_correct(which, fault, pusch_cell, ce_cell, monkeypatch):
    from srsran_ce_tpu_torch import serving

    cell = pusch_cell if which == "pusch" else ce_cell
    real = serving.process

    def broken(problems, **kw):
        res = real(problems, **kw)
        if fault == "altered":
            return [altered(r) for r in res]
        return half_left_out(res)

    monkeypatch.setattr(serving, "process", broken)
    out = run_small(cell)
    assert not out["correct"] and out["failed"] > 0


def test_scalars_of_a_result_are_judged(pusch_cell, monkeypatch):
    """A measurement scalar a hundredth off fails the scalar limit alone."""
    from srsran_ce_tpu_torch import serving

    real = serving.process

    def off(problems, **kw):
        return [dataclasses.replace(r, rsrp=r.rsrp * 1.01) for r in real(problems, **kw)]

    monkeypatch.setattr(serving, "process", off)
    out = run_small(pusch_cell)
    assert not out["correct"]
    assert out["checks"]["payload_bit_errors"]["value"] == 0
    assert out["checks"]["scalar_rel_err"]["value"] == pytest.approx(0.01, rel=1e-3)
    assert np.isfinite(out["checks"]["scalar_rel_err"]["value"])
