"""The SNR tool (cebench/threshold.py): its threshold is the lowest SNR from
which no block of any seed came back wrong, and its count of wrong blocks
reads the program's results against the payload sent, at a small size on the
CPU."""
import pytest

from cebench import spec, threshold


def _row(variant, snr, bad):
    return {"variant": variant, "snr_db": snr, "seed": 1, "bad_blocks": bad}


def test_threshold_is_the_lowest_snr_clean_from_there_up():
    rows = [_row("program", s, b) for s, b in ((9.0, 40), (10.0, 3), (11.0, 0), (12.0, 0))]
    rows += [_row("program", 10.0, 0), _row("rx1", 11.0, 5)]
    assert threshold.threshold(rows, "program") == 11.0
    # a clean point below a wrong one does not count
    rows.append(_row("program", 8.0, 0))
    assert threshold.threshold(rows, "program") == 11.0
    assert threshold.threshold(rows, "rx1") is None
    assert threshold.threshold(rows + [_row("sweeps2", 13.0, 0)], "sweeps2") == 13.0


def test_variant_configuration_changes_only_what_it_names(pusch_cell):
    cfg = pusch_cell.config
    v = threshold.variant_config(cfg, "sweeps4", 13.0)
    assert v["decoder"]["n_iters"] == 4 and v["assumed"]["snr_db"] == 13.0
    assert cfg["decoder"]["n_iters"] == 16 and cfg["assumed"]["snr_db"] != 13.0
    assert threshold.variant_config(cfg, "rx1", 1.0)["decoder"] == cfg["decoder"]
    with pytest.raises(ValueError):
        threshold.variant_config(cfg, "half_batch", 1.0)


@pytest.mark.parametrize("variant,snr,all_bad", [("program", 30.0, False), ("rx1", 30.0, False),
                                                 ("program", -6.0, True)])
def test_bad_blocks_on_the_cpu(pusch_cell, variant, snr, all_bad):
    r = threshold.bad_blocks(pusch_cell, variant, snr, 2**31 + 41, 3, "cpu")
    assert r["slots"] == 3 and r["blocks"] > 0
    assert r["bad_blocks"] == (r["blocks"] if all_bad else 0)
    assert (r["payload_bit_errors"] > 0) == all_bad


def test_the_estimation_cell_kept_for_later_loads_from_its_files():
    from cebench.tests.conftest import BENCHMARK

    cell = spec.load_workload("ce40_closed4")
    assert cell.config["name"] == "ce_n78_40mhz_4port_32ant" and cell.traffic["cells"] == 4
    with pytest.raises(spec.SpecError):
        spec.load_cell("ce40_closed4", BENCHMARK)
    assert callable(spec.load_module("metrics", "estimator_device_ms_per_slot").read)
