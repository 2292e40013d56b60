"""`serving.process(out="llrs")` on the 2-layer 256QAM uplink against the
benchmark's plain float64 reference of the multi-layer receiver
(`cebench/reference/mimo.py`), on the CPU.

The link is `cebench`'s `pusch_n78_100mhz_4rx_2l256` (4 rx, 2 layers on DM-RS
ports 0-1, CFO 200 Hz, the 6-tap TDL) cut to 12 or 24 PRB and left
unscrambled. The program's int8 LLRs are round(8 LLR) clipped to +-127: every
one short of the clip lies within one step of round(8 x the reference), and
its sign is the reference's wherever the reference is at least one step (1/8)
from zero. The program's SINR is float32 against float64.
"""
import dataclasses

import numpy as np
import pytest

from cebench import spec
from cebench.gen import slots, synthetic
from cebench.reference import mimo
from srsran_ce_tpu_torch import config as pconfig
from srsran_ce_tpu_torch import serving

CONFIG = "pusch_n78_100mhz_4rx_2l256.json"


def link(n_prbs: int, seed: int, snr_db: float):
    cfg = spec.read_json("configs", CONFIG)
    cfg = dict(cfg, n_prbs=n_prbs, assumed=dict(cfg["assumed"], snr_db=snr_db))
    lk = synthetic.make_mimo_case(seed=seed, n_rx=int(cfg["n_rx"]), modulation=cfg["modulation"],
                                  scramble=False, **slots._geometry(cfg))
    slot = slots.Slot(rg=lk.received_rg.astype(np.complex64),
                      pilots=lk.pilots.astype(np.complex64), beta=float(lk.beta), hop1=lk.hop1,
                      hop2=lk.hop2, config=lk.config)
    prob = serving.Problem(slot.rg, slot.pilots, slot.beta,
                           pconfig.HopConfig(**dataclasses.asdict(slot.hop1)), None,
                           pconfig.EstimatorConfig(**dataclasses.asdict(slot.config)))
    assert slot.hop2 is None
    return cfg, slot, prob


@pytest.mark.parametrize("n_prbs,seed,snr_db", [(12, 2**31 + 31, 26.0), (24, 2**31 + 32, 26.0),
                                                (24, 2**31 + 33, 18.0)])
def test_llrs_of_the_two_layer_256qam_link_match_the_plain_reference(n_prbs, seed, snr_db):
    cfg, slot, prob = link(n_prbs, seed, snr_db)
    (got,) = serving.process([prob], out="llrs", modulation=cfg["modulation"],
                             matmul_precision=cfg["matmul_precision"], device="cpu")
    _, sinr, llr = mimo.receive(slot, cfg["modulation"])
    assert got.llr.shape == llr.shape == (12 * n_prbs, 14, 2, 8)
    np.testing.assert_allclose(got.sinr, sinr, rtol=1e-4, atol=1e-6)
    q = got.llr.astype(np.int64)
    want = np.round(8.0 * llr)
    free = np.abs(q) < 127
    assert free.mean() > 0.2  # the comparison sees most bits unclipped
    assert np.abs(q - want)[free].max() <= 1
    sure = np.abs(llr) >= 1.0 / 8.0
    assert np.array_equal(np.sign(q[sure]), np.sign(llr[sure]))


def test_the_reference_levels_are_ts_38_211_gray_256qam():
    """TS 38.211 §5.1.6 on one axis (b0 b2 b4 b6): 0000 is level 5, 0101 is
    9, 0111 the outermost, 15, and 1111 its mirror; neighbouring levels
    differ in one bit; the mean energy is 170 (the 1/sqrt(170) scale)."""
    levels, bits = mimo.pam_axis(4)
    by_bits = {tuple(b): lv for b, lv in zip(bits, levels)}
    assert by_bits[(0, 0, 0, 0)] == 5 and by_bits[(0, 1, 0, 1)] == 9
    assert by_bits[(0, 1, 1, 1)] == 15 and by_bits[(1, 1, 1, 1)] == -15
    order = np.argsort(levels)
    assert np.array_equal(levels[order], np.arange(-15, 16, 2))
    assert all(np.sum(bits[a] != bits[b]) == 1 for a, b in zip(order[:-1], order[1:]))
    assert 2.0 * np.mean(levels ** 2) == 170.0
