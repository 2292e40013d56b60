"""The inputs are made from the seed: the same seed gives the same slots, a
different seed other values of the same sizes, and a PUSCH slot's payload is
recovered by the frozen transmitter's own chain read backwards."""
import numpy as np
import pytest

from cebench.gen import slots, transport


@pytest.mark.parametrize("which", ["pusch", "ce"])
def test_same_seed_same_slot_other_seed_same_sizes(which, pusch_cell, ce_cell):
    cell = pusch_cell if which == "pusch" else ce_cell
    cfg = cell.config
    make = slots.pusch_slot if which == "pusch" else slots.ce_slot
    big = 2**31 + 977
    a, b, c = make(cfg, big, 1), make(cfg, big, 1), make(cfg, big + 1, 1)
    assert np.array_equal(a.rg, b.rg) and np.array_equal(a.pilots, b.pilots)
    assert a.rg.shape == c.rg.shape and a.pilots.shape == c.pilots.shape
    assert not np.array_equal(a.rg, c.rg)
    assert a.rg.dtype == np.complex64 and a.rg.shape[0] == cfg["n_rx"]
    assert a.rg.shape[1] == cfg["n_prbs"] * 12 and a.rg.shape[2] == cfg["n_sym"]
    assert not np.array_equal(make(cfg, big, 2).rg, a.rg)
    if which == "pusch":
        assert np.array_equal(a.payload, b.payload) and a.payload.shape == c.payload.shape


def test_pusch_layout_and_coding(pusch_cell):
    cfg = pusch_cell.config
    lay = slots.pusch_layout(cfg)
    coding = slots.pusch_coding(cfg)
    assert lay.tx_bits == cfg["e_bits_per_block"]
    assert lay.c_words == lay.total // lay.tx_bits >= 1
    k_pay = lay.k - cfg["n_filler"] - 24
    assert transport.payload_bits(coding, lay.k) == k_pay
    s = slots.pusch_slot(cfg, 5, 0)
    assert s.payload.shape == (lay.c_words, k_pay)


def test_full_size_pusch_slot_is_what_the_configuration_states():
    from cebench import spec
    from cebench.tests.conftest import BENCHMARK

    cfg = spec.load_cell("pusch100_closed8", BENCHMARK).config
    lay = slots.pusch_layout(cfg)
    # 273 PRB x 12 x 10 data symbols x 6 bits = 196,560 coded bits: 12 blocks of
    # 16,380, the slot filled exactly; K' = 8,224 of K = 8,448 (224 fillers)
    assert lay.total == 196_560 and lay.c_words == 12 and lay.k == 8448
    assert lay.c_words * lay.tx_bits == lay.total
    assert slots.pusch_slot(cfg, 5, 0).payload.shape == (12, 8224 - 24)
