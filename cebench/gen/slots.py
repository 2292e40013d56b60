"""The cell-slots a deployment's traffic carries, made from `--seed` by the
frozen generators of this package (numpy only).

A PUSCH slot (`pusch_slot`) is one UE's uplink transmission as the PHY hands
it over: TS 38.212 transport blocks (CRC24B per code block, fillers, LDPC,
§5.4.2 rate matching, scrambled with the configuration's RNTI and data scrambling
identity), Gray-QAM mapped, sent with DM-RS type 1 through an independent TDL
channel to each receive antenna, with a CFO and noise. An estimation slot
(`ce_slot`) is one UE's DM-RS received on each of the radio's antennas, one
estimation problem an antenna. The grids are complex64, as a PHY front end
hands them over; the reference reads the same values.

Slot i of a pool is drawn from `slot_seed(seed, i)`; every seed gives slots of
the same sizes, so a seed changes the values and never the work.
"""
from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import ldpc_code, nr_ldpc, sequences, synthetic, transport
from .nrconfig import EstimatorConfig, HopConfig


def slot_seed(seed: int, i: int) -> int:
    return int(seed) + 1_000_003 * int(i)


@dataclass
class Slot:
    rg: np.ndarray  # (n_rx, n_sc, n_sym) complex64
    pilots: np.ndarray  # (n_re, n_dsym, n_layers) complex64
    beta: float
    hop1: HopConfig
    hop2: Optional[HopConfig]
    config: EstimatorConfig
    payload: Optional[np.ndarray] = None  # (c_words, k_pay) uint8 sent (PUSCH only)


def _geometry(cfg: dict) -> dict:
    """make_case's arguments for the configuration's grid and channel."""
    return dict(
        n_prbs=int(cfg["n_prbs"]), n_layers=int(cfg["n_layers"]), comb=int(cfg["comb"]),
        scs_hz=float(cfg["scs_hz"]), n_sym=int(cfg["n_sym"]),
        n_dmrs_syms=int(cfg["n_dmrs_syms"]), dmrs_type=int(cfg["dmrs_type"]),
        pilot_source="dmrs", smoothing=cfg["smoothing"],
        cfo_compensate=bool(cfg["cfo_compensate"]), time_interp=cfg["time_interp"],
        snr_db=float(cfg["assumed"]["snr_db"]), cfo_hz=float(cfg["assumed"]["cfo_hz"]),
        n_taps=int(cfg["assumed"]["tdl_taps"]),
    )


def scramble_c_init(cfg: dict) -> int:
    """TS 38.211 §6.3.1.1 c_init of the configuration's RNTI and n_ID."""
    return sequences.pusch_scrambling_c_init(int(cfg["rnti"]), int(cfg["n_id"]), q=0)


def pusch_code(cfg: dict) -> ldpc_code.QCLdpcCode:
    return nr_ldpc.nr_base_graph(int(cfg["ldpc_bg"]), int(cfg["ldpc_z"]))


def pusch_coding(cfg: dict) -> transport.TransportCoding:
    """The transmitter's coding agreement (the frozen TransportCoding)."""
    return transport.TransportCoding(
        code=pusch_code(cfg), tx_bits=int(cfg["e_bits_per_block"]), crc=cfg["crc"],
        n_filler=int(cfg.get("n_filler", 0)), interleave_seed=int(cfg["interleave_seed"]),
        scramble_c_init=scramble_c_init(cfg),
    )


@functools.lru_cache(maxsize=8)
def _pusch_tx(cfg_key: str):
    """(coding, layout, payload bits a block, bits a symbol) of a PUSCH
    configuration: the same for every slot (the geometry takes no seed)."""
    cfg = json.loads(cfg_key)
    coding = pusch_coding(cfg)
    nbits = {"qpsk": 2, "16qam": 4, "64qam": 6, "256qam": 8}[cfg["modulation"]]
    case = synthetic.make_case(seed=0, **_geometry(cfg))
    n_sc, n_sym = case.received_rg.shape
    lay = transport.layout(coding, case.hop1, case.hop2, n_sc, n_sym, int(cfg["n_layers"]), nbits)
    return coding, lay, transport.payload_bits(coding, lay.k), nbits


def pusch_layout(cfg: dict):
    """The transport layout of the configuration's slots (c_words, k, n, ...)."""
    return _pusch_tx(json.dumps(cfg, sort_keys=True))[1]


def pusch_slot(cfg: dict, seed: int, i: int) -> Slot:
    s = slot_seed(seed, i)
    coding, lay, k_pay, nbits = _pusch_tx(json.dumps(cfg, sort_keys=True))
    rng = np.random.default_rng([s, 1])
    payload = rng.integers(0, 2, (lay.c_words, k_pay), dtype=np.uint8)
    words = transport.crc_attach(payload, cfg["crc"])
    # TS 38.212 5.2.2: the known-zero fillers close each block at K bits
    words = np.concatenate([words, np.zeros((lay.c_words, coding.n_filler), np.uint8)], axis=1)
    bits = transport.place_codewords(lay, ldpc_code.encode(coding.code, words),
                                     int(cfg["n_layers"]), nbits, fill_rng=rng)
    link = synthetic.make_mimo_case(
        seed=s, n_rx=int(cfg["n_rx"]), modulation=cfg["modulation"], scramble=True,
        rnti=int(cfg["rnti"]), n_id=int(cfg["n_id"]), bits=bits, **_geometry(cfg),
    )
    return Slot(rg=link.received_rg.astype(np.complex64), pilots=link.pilots.astype(np.complex64),
                beta=float(link.beta), hop1=link.hop1, hop2=link.hop2, config=link.config,
                payload=payload)


def ce_slot(cfg: dict, seed: int, i: int) -> Slot:
    link = synthetic.make_mimo_case(
        seed=slot_seed(seed, i), n_rx=int(cfg["n_rx"]), modulation=cfg["modulation"],
        scramble=False, **_geometry(cfg),
    )
    return Slot(rg=link.received_rg.astype(np.complex64), pilots=link.pilots.astype(np.complex64),
                beta=float(link.beta), hop1=link.hop1, hop2=link.hop2, config=link.config)
