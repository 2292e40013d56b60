"""Synthetic golden-case generator for hermetic conformance testing.

The reference validates against srsRAN MATLAB test vectors that are *not shipped*
(gitignored `testvector_outputs/`, SURVEY.md §4), so CI here synthesizes physically
plausible cases instead: a TDL-like multipath channel, unit-modulus QPSK pilots with
optional CDM (OCC) structure, receiver noise, and an injected CFO. The float64 numpy
oracle (`srsran_ce_tpu_torch.utils.oracle`) run on these cases is the golden output the
port's estimator must match within tight NMSE bounds.

A numpy copy of `srsran_ce_tpu/utils/synthetic.py` (the port cannot import the JAX
package): `make_case` draws bit-identical cases for every pilot source.
`make_mimo_case` needs `ops/demap.py` and `transport.py`, which are not ported
yet, and raises NotImplementedError.

Case geometry mirrors the shapes exercised by the reference harness
(scripts/validation/validate_all.py:366-571): SCS 15/30 kHz, 1-4 layers, comb-2 /
comb-4 DM-RS RE masks, single or dual frequency hops, 52/106/273-PRB grids.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..config import NRE, EstimatorConfig, HopConfig, make_config


@dataclass
class SyntheticCase:
    received_rg: np.ndarray  # (n_sc, n_sym) complex128
    pilots: np.ndarray  # (n_re, n_dsym_total, n_layers) complex128
    beta: float
    hop1: HopConfig
    hop2: Optional[HopConfig]
    config: EstimatorConfig
    true_channel: np.ndarray  # (n_sc, n_sym, n_layers) complex128 — ground truth
    snr_db: float


def comb_re_mask(comb: int, n_cdm: int = 1) -> np.ndarray:
    """(12, n_cdm) DM-RS RE mask: comb-`comb` pattern, CDM group c offset by c."""
    mask = np.zeros((NRE, n_cdm), dtype=bool)
    for c in range(n_cdm):
        mask[c::comb, c] = True
    return mask


def _tdl_taps(
    rng: np.random.Generator, n_layers: int, n_taps: int, max_delay_frac: float
):
    """Random TDL tap set: (delays, gains), each (n_taps, n_layers), exponential
    power-delay profile with sub-CP delays (in 2048-FFT sample units)."""
    nfft = 2048.0
    delays = rng.uniform(0.0, max_delay_frac * nfft, size=(n_taps, n_layers))
    delays[0, :] = 0.0
    power = np.exp(-delays / (max_delay_frac * nfft / 3.0 + 1e-9))
    power /= power.sum(axis=0, keepdims=True)
    gains = (rng.standard_normal((n_taps, n_layers)) + 1j * rng.standard_normal((n_taps, n_layers)))
    gains *= np.sqrt(power / 2.0)
    return delays, gains


def _tdl_frequency_response(
    rng: np.random.Generator, n_sc: int, n_layers: int, n_taps: int, max_delay_frac: float
) -> np.ndarray:
    """Smooth multipath frequency response: sum of complex taps at sub-CP delays.

    H[k, l] = sum_t g_{t,l} * exp(-2j*pi*k*d_t/nfft), exponential power-delay profile.
    """
    nfft = 2048.0
    delays, gains = _tdl_taps(rng, n_layers, n_taps, max_delay_frac)
    k = np.arange(n_sc, dtype=np.float64)
    # (n_sc, n_taps, n_layers) phase ramps summed over taps
    phase = np.exp(-2j * np.pi * k[:, None, None] * delays[None, :, :] / nfft)
    return np.einsum("ktl,tl->kl", phase, gains)


def _qpsk(rng: np.random.Generator, shape) -> np.ndarray:
    bits = rng.integers(0, 4, size=shape)
    return np.exp(1j * (np.pi / 4.0 + np.pi / 2.0 * bits))


def make_case(
    seed: int = 0,
    n_prbs: int = 52,
    n_layers: int = 1,
    comb: int = 2,
    scs_hz: float = 30e3,
    smoothing: str = "filter",
    cfo_compensate: bool = True,
    interp: str = "linear",
    cnn_alpha: float = 0.0,
    two_hops: bool = False,
    snr_db: float = 30.0,
    cfo_hz: float = 200.0,
    n_dmrs_syms: int = 4,
    n_sym: int = 14,
    prb_start: Optional[int] = None,
    n_prb_total: Optional[int] = None,
    beta: float = 1.0,
    n_taps: int = 6,
    doppler_hz: float = 0.0,
    time_interp: str = "none",
    cfo_estimator: str = "first_pair",
    noise_seed: Optional[int] = None,
    pilot_source: str = "qpsk",
    prb_hole: Optional[Tuple[int, int]] = None,
    dmrs_type: int = 1,
) -> SyntheticCase:
    """Build one synthetic estimation problem plus its ground-truth channel.

    doppler_hz > 0 gives each multipath tap a random Doppler shift in
    [-doppler_hz, doppler_hz] (Jakes-like), making the true channel vary across
    OFDM symbols — the regime config.time_interp="linear" is built for.
    doppler_hz == 0 reproduces the historical time-flat channel bit-for-bit.

    pilot_source selects what the transmitter sends at DM-RS REs:
      "qpsk" (default): random unit-modulus QPSK with OCC-2 layer structure — the
          historical draws, bit-for-bit.
      "dmrs": standard Gold-sequence DM-RS configuration type 1 (TS 38.211
          §6.4.1.1) via ops/sequences.pusch_dmrs_pilots (slot/N_ID derived from
          `seed`).
      "srs": low-PAPR Zadoff-Chu SRS sequences with cyclic-shift port separation
          and group hopping (TS 38.211 §5.2.2 / §6.4.1.4) via ops/sequences.srs_pilots.

    prb_hole = (h0, h1) blanks PRBs [h0, h1) *relative to each hop's band start* —
    a non-contiguous maskPRBs, the reference's `maskPRBs` with interior zeros
    (hop.nPRBs counts only set PRBs, matching the reference's pilot-count and
    normalization semantics — verified black-box in tests/test_reference_parity.py).
    """
    rng = np.random.default_rng(seed)
    n_cdm = math.ceil(n_layers / 2)
    if dmrs_type not in (1, 2):
        raise ValueError(f"dmrs_type must be 1 or 2: {dmrs_type}")
    if dmrs_type == 2:
        # DM-RS configuration type 2 (TS 38.211 §6.4.1.1.3): adjacent-pair clusters,
        # 4 REs/PRB per CDM group; only meaningful with standard pilots, and the
        # comb argument would contradict the clustered pattern.
        if pilot_source != "dmrs":
            raise ValueError("dmrs_type=2 requires pilot_source='dmrs'")
        if comb != 2:
            raise ValueError("dmrs_type=2 fixes the RE pattern; leave comb at 2")
        from ..ops import sequences as _seq

        re_mask = _seq.dmrs_re_mask(2, n_cdm)
    else:
        re_mask = comb_re_mask(comb, n_cdm)
    dmrs_per_prb = int(re_mask[:, 0].sum())
    n_re = n_prbs * dmrs_per_prb

    if n_prb_total is None:
        n_prb_total = n_prbs if not two_hops else 2 * n_prbs + 4
    if prb_start is None:
        prb_start = 0
    n_sc = n_prb_total * NRE

    config = make_config(
        scs_hz,
        smoothing=smoothing,
        cfo_compensate=cfo_compensate,
        interp=interp,
        cnn_alpha=cnn_alpha,
        time_interp=time_interp,
        cfo_estimator=cfo_estimator,
    )

    # Hop symbol allocation
    if two_hops:
        half = n_sym // 2
        sym_idx1 = np.linspace(0, half - 1, n_dmrs_syms // 2 or 1).round().astype(int)
        sym_idx2 = np.linspace(half, n_sym - 1, n_dmrs_syms - (n_dmrs_syms // 2 or 1)).round().astype(int)
        prb_start2 = n_prb_total - n_prbs
        hops = [
            (prb_start, sym_idx1, 0, half),
            (prb_start2, sym_idx2, half, n_sym - half),
        ]
    else:
        sym_idx1 = np.unique(np.linspace(0, n_sym - 1, n_dmrs_syms).round().astype(int))
        hops = [(prb_start, sym_idx1, 0, n_sym)]

    if prb_hole is not None:
        h0, h1 = int(prb_hole[0]), int(prb_hole[1])
        if not (0 < h0 < h1 < n_prbs):
            raise ValueError(f"prb_hole {prb_hole} must be interior to the {n_prbs}-PRB band")
        n_re = (n_prbs - (h1 - h0)) * dmrs_per_prb

    hop_cfgs = []
    for p0, sym_idx, start_sym, n_alloc in hops:
        sym_mask = np.zeros(n_sym, dtype=bool)
        sym_mask[sym_idx] = True
        prb_mask = np.zeros(n_prb_total, dtype=bool)
        prb_mask[p0 : p0 + n_prbs] = True
        if prb_hole is not None:
            prb_mask[p0 + h0 : p0 + h1] = False
        hop_cfgs.append(
            HopConfig.make(
                sym_mask, re_mask, p0, int(prb_mask.sum()), prb_mask, start_sym, n_alloc
            )
        )
    hop1 = hop_cfgs[0]
    hop2 = hop_cfgs[1] if two_hops else None

    # CFO phase ramp per OFDM symbol (normalized CFO = cfo_hz / scs)
    cpds = config.cp_durations_np * scs_hz / 1000.0  # symbol-duration units
    vec = np.empty(14)
    vec[0] = cpds[0]
    vec[1:] = cpds[1:14] + 1.0
    sst = np.cumsum(vec)

    # Ground-truth per-layer channel over the full grid (frequency-smooth; time-flat
    # apart from the CFO phase ramp below unless doppler_hz > 0, where each tap
    # rotates at its own Doppler frequency across OFDM symbols).
    if doppler_hz > 0.0:
        nfft = 2048.0
        delays, gains = _tdl_taps(rng, n_layers, n_taps, max_delay_frac=0.02)
        f_d = rng.uniform(-doppler_hz, doppler_hz, size=delays.shape)  # (n_taps, n_layers)
        k = np.arange(n_sc, dtype=np.float64)
        phase_f = np.exp(-2j * np.pi * k[:, None, None] * delays[None, :, :] / nfft)
        t_sym_s = sst[:n_sym] / scs_hz  # symbol start times in seconds
        phase_t = np.exp(2j * np.pi * t_sym_s[:, None, None] * f_d[None, :, :])
        true_channel = np.einsum("ktl,stl,tl->ksl", phase_f, phase_t, gains)
    else:
        h_freq = _tdl_frequency_response(rng, n_sc, n_layers, n_taps, max_delay_frac=0.02)
        true_channel = np.repeat(h_freq[:, None, :], n_sym, axis=1)  # (n_sc, n_sym, n_layers)
    cfo_norm = cfo_hz / scs_hz
    cfo_rot = np.exp(1j * 2.0 * np.pi * sst * cfo_norm)  # (14,)

    total_dsym = sum(len(h[1]) for h in hops)
    if pilot_source == "qpsk":
        pilots = _qpsk(rng, (n_re, total_dsym, n_layers))
        # OCC-2 structure within each CDM pair so the estimator's adjacent-RE averaging
        # cancels intra-CDM interference (frequency-domain orthogonal cover code).
        occ = np.where(np.arange(n_re) % 2 == 0, 1.0, -1.0)
        for c in range(n_cdm):
            if c * 2 + 1 < n_layers:
                pilots[:, :, c * 2 + 1] = pilots[:, :, c * 2] * occ[:, None]
    elif pilot_source in ("dmrs", "srs"):
        # Standard-compliant sequences (TS 38.211) — both carry the +1/-1
        # intra-CDM alternation the estimator's pair-averaging inverts (DM-RS via
        # the OCC-2 w_f table; SRS via cyclic shifts spaced n_cs_max/2 apart).
        from ..ops import sequences

        slot, n_id = seed % 20, seed % 1008
        per_hop = []
        for hop in hop_cfgs:
            if pilot_source == "dmrs":
                per_hop.append(
                    sequences.pusch_dmrs_pilots(
                        hop, n_layers, slot, n_id, config_type=dmrs_type
                    )
                )
            else:
                per_hop.append(
                    sequences.srs_pilots(hop, n_layers, slot, n_id, hopping="groupHopping")
                )
        pilots = np.concatenate(per_hop, axis=1)
    else:
        raise ValueError(f"unknown pilot_source {pilot_source!r}")

    # Received grid: channel * beta * pilot at DM-RS REs (sum over CDM layers),
    # channel * random QPSK elsewhere, plus AWGN; CFO rotates every symbol.
    noise_std = 10.0 ** (-snr_db / 20.0)
    received = _qpsk(rng, (n_sc, n_sym)) * true_channel[:, :, 0]  # background payload
    dsym_off = 0
    for hop, (p0, sym_idx, _, _) in zip(hop_cfgs, hops):
        for c in range(n_cdm):
            re_mask_full = np.kron(hop.prb_mask_np, hop.dmrs_re_mask_np[:, c])
            re_idx = np.nonzero(re_mask_full)[0]
            l0, l1 = c * 2, min(n_layers, (c + 1) * 2)
            for j, s in enumerate(sym_idx):
                tx = np.zeros(n_re, dtype=np.complex128)
                for l in range(l0, l1):
                    tx += beta * pilots[:, dsym_off + j, l] * true_channel[re_idx, s, l]
                received[re_idx, s] = tx
        dsym_off += len(sym_idx)

    received *= cfo_rot[None, :n_sym]
    # noise_seed: independent receiver-noise realization on an otherwise identical
    # problem (same channel/pilots/payload) — multi-slot tracking tests re-sound
    # the same channel with fresh noise. None preserves historical draws exactly.
    nrng = np.random.default_rng(noise_seed) if noise_seed is not None else rng
    received += noise_std * (
        nrng.standard_normal(received.shape) + 1j * nrng.standard_normal(received.shape)
    ) / np.sqrt(2.0)

    return SyntheticCase(
        received_rg=received,
        pilots=pilots,
        beta=beta,
        hop1=hop1,
        hop2=hop2,
        config=config,
        true_channel=true_channel,
        snr_db=snr_db,
    )


def symbol_cfo_rotation(config: EstimatorConfig, cfo_hz: float, n_sym: int) -> np.ndarray:
    """Per-OFDM-symbol CFO phase rotation exp(j 2π t_sym · cfo), t_sym the
    cumulative symbol start times in symbol-duration units (the reference's
    symbolStartTime, ce_rule_baseline.py:825-836). The effective channel a
    perfect-CSI receiver sees is true_channel * this rotation."""
    cpds = config.cp_durations_np * config.scs_hz / 1000.0
    vec = np.empty(14)
    vec[0] = cpds[0]
    vec[1:] = cpds[1:14] + 1.0
    return np.exp(1j * 2.0 * np.pi * np.cumsum(vec) * (cfo_hz / config.scs_hz))[:n_sym]


def make_mimo_case(*args, **kwargs):
    """MIMO link case (`srsran_ce_tpu.utils.synthetic.make_mimo_case`): needs the
    receiver chain's modulation and scrambling, which the port does not carry
    yet."""
    raise NotImplementedError(
        "make_mimo_case needs ops/demap.py and transport.py (ROADMAP.md queue 1, items 6-7)"
    )


# Canonical benchmark-config geometry (BASELINE.json configs[0..4])
BENCH_CASES = {
    "c0_baseline_52prb": dict(n_prbs=52, n_layers=1, comb=2, scs_hz=15e3),
    "c1_batch64": dict(n_prbs=52, n_layers=1, comb=2, scs_hz=30e3),
    "c2_mmse_4port_106prb": dict(n_prbs=106, n_layers=4, comb=2, scs_hz=30e3),
    "c3_cnn_273prb": dict(n_prbs=273, n_layers=1, comb=2, scs_hz=30e3, interp="cnn"),
    "c4_multihost_hopped": dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, two_hops=True),
}
