"""Frozen copy of `srsran_ce_tpu_torch/config.py` (the hop and estimator configuration), taken at adbd83d.

The benchmark makes its inputs and its reference from this copy, never from
the program, so that a later change to the program cannot move the
yardstick. Numpy only, and cut to what the benchmark calls. Edit nothing
here; a new generator is a new file.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

NRE = 12  # subcarriers (resource elements) per physical resource block


def _as_bool_tuple(x) -> Tuple[bool, ...]:
    return tuple(bool(v) for v in np.asarray(x).reshape(-1))


@dataclass(frozen=True)
class HopConfig:
    """One frequency hop of an SRS/PUSCH allocation.

    Equivalent information to reference HopConfig (ce_rule_baseline.py:13-21):
      dmrs_symbol_mask  <-> DMRSsymbols   (n_sym_total,) bool
      dmrs_re_mask      <-> DMRSREmask    flattened (12 * n_cdm,) bool, column-major
      prb_start         <-> PRBstart      0-based
      n_prbs            <-> nPRBs
      prb_mask          <-> maskPRBs      (n_prb_total,) bool
      start_symbol      <-> startSymbol   0-based
      n_allocated_symbols <-> nAllocatedSymbols
    """

    dmrs_symbol_mask: Tuple[bool, ...]
    dmrs_re_mask: Tuple[bool, ...]  # flattened column-major (12, n_cdm)
    n_cdm: int
    prb_start: int
    n_prbs: int
    prb_mask: Tuple[bool, ...]
    start_symbol: int
    n_allocated_symbols: int

    @staticmethod
    def make(
        dmrs_symbol_mask,
        dmrs_re_mask,  # (12, n_cdm) array-like
        prb_start: int,
        n_prbs: int,
        prb_mask,
        start_symbol: int,
        n_allocated_symbols: int,
    ) -> "HopConfig":
        re_mask = np.asarray(dmrs_re_mask, dtype=bool)
        if re_mask.ndim == 1:
            re_mask = re_mask[:, None]
        assert re_mask.shape[0] == NRE, f"DMRS RE mask must have {NRE} rows"
        return HopConfig(
            dmrs_symbol_mask=_as_bool_tuple(dmrs_symbol_mask),
            dmrs_re_mask=tuple(bool(v) for v in re_mask.T.reshape(-1)),
            n_cdm=int(re_mask.shape[1]),
            prb_start=int(prb_start),
            n_prbs=int(n_prbs),
            prb_mask=_as_bool_tuple(prb_mask),
            start_symbol=int(start_symbol),
            n_allocated_symbols=int(n_allocated_symbols),
        )

    # -- numpy views -------------------------------------------------------
    @property
    def dmrs_symbol_mask_np(self) -> np.ndarray:
        return np.asarray(self.dmrs_symbol_mask, dtype=bool)

    @property
    def dmrs_re_mask_np(self) -> np.ndarray:
        """(12, n_cdm) bool."""
        return np.asarray(self.dmrs_re_mask, dtype=bool).reshape(self.n_cdm, NRE).T

    @property
    def prb_mask_np(self) -> np.ndarray:
        return np.asarray(self.prb_mask, dtype=bool)

    @property
    def n_dmrs_symbols(self) -> int:
        return int(self.dmrs_symbol_mask_np.sum())

    @property
    def is_empty(self) -> bool:
        return len(self.dmrs_symbol_mask) == 0 or self.n_dmrs_symbols == 0

    @staticmethod
    def empty() -> "HopConfig":
        return HopConfig(
            dmrs_symbol_mask=(),
            dmrs_re_mask=(),
            n_cdm=0,
            prb_start=0,
            n_prbs=0,
            prb_mask=(),
            start_symbol=0,
            n_allocated_symbols=0,
        )


@dataclass(frozen=True)
class EstimatorConfig:
    """Estimator-wide configuration.

    Mirrors reference EstimatorConfig (ce_rule_baseline.py:24-29) plus the CNN variant's
    duck-typed extras (ce_dl_cnn.py:864-867):
      scs_hz          <-> scs (Hz)
      cp_durations_ms <-> CyclicPrefixDurations (>=14,) ms
      smoothing       <-> Smoothing in {"filter", "mean", "none"} plus "learned"
                          (trainable denoiser, models/denoiser.py — no reference
                          counterpart; the built function takes a params pytree)
      cfo_compensate  <-> CFOCompensate
      cnn_alpha       <-> CNNSmoothingAlpha (0 disables CNN residual blending)
      interp          : "linear" (baseline/tensorized behavior, ce_rule_baseline.py:303-320)
                        or "cnn" (partial-conv inpainting, ce_dl_cnn.py:292-295)
      matmul_precision: f32 matmul passes on TPU (no reference counterpart — torch
                        CPU is always full f32; the port's CUDA kernels run every
                        level as full f32 FMA). "highest" = 6-pass bf16 (bit-true
                        f32, conformance default), "high" = 3-pass (~1e-7 relative,
                        ~2x faster serving), "default" = 1-pass (~4e-3, out of bound)
      smoothing "wiener" (no reference counterpart): per-problem MMSE-optimal
                        linear smoothing under an exponential power-delay-profile
                        prior with rms delay `wiener_delay_spread_s`. Plan-time
                        eigendecomposition of the pilot-lattice correlation; at
                        runtime the noise level is self-estimated from adjacent
                        pilot differences and enters the eigen-gains exactly
                        (continuous, no SNR quantization).
      smoothing "learned2d" (no reference counterpart): trainable 2-D
                        (time x frequency) residual CNN over the per-DM-RS-symbol
                        estimate grid (models/denoiser.PilotDenoiser2D) — learns
                        Doppler tracking the 1-D "learned" smoother cannot.
                        Requires time_interp="linear"; built functions take the
                        params pytree as a trailing argument.
      cfo_estimator (no reference counterpart): "first_pair" = reference behavior
                        (CFO from the inner product of the FIRST two DM-RS symbols
                        only, ce_rule_baseline.py:415-428). "wls" = weighted
                        least-squares phase-slope fit over ALL consecutive DM-RS
                        symbol pairs, weighted by inner-product magnitude — lower
                        CFO variance whenever a hop has > 2 DM-RS symbols. With
                        exactly 2 DM-RS symbols and ONE CDM group it degenerates
                        to the reference estimator exactly; with multiple CDM
                        groups the per-group angles are magnitude-weighted rather
                        than uniformly averaged (a small, deliberate difference).
      time_interp (no reference counterpart): the reference time-averages the
                        DM-RS symbols and broadcasts ONE frequency profile across
                        every allocated OFDM symbol (ce_rule_baseline.py:625,
                        :333-358) — exact only for time-invariant channels.
                        "linear" instead smooths each DM-RS symbol's estimate
                        separately and linearly interpolates (constant-extrapolates
                        at slot edges) between DM-RS symbol times, tracking
                        Doppler / time-varying channels. "none" = reference
                        behavior. Scalar metrics (noise, RSRP, EPRE, TA, CFO) are
                        unchanged — they stay on the time-averaged path.
    """

    scs_hz: float
    cp_durations_ms: Tuple[float, ...]
    smoothing: str = "filter"
    cfo_compensate: bool = True
    interp: str = "linear"
    cnn_alpha: float = 0.0
    matmul_precision: str = "highest"
    wiener_delay_spread_s: float = 2.5e-7
    time_interp: str = "none"
    cfo_estimator: str = "first_pair"

    def __post_init__(self):
        if self.smoothing not in ("filter", "mean", "none", "learned", "wiener", "learned2d"):
            raise ValueError(f"Unknown smoothing strategy {self.smoothing}.")
        if self.smoothing == "learned2d" and self.time_interp != "linear":
            # The 2-D (time x frequency) denoiser operates on per-DM-RS-symbol
            # estimates, which only exist on the time-interp path.
            raise ValueError("smoothing='learned2d' requires time_interp='linear'.")
        if self.interp not in ("linear", "cnn"):
            raise ValueError(f"Unknown interpolation strategy {self.interp}.")
        if self.time_interp not in ("none", "linear"):
            raise ValueError(f"Unknown time interpolation strategy {self.time_interp}.")
        if self.cfo_estimator not in ("first_pair", "wls"):
            raise ValueError(f"Unknown CFO estimator {self.cfo_estimator}.")
        if self.matmul_precision not in ("default", "high", "highest"):
            raise ValueError(f"Unknown matmul precision {self.matmul_precision}.")
        object.__setattr__(self, "cp_durations_ms", tuple(float(v) for v in self.cp_durations_ms))

    @property
    def cp_durations_np(self) -> np.ndarray:
        return np.asarray(self.cp_durations_ms, dtype=np.float64)


# ---------------------------------------------------------------------------
# Reference-variant presets. The reference ships three near-identical files
# (src/ce_rule_baseline.py, src/ce_rule_tensorized.py, src/ce_dl_cnn.py —
# SURVEY.md §2.1); here they are config presets over ONE shared core
# (SURVEY.md §7 design stance #1).
# ---------------------------------------------------------------------------


def normal_cp_durations_ms(scs_hz: float, n_symbols: int = 14) -> np.ndarray:
    """Normal-cyclic-prefix durations (ms) per OFDM symbol at a given SCS.

    Same model as the reference harness (scripts/validation/validate_all.py:269-283):
    scale the 15 kHz reference CP sample counts (160 for symbol 0, 144 for the rest,
    at FFT 2048) by 15 kHz / SCS (rounded to integer samples), with sample time
    Ts = 1 / (scs * 2048) seconds.
    """
    scale = 15000.0 / scs_hz
    cp0 = float(round(160 * scale))
    cp_rest = float(round(144 * scale))
    cp_samples = np.full(n_symbols, cp_rest, dtype=np.float64)
    cp_samples[0] = cp0
    ts = 1.0 / (scs_hz * 2048.0)  # seconds per sample
    return cp_samples * ts * 1000.0


def make_config(
    scs_hz: float,
    smoothing: str = "filter",
    cfo_compensate: bool = True,
    interp: str = "linear",
    cnn_alpha: float = 0.0,
    n_symbols: int = 14,
    matmul_precision: str = "highest",
    wiener_delay_spread_s: float = 2.5e-7,
    time_interp: str = "none",
    cfo_estimator: str = "first_pair",
) -> EstimatorConfig:
    return EstimatorConfig(
        scs_hz=float(scs_hz),
        cp_durations_ms=tuple(normal_cp_durations_ms(scs_hz, n_symbols)),
        smoothing=smoothing,
        cfo_compensate=cfo_compensate,
        interp=interp,
        cnn_alpha=float(cnn_alpha),
        matmul_precision=matmul_precision,
        wiener_delay_spread_s=float(wiener_delay_spread_s),
        time_interp=time_interp,
        cfo_estimator=cfo_estimator,
    )
