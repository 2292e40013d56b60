"""Plan-time tables of the PyTorch/CUDA port: turn HopConfig/EstimatorConfig into
static index tables and matrices.

A numpy copy of `srsran_ce_tpu/models/plan.py` (tests/test_torch_plan.py holds
every array of the two packages' plans bit-identical): the port cannot import
the JAX package, whose `__init__` imports `jax`. Every data-dependent branch of
the reference is evaluated here, once, in numpy, from pure configuration; the
estimator then sees only dense arrays, static index tables, static filter and
extrapolation matrices and static loop bounds.

`plan_tensors` (the port's addition) moves a plan's arrays onto a device as
torch tensors. It reads only numpy attributes, so it takes a plan built by
either package.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from ..config import NRE, EstimatorConfig, HopConfig
from ..ops.dsp import make_inpaint_schedule
from ..utils import oracle as _oracle  # numpy filter design reused at plan time


def _virtual_pilot_matrix(n: int, n_virtuals: int) -> np.ndarray:
    """LS extrapolation matrix M (n_virtuals, n): v = M @ y gives the straight-line
    fit of y (modulus or unwrapped phase) evaluated at indices -n_virtuals..-1.

    Encodes the closed-form a/b fit of the reference's createVirtualPilots
    (ce_rule_baseline.py:105-134): a = sum_i c_i y_i with c = (x - mx)/denom,
    b = mean(y) - a*mx, v_j = a*k_j + b  =>  M[j, i] = c_i*(k_j - mx) + 1/n.
    """
    x = np.arange(n, dtype=np.float64)
    mx = x.mean()
    denom = float(np.sum(x * x)) - n * mx * mx
    c = (x - mx) / denom
    k = np.arange(-n_virtuals, 0, dtype=np.float64)
    return c[None, :] * (k[:, None] - mx) + 1.0 / n


@dataclass(eq=False)
class HopPlan:
    """Static per-hop compute plan."""

    hop: HopConfig
    n_layers: int
    n_cdm: int
    n_re: int  # pilot REs per CDM group (== pilots.shape[0])
    n_dsym: int
    dmrs_sym_idx: np.ndarray  # (n_dsym,) int32
    re_idx: np.ndarray  # (n_cdm, n_re) int32 absolute subcarrier index
    n_sc_hop: int
    sc_start: int
    sym_start: int
    n_alloc_syms: int
    layer_slices: Tuple[Tuple[int, int], ...]  # per-CDM (l0, l1) global layer range
    # CFO (static geometry; ce_rule_baseline.py:394-438)
    cfo_possible: bool
    n_samples: float  # nSyms + sum(CPDs) between first two DMRS symbols
    # smoothing (ce_rule_baseline.py:645-680)
    smoothing: str
    rc_taps: Optional[np.ndarray]  # (K,) float64, sum=1
    n_pils: int
    vp_matrix: Optional[np.ndarray]  # (n_pils, n_pils) or None when n_pils fit is n==1
    # grid-fill interp tables per CDM (ce_rule_baseline.py:237-360)
    interp_left: np.ndarray  # (n_cdm, n_sc_hop) int32, ordinals into n_re
    interp_right: np.ndarray
    interp_alpha: np.ndarray  # (n_cdm, n_sc_hop) float64
    # CNN inpainting static schedule per CDM (ce_dl_cnn.py:473-508) — list len n_cdm
    inpaint_schedules: Optional[list]
    inpaint_known: Optional[list]  # (n_sc_hop,) bool per CDM
    # time alignment (ce_rule_baseline.py:684-710)
    ta_scatter_idx: np.ndarray  # (n_re,) int32 positions of LAST CDM group, clipped to fft
    half_cp_len: int
    fft_size: int
    # TPU fast paths (math-identical reformulations picked at plan time):
    # PDP via direct DFT on only the +-half_cp_len bins of interest — one MXU matmul
    # instead of scattering into a (fft_size, nL) buffer and running a full IFFT.
    ta_dft_cos: Optional[np.ndarray] = None  # (n_re_ta, 2*half_cp_len) float64
    ta_dft_sin: Optional[np.ndarray] = None
    # Contiguous-PRB comb geometry: pilot REs selectable by reshape+slice instead of
    # a gather ((sc_base, re_offsets_within_prb) per CDM), None when irregular.
    fast_sel: Optional[Tuple[int, Tuple[Tuple[int, ...], ...]]] = None
    # Linear grid interpolation as a (n_re, n_sc_hop) matrix per CDM (2 nonzeros per
    # column) — one MXU matmul instead of three gathers, which TPUs lower poorly.
    interp_matrix: Optional[np.ndarray] = None  # (n_cdm, n_re, n_sc_hop) float64
    # Wiener/MMSE smoothing (smoothing="wiener", no reference counterpart):
    # plan-time eigendecomposition R = U diag(lam) U^H of the pilot-lattice
    # correlation under an exponential-PDP prior. Runtime applies
    # h_s = U diag(lam/(lam+sigma^2)) U^H h with sigma^2 self-estimated — exact
    # continuous MMSE shrinkage, two matmuls, no filter bank. With >= 2 layers the
    # filter runs on the pair-decimated lattice (pair-averaged values duplicate
    # adjacent entries, whose noise is correlated — the decimated lattice restores
    # a white-noise model) and duplicates back.
    wiener_u: Optional[np.ndarray] = None  # (m, m) complex128 eigenvectors
    wiener_lam: Optional[np.ndarray] = None  # (m,) float64 eigenvalues (>= 0)
    wiener_paired: bool = False
    # Fused smoothing operator (filter mode, XLA tier): CDM pair-average + RC
    # "same" convolution (+ optional cnn_alpha low-pass blend) collapsed into ONE
    # (n_re, n_re) matrix, with small edge matrices for the (nonlinear) virtual
    # pilots:  h_s = h @ smooth_mat + vb @ smooth_vb_mat + flip(ve) @ smooth_ve_mat,
    # where vb/ve are fit from h @ pair_l_mat / flip(h @ pair_r_mat). Replaces the
    # pair-avg reshape/concat chain and K shifted-add conv passes with MXU work.
    smooth_mat: Optional[np.ndarray] = None  # (n_re, n_re) float64
    smooth_vb_mat: Optional[np.ndarray] = None  # (n_pils, n_re)
    smooth_ve_mat: Optional[np.ndarray] = None  # (n_pils, n_re)
    pair_l_mat: Optional[np.ndarray] = None  # (n_re, n_pils)
    pair_r_mat: Optional[np.ndarray] = None  # (n_re, n_pils)
    # WLS CFO estimator (config.cfo_estimator="wls", no reference counterpart):
    # symbol-unit time spans of consecutive DM-RS symbol pairs; None => reference
    # first-pair estimator.
    cfo_pair_dt: Optional[np.ndarray] = None
    # Time interpolation (config.time_interp="linear", no reference counterpart):
    # (n_alloc_syms, n_dsym) weights mapping per-DM-RS-symbol channel profiles to
    # every allocated OFDM symbol — linear in symbol start time between DM-RS
    # symbols, constant extrapolation outside. None => reference broadcast
    # behavior (also when n_dsym < 2, where interpolation degenerates to it).
    time_interp_mat: Optional[np.ndarray] = None


def _time_interp_matrix(
    dmrs_sym_idx: np.ndarray, start_symbol: int, n_alloc_syms: int, config: EstimatorConfig
) -> np.ndarray:
    """(n_alloc_syms, n_dsym) weights: linear interpolation in symbol *start time*
    (CP-aware, same clock as the CFO model — oracle.symbol_start_times) between
    DM-RS symbols, constant extrapolation before the first / after the last."""
    cpds = config.cp_durations_np * config.scs_hz / 1000.0  # symbol units
    sst = _oracle.symbol_start_times(cpds)  # (14,)
    t_d = sst[dmrs_sym_idx].astype(np.float64)  # (n_dsym,)
    syms = np.arange(start_symbol, start_symbol + n_alloc_syms)
    t_s = sst[syms].astype(np.float64)  # (n_alloc,)
    n_dsym = t_d.size
    T = np.zeros((n_alloc_syms, n_dsym), dtype=np.float64)
    right = np.clip(np.searchsorted(t_d, t_s, side="left"), 0, n_dsym - 1)
    left = np.clip(right - 1, 0, n_dsym - 1)
    denom = t_d[right] - t_d[left]
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.where(denom > 0, (t_s - t_d[left]) / np.where(denom > 0, denom, 1.0), 1.0)
    a = np.clip(a, 0.0, 1.0)
    a = np.where(t_s <= t_d[0], 1.0, a)  # all weight on the first DM-RS symbol
    left = np.where(t_s <= t_d[0], 0, left)
    right = np.where(t_s <= t_d[0], 0, right)
    a = np.where(t_s >= t_d[-1], 1.0, a)  # all weight on the last
    left = np.where(t_s >= t_d[-1], n_dsym - 1, left)
    right = np.where(t_s >= t_d[-1], n_dsym - 1, right)
    rows = np.arange(n_alloc_syms)
    np.add.at(T, (rows, left), 1.0 - a)
    np.add.at(T, (rows, right), a)
    return T


def make_hop_plan(hop: HopConfig, config: EstimatorConfig, n_layers: int) -> HopPlan:
    n_cdm = math.ceil(n_layers / 2)
    assert hop.n_cdm >= n_cdm, (
        f"DMRS RE mask has {hop.n_cdm} CDM columns but {n_layers} layers need {n_cdm}"
    )
    re_mask = hop.dmrs_re_mask_np
    prb_mask = hop.prb_mask_np
    sym_mask = hop.dmrs_symbol_mask_np

    dmrs_sym_idx = np.nonzero(sym_mask)[0].astype(np.int32)
    n_dsym = dmrs_sym_idx.size

    re_idx_list = []
    for c in range(n_cdm):
        full_mask = np.kron(prb_mask.astype(np.int64), re_mask[:, c].astype(np.int64)) > 0
        re_idx_list.append(np.nonzero(full_mask)[0].astype(np.int32))
    counts = {len(r) for r in re_idx_list}
    assert len(counts) == 1, "All CDM groups must have the same pilot RE count"
    n_re = counts.pop()
    re_idx = np.stack(re_idx_list)

    n_sc_hop = hop.n_prbs * NRE
    dmrs_per_prb = int(re_mask[:, 0].sum())
    n_prbs_masked = int(prb_mask.sum())

    # CFO geometry
    cfo_possible = n_dsym >= 2
    n_samples = 0.0
    cfo_pair_dt = None
    if cfo_possible:
        cpds = config.cp_durations_np * config.scs_hz / 1000.0  # symbol units
        n_syms = int(dmrs_sym_idx[1] - dmrs_sym_idx[0])
        n_samples = n_syms + float(np.sum(cpds[dmrs_sym_idx[0] + 1 : dmrs_sym_idx[1] + 1]))
        if config.cfo_estimator == "wls":
            cfo_pair_dt = np.asarray(
                [
                    int(dmrs_sym_idx[j + 1] - dmrs_sym_idx[j])
                    + float(np.sum(cpds[dmrs_sym_idx[j] + 1 : dmrs_sym_idx[j + 1] + 1]))
                    for j in range(n_dsym - 1)
                ],
                dtype=np.float64,
            )

    # Smoothing filter design (static; ce_rule_baseline.py:649-659)
    rc_taps = None
    n_pils = 0
    vp_matrix = None
    smooth_mat = smooth_vb_mat = smooth_ve_mat = pair_l_mat = pair_r_mat = None
    if config.smoothing == "filter":
        stride = NRE // dmrs_per_prb
        rc_taps, _ = _oracle.get_rc_filter(stride, min(3, n_prbs_masked))
        n_pils = min(12, rc_taps.size // 2) if n_prbs_masked > 1 else dmrs_per_prb
        if n_pils > 1:
            vp_matrix = _virtual_pilot_matrix(n_pils, n_pils)
        # Fused smoothing pays 2*nL*n_re^2 MXU flops (x3 bf16 passes) to replace
        # ~K*nL*n_re bytes of stencil traffic — a win for the common narrow/medium
        # bands but a measured LOSS at wideband nL=1 (273 PRB: 0.26 -> 0.36
        # ms/batch128), so gate it by pilot count.
        if n_pils <= n_re <= 1024:
            # Fused smoothing operator (see HopPlan docstring above). Banded conv
            # matrix built directly from the taps: 'same' conv response of ext-basis
            # i at center output j' is taps[j' + n_pils + hw - i] (zero outside).
            n_ext = n_re + 2 * n_pils
            K = rc_taps.size
            hw = (K - 1) // 2
            tap_idx = (np.arange(n_re)[None, :] + n_pils + hw) - np.arange(n_ext)[:, None]
            valid = (tap_idx >= 0) & (tap_idx < K)
            b_ext = np.where(valid, rc_taps[np.clip(tap_idx, 0, K - 1)], 0.0)
            if config.cnn_alpha > 0.0 and n_re > 2:
                # ce_dl_cnn.py:712-715 alpha blend with a reflect-padded 3-tap
                # low-pass of the *sliced* output — also linear, fold it in.
                alpha = min(1.0, max(0.0, config.cnn_alpha))
                lp_idx = np.arange(n_re)[None, :] - np.arange(n_re)[:, None] + 1
                lp = np.where(
                    (lp_idx >= 0) & (lp_idx < 3),
                    np.asarray([0.25, 0.5, 0.25])[np.clip(lp_idx, 0, 2)],
                    0.0,
                )
                lp[1, 0] += 0.25  # reflect at the left edge (pad = x[1])
                lp[n_re - 2, n_re - 1] += 0.25  # reflect at the right edge
                b_ext = (1.0 - alpha) * b_ext + alpha * (b_ext @ lp)
            b_h = b_ext[n_pils : n_pils + n_re]
            smooth_vb_mat = b_ext[:n_pils]
            smooth_ve_mat = b_ext[n_pils + n_re :]
            if n_layers >= 2:
                # pair @ b_h without the O(n^3) matmul: rows 2k and 2k+1 both
                # become the average of b_h rows 2k and 2k+1.
                m = n_re // 2
                smooth_mat = b_h.copy()
                avg_rows = 0.5 * (b_h[0 : 2 * m : 2] + b_h[1 : 2 * m : 2])
                smooth_mat[0 : 2 * m : 2] = avg_rows
                smooth_mat[1 : 2 * m : 2] = avg_rows
                pair = np.eye(n_re)
                idx = np.arange(2 * m)
                pair[idx, idx] = 0.5
                pair[idx, idx ^ 1] = 0.5
                pair_l_mat = pair[:, :n_pils]
                pair_r_mat = pair[:, -n_pils:]
            else:
                smooth_mat = b_h
                pair_l_mat = np.eye(n_re)[:, :n_pils]
                pair_r_mat = np.eye(n_re)[:, -n_pils:]

    # Wiener/MMSE smoothing eigen-basis (see HopPlan field docs)
    wiener_u = wiener_lam = None
    wiener_paired = False
    if config.smoothing == "wiener":
        pos = re_idx[0].astype(np.float64)  # absolute subcarrier indices
        # With >=2 layers the pair-average duplicates adjacent REs, so the smoother
        # runs on the pair-decimated lattice — unless n_re is odd (last RE unpaired),
        # where it falls back to the full (duplicated-value) lattice.
        wiener_paired = n_layers >= 2 and n_re % 2 == 0
        if wiener_paired:
            pos = 0.5 * (pos[0::2] + pos[1::2])  # pair-decimated lattice midpoints
        if pos.size < 2:
            # Degenerate lattice: no adjacent differences to estimate noise from and
            # nothing to smooth across — pass-through (estimator mirrors this).
            wiener_paired = False
        else:
            tau = float(config.wiener_delay_spread_s)
            d = (pos[:, None] - pos[None, :]) * config.scs_hz * tau
            r = 1.0 / (1.0 + 2j * np.pi * d)  # exponential-PDP frequency correlation
            lam, u = np.linalg.eigh(r)
            wiener_lam = np.clip(lam, 0.0, None)
            wiener_u = u

    # Interpolation anchor tables per CDM group
    interp_left = np.zeros((n_cdm, n_sc_hop), dtype=np.int32)
    interp_right = np.zeros((n_cdm, n_sc_hop), dtype=np.int32)
    interp_alpha = np.zeros((n_cdm, n_sc_hop), dtype=np.float64)
    inpaint_schedules = None
    inpaint_known = None
    interp_matrix = None
    if config.interp == "cnn":
        inpaint_schedules, inpaint_known = [], []
    for c in range(n_cdm):
        filled = np.nonzero(np.tile(re_mask[:, c], hop.n_prbs))[0]
        assert filled.size == n_re
        pos = np.arange(n_sc_hop)
        # right anchor ordinal: number of filled positions strictly below pos, clipped
        right_ord = np.searchsorted(filled, pos, side="left")
        left_ord = right_ord - 1
        left_ord = np.clip(left_ord, 0, n_re - 1)
        right_ord = np.clip(right_ord, 0, n_re - 1)
        fl = filled[left_ord].astype(np.float64)
        fr = filled[right_ord].astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            alpha = np.where(fr > fl, (pos - fl) / np.where(fr > fl, fr - fl, 1.0), 0.0)
        # Constant extrapolation outside [filled[0], filled[-1]]
        alpha = np.where(pos <= filled[0], 0.0, alpha)
        left_ord = np.where(pos <= filled[0], 0, left_ord)
        right_ord = np.where(pos <= filled[0], 0, right_ord)
        alpha = np.where(pos >= filled[-1], 0.0, alpha)
        left_ord = np.where(pos >= filled[-1], n_re - 1, left_ord)
        right_ord = np.where(pos >= filled[-1], n_re - 1, right_ord)
        interp_left[c] = left_ord
        interp_right[c] = right_ord
        interp_alpha[c] = alpha
        if interp_matrix is None:
            interp_matrix = np.zeros((n_cdm, n_re, n_sc_hop), dtype=np.float64)
        np.add.at(interp_matrix[c], (left_ord, pos), 1.0 - alpha)
        np.add.at(interp_matrix[c], (right_ord, pos), alpha)
        if config.interp == "cnn":
            known = np.zeros(n_sc_hop, dtype=bool)
            known[filled] = True
            n_iters = max(6, n_sc_hop // 8)
            inpaint_schedules.append(make_inpaint_schedule(known, n_iters))
            inpaint_known.append(known)

    # Time-interpolation weights (see HopPlan.time_interp_mat docs)
    time_interp_mat = None
    if config.time_interp == "linear" and n_dsym >= 2:
        time_interp_mat = _time_interp_matrix(
            dmrs_sym_idx, hop.start_symbol, hop.n_allocated_symbols, config
        )

    fft_size = 4096
    half_cp_len = int(math.floor((144 / 2) * fft_size / 2048))
    ta_idx = re_idx[n_cdm - 1]
    ta_idx = ta_idx[ta_idx < fft_size].astype(np.int32)

    # Direct-DFT PDP matrices: ifft bin t of the scattered spectrum is
    # (1/N) * sum_j h[j] * exp(+2i*pi*k_j*t/N); only bins [0, hcl) and [N-hcl, N)
    # feed the argmax, so evaluate exactly those via two real matmuls.
    bins = np.concatenate(
        [np.arange(half_cp_len), fft_size - half_cp_len + np.arange(half_cp_len)]
    )
    theta = 2.0 * np.pi * ta_idx[:, None].astype(np.float64) * bins[None, :] / fft_size
    ta_dft_cos = np.cos(theta) / fft_size
    ta_dft_sin = np.sin(theta) / fft_size

    # Reshape-based pilot selection for contiguous PRB allocations.
    fast_sel = None
    prb_idx = np.nonzero(prb_mask)[0]
    if prb_idx.size > 0 and np.all(np.diff(prb_idx) == 1):
        offsets = tuple(
            tuple(int(p) for p in np.nonzero(re_mask[:, c])[0]) for c in range(n_cdm)
        )
        if len({len(o) for o in offsets}) == 1:
            fast_sel = (int(prb_idx[0]) * NRE, offsets)

    layer_slices = tuple((c * 2, min(n_layers, (c + 1) * 2)) for c in range(n_cdm))

    return HopPlan(
        hop=hop,
        n_layers=n_layers,
        n_cdm=n_cdm,
        n_re=n_re,
        n_dsym=n_dsym,
        dmrs_sym_idx=dmrs_sym_idx,
        re_idx=re_idx,
        n_sc_hop=n_sc_hop,
        sc_start=NRE * hop.prb_start,
        sym_start=hop.start_symbol,
        n_alloc_syms=hop.n_allocated_symbols,
        layer_slices=layer_slices,
        cfo_possible=cfo_possible,
        n_samples=n_samples,
        smoothing=config.smoothing,
        rc_taps=rc_taps,
        n_pils=n_pils,
        vp_matrix=vp_matrix,
        interp_left=interp_left,
        interp_right=interp_right,
        interp_alpha=interp_alpha,
        inpaint_schedules=inpaint_schedules,
        inpaint_known=inpaint_known,
        ta_scatter_idx=ta_idx,
        half_cp_len=half_cp_len,
        fft_size=fft_size,
        ta_dft_cos=ta_dft_cos,
        ta_dft_sin=ta_dft_sin,
        fast_sel=fast_sel,
        interp_matrix=interp_matrix,
        smooth_mat=smooth_mat,
        smooth_vb_mat=smooth_vb_mat,
        smooth_ve_mat=smooth_ve_mat,
        pair_l_mat=pair_l_mat,
        pair_r_mat=pair_r_mat,
        wiener_u=wiener_u,
        wiener_lam=wiener_lam,
        wiener_paired=wiener_paired,
        time_interp_mat=time_interp_mat,
        cfo_pair_dt=cfo_pair_dt,
    )


@dataclass(eq=False)
class EstimatorPlan:
    """Static full-estimator plan: one or two hop plans + normalization constants."""

    config: EstimatorConfig
    n_layers: int
    hop1: HopPlan
    hop2: Optional[HopPlan]
    symbol_start_time: Optional[np.ndarray]  # (14,) float64, set iff cfo_compensate
    cfo_possible: bool  # any hop can estimate CFO
    n_pilots: int
    noise_den: float
    scs_hz: float
    n_dsym1: int  # pilot-symbol split point between the hops (pilots[:, :n_dsym1])

    @property
    def has_hop2(self) -> bool:
        return self.hop2 is not None


@functools.lru_cache(maxsize=256)
def make_plan(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
) -> EstimatorPlan:
    """Build (and cache) the static plan for a (hop1, hop2, config, n_layers) signature.

    All four keys are hashable frozen dataclasses, so identical configurations share
    the plan (and, downstream, the built estimator and its device tensors).
    """
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    p1 = make_hop_plan(hop1, config, n_layers)
    p2 = make_hop_plan(hop2, config, n_layers) if hop2 is not None else None

    if p2 is not None:
        # Reference asserts (ce_rule_baseline.py:869-885): disjoint DMRS symbols,
        # identical RE masks across hops.
        assert not np.any(hop1.dmrs_symbol_mask_np & hop2.dmrs_symbol_mask_np), (
            "Hops should not overlap."
        )
        assert np.array_equal(hop1.dmrs_re_mask_np, hop2.dmrs_re_mask_np), (
            "The DM-RS mask should be the same for the two hops."
        )

    sst = None
    if config.cfo_compensate:
        cpds = config.cp_durations_np * config.scs_hz / 1000.0
        sst = _oracle.symbol_start_times(cpds)

    n_dsym_total = p1.n_dsym + (p2.n_dsym if p2 is not None else 0)
    dmrs_per_prb = int(hop1.dmrs_re_mask_np[:, 0].sum())
    n_pilots = hop1.n_prbs * dmrs_per_prb * n_dsym_total
    noise_den = math.ceil(n_layers / 2) * n_pilots - 1

    return EstimatorPlan(
        config=config,
        n_layers=n_layers,
        hop1=p1,
        hop2=p2,
        symbol_start_time=sst,
        cfo_possible=p1.cfo_possible or (p2 is not None and p2.cfo_possible),
        n_pilots=n_pilots,
        noise_den=float(noise_den),
        scs_hz=config.scs_hz,
        n_dsym1=p1.n_dsym,
    )


def _interp_taps(hp) -> tuple:
    """The linear interpolation operator of a hop as its two taps a column:
    (left, right) int32 and (w_l, w_r) float64, each (n_cdm, n_sc_hop), with
    w_l = interp_matrix[c, left, j] and w_r = interp_matrix[c, right, j], or
    0 where right == left (at the band's edges, where the operator holds the
    two weights summed into one entry). Every other entry of a column is zero,
    so w_l * h[left] + w_r * h[right] sums exactly the operator's nonzero
    terms."""
    left = np.asarray(hp.interp_left, dtype=np.int32)
    right = np.asarray(hp.interp_right, dtype=np.int32)
    c = np.arange(left.shape[0])[:, None]
    j = np.arange(left.shape[1])[None, :]
    w_l = hp.interp_matrix[c, left, j]
    w_r = np.where(right != left, hp.interp_matrix[c, right, j], 0.0)
    return left, right, w_l, w_r


def plan_tensors(plan, device, dtype, k1=None) -> dict:
    """The device tensors the port's estimator consumes, from an `EstimatorPlan`
    of either package (only numpy attributes are read). `k1`: whether the
    caller may launch the fused front (K1), so that its tensors that no other
    tier reads are built; None when K1 takes the plan
    (`estimator._front_pallas_ok`), False for the builders that never launch it
    (the receiver, the tracked estimator, an estimator on another tier).

    Returns {"hops": (per-hop dict, ...), "sst": (14,) symbol start times or None}.
    Each hop dict holds (None where the plan has no such array):
      re_idx, dmrs_sym_idx  the pilot-RE gather indices and DM-RS symbol indices;
      interp       the fill operators (n_cdm, n_re, n_sc_hop): the linear
                   interpolation matrices, or with interp="cnn" the exact
                   inpainting operators (`ops.dsp.inpaint_operator`, built on
                   the device);
      taps         with interp="linear" and `k1`, the interpolation matrices'
                   two taps a column (`_interp_taps`): left, right (int32) and
                   w_l, w_r, each (n_cdm, n_sc_hop), which
                   `ops.kernels.front_finish` reads in place of the dense
                   product; else None (no other tier reads them);
      inpaint      with interp="cnn", per CDM group whose chain the fill runs
                   pass by pass (`ops.dsp.INPAINT_CHAIN_MAX_ITERS` or fewer
                   iterations), the known positions' indices and the
                   schedule's tensors (`ops.dsp.inpaint_consts`), else None;
      vp           the virtual-pilot fit matrix (n_pils, n_pils);
      fused        the fused smoothing matrices pair_l, pair_r, smooth,
                   smooth_vb, smooth_ve;
      wiener       (Re U, Im U, lambda) of wiener smoothing;
      ta, ta_idx   the direct-DFT TA matrices (cos, sin), and the scatter
                   indices of the FFT route;
      time_interp_t  the time-interpolation weights, (n_dsym, n_alloc);
      front        the fused front kernel's tensors, for a hop with the
                   direct-DFT TA path that K1 smooths through the fused
                   matrices or, with `k1`, on its banded route
                   (`estimator._front_banded`): the matrices or taps of
                   `models.estimator._front_mats` plus `two_pi_sst_d`, 2*pi
                   times the DM-RS symbols' start times (None without CFO
                   compensation), the array form of the static tuple the TPU
                   kernel bakes in.
    """
    import torch

    from ..ops.dsp import INPAINT_CHAIN_MAX_ITERS, inpaint_consts, inpaint_operator
    from .estimator import _front_banded, _front_mats, _front_pallas_ok

    def real(a):
        return None if a is None else torch.as_tensor(
            np.ascontiguousarray(a), dtype=dtype, device=device
        )

    def index(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64).reshape(-1), device=device)

    sst = plan.symbol_start_time
    k1 = _front_pallas_ok(plan) if k1 is None else k1
    two_tap = plan.config.interp == "linear" and k1
    hops = []
    for hp in (plan.hop1, plan.hop2):
        if hp is None:
            continue
        inpaint = None
        if plan.config.interp == "cnn":
            interp = torch.stack([
                inpaint_operator(known, len(transient) + steady, dtype, device)
                for known, (transient, steady) in zip(hp.inpaint_known, hp.inpaint_schedules)
            ])
            inpaint = [
                (index(np.nonzero(known)[0]), inpaint_consts(known, sched, dtype, device))
                if len(sched[0]) + sched[1] <= INPAINT_CHAIN_MAX_ITERS else None
                for known, sched in zip(hp.inpaint_known, hp.inpaint_schedules)
            ]
        else:
            interp = real(hp.interp_matrix)
        taps = None
        if two_tap:
            left, right, w_l, w_r = _interp_taps(hp)
            taps = dict(left=torch.as_tensor(left, device=device),
                        right=torch.as_tensor(right, device=device), w_l=real(w_l), w_r=real(w_r))
        fused = None
        if hp.smooth_mat is not None:
            fused = dict(pair_l=real(hp.pair_l_mat), pair_r=real(hp.pair_r_mat),
                         smooth=real(hp.smooth_mat), smooth_vb=real(hp.smooth_vb_mat),
                         smooth_ve=real(hp.smooth_ve_mat))
        front = None
        if hp.ta_dft_cos is not None and (fused is not None or (k1 and _front_banded(hp))):
            front = {k: real(v) for k, v in _front_mats(hp).items()}
            front["two_pi_sst_d"] = (
                None if sst is None else real(2.0 * np.pi * sst[hp.dmrs_sym_idx])
            )
        hops.append(
            dict(
                re_idx=index(hp.re_idx),  # (n_cdm * n_re,) group-major
                dmrs_sym_idx=index(hp.dmrs_sym_idx),
                interp=interp,
                taps=taps,
                inpaint=inpaint,
                vp=real(hp.vp_matrix),
                fused=fused,
                wiener=None if hp.wiener_u is None else (
                    real(np.real(hp.wiener_u)), real(np.imag(hp.wiener_u)), real(hp.wiener_lam)
                ),
                ta=None if hp.ta_dft_cos is None else (real(hp.ta_dft_cos), real(hp.ta_dft_sin)),
                ta_idx=index(hp.ta_scatter_idx),
                time_interp_t=None if hp.time_interp_mat is None else real(hp.time_interp_mat.T),
                front=front,
            )
        )
    return dict(hops=tuple(hops), sst=real(sst))
