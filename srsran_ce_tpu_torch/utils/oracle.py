"""Trusted float64 numpy oracle for the srsRAN port-channel-estimator algorithm chain.

This is a deliberately simple, loop-structured, float64 implementation of the exact
algorithm the reference implements (see SURVEY.md §3.2 and the call trace of
the reference's src/ce_rule_baseline.py:507-953). It exists to serve as the hermetic
correctness anchor for the estimator (here: the PyTorch/CUDA port; a numpy
copy of `srsran_ce_tpu/utils/oracle.py`, which the port cannot import): the srsRAN MATLAB test
vectors are not shipped with the reference (gitignored, SURVEY.md §4), so every CI run
validates the production path against this oracle on synthetic golden cases instead.

Nothing in here is performance-relevant; it must only be *obviously correct* and
numerically maximal-precision (complex128 everywhere).

Algorithm summary (reference parity targets cited per step):
  1. per-CDM pilot RE gather + LS de-spread      ce_rule_baseline.py:583-605
  2. CFO estimate / compensation                 ce_rule_baseline.py:363-463
  3. time average over DMRS symbols              ce_rule_baseline.py:625
  4. CDM interference removal (pair average)     ce_rule_baseline.py:632-640
  5. smoothing: mean / RC-filter+virtual pilots  ce_rule_baseline.py:645-680
     (optional CNN low-pass alpha blend          ce_dl_cnn.py:690-717)
  6. IFFT power-delay-profile time alignment     ce_rule_baseline.py:684-710
  7. RX reconstruction, noise/RSRP/EPRE          ce_rule_baseline.py:713-746
  8. grid fill: linear interp or CNN inpaint     ce_rule_baseline.py:237-360, ce_dl_cnn.py:233-322
  9. normalization + grid-wide CFO rotation      ce_rule_baseline.py:914-951
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..config import NRE, EstimatorConfig, HopConfig

# ---------------------------------------------------------------------------
# DSP primitives
# ---------------------------------------------------------------------------


def unwrap_phase(ph: np.ndarray) -> np.ndarray:
    """1-D phase unwrap, numpy.unwrap convention (reference _unwrap_1d, ce_rule_baseline.py:35-66)."""
    ph = np.asarray(ph, dtype=np.float64)
    if ph.size <= 1:
        return ph.copy()
    dd = np.diff(ph)
    ddmod = np.mod(dd + np.pi, 2.0 * np.pi) - np.pi
    ddmod = np.where((ddmod == -np.pi) & (dd > 0), ddmod + 2.0 * np.pi, ddmod)
    correction = np.where(np.abs(dd) < np.pi, 0.0, ddmod - dd)
    return ph + np.concatenate([[0.0], np.cumsum(correction)])


def create_virtual_pilots(in_pilots: np.ndarray, n_virtuals: int) -> np.ndarray:
    """Linear LS fit of modulus and unwrapped phase vs index; extrapolate at negative
    indices (reference create_virtual_pilots, ce_rule_baseline.py:69-140)."""
    if n_virtuals < 0:
        raise ValueError("n_virtuals must be >= 0")
    if n_virtuals == 0:
        return np.empty(0, dtype=np.complex128)
    p = np.asarray(in_pilots, dtype=np.complex128).reshape(-1)
    n = p.size
    if n == 0:
        raise ValueError("in_pilots must be non-empty")
    if n == 1:
        return np.full(n_virtuals, p[0], dtype=np.complex128)

    x = np.arange(n, dtype=np.float64)
    mx = x.mean()
    normx = float(np.sum(x * x))
    denom = normx - n * mx * mx
    k = np.arange(-n_virtuals, 0, dtype=np.float64)

    y = np.abs(p)
    a = (float(np.sum(x * y)) - n * mx * y.mean()) / denom
    b = y.mean() - a * mx
    amp = a * k + b

    y = unwrap_phase(np.angle(p))
    a = (float(np.sum(x * y)) - n * mx * y.mean()) / denom
    b = y.mean() - a * mx
    ph = a * k + b

    return amp * np.exp(1j * ph)


def rcosdesign_normal(beta: float, span: int, sps: int) -> np.ndarray:
    """'normal' raised-cosine FIR taps, MATLAB rcosdesign(beta, span, sps, 'normal')
    shape (span*sps + 1,) (reference _rcosdesign_normal, ce_rule_baseline.py:143-181)."""
    n = np.arange(-span * sps // 2, span * sps // 2 + 1, dtype=np.float64)
    t = n / float(sps)
    sinc_t = np.where(t == 0, 1.0, np.sin(np.pi * t) / np.where(t == 0, 1.0, np.pi * t))
    denom = 1.0 - (2.0 * beta * t) ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        h = sinc_t * np.cos(np.pi * beta * t) / denom
    if beta > 0:
        t0 = 1.0 / (2.0 * beta)
        tol = (1.0 / sps) * 1e-6
        mask = ~np.isfinite(h) | (np.abs(np.abs(t) - t0) < tol)
        if mask.any():
            h = np.where(mask, (np.pi * beta / 2.0) * math.sin(1.0 / (2.0 * beta)), h)
    return h


def get_rc_filter(stride: int, n_rbs: int) -> Tuple[np.ndarray, np.ndarray]:
    """Raised-cosine smoothing filter subsampled at `stride`, normalized to sum 1,
    plus cumulative-tail correction vector (reference get_rc_filter,
    ce_rule_baseline.py:184-234; the correction output is unused by callers)."""
    if stride <= 0 or n_rbs <= 0:
        raise ValueError("stride and n_rbs must be >= 1")
    ff = rcosdesign_normal(0.2, n_rbs, 10)
    l = ff.size
    half = l // 2
    kmax = (half // stride) * stride
    ks = np.arange(-kmax, kmax + 1, stride, dtype=np.int64)
    rc = ff[ks + (l - 1) // 2].copy()
    rc /= rc.sum()
    tmp = np.cumsum(rc)
    mid0 = math.ceil(tmp.size / 2) - 1
    correction = 1.0 / tmp[mid0 : tmp.size - 1]
    return rc, correction


def conv_same(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """MATLAB conv(x, h, 'same') for complex x, real h (reference
    _conv_same_1d_complex, ce_rule_baseline.py:471-505: zero padding k//2)."""
    x = np.asarray(x, dtype=np.complex128).reshape(-1)
    h = np.asarray(h, dtype=np.float64).reshape(-1)
    if h.size == 0:
        return x.copy()
    assert h.size % 2 == 1, "RC smoothing filter taps are always odd-length"
    full = np.convolve(x, h, mode="full")
    start = (h.size - 1) // 2
    return full[start : start + x.size]


def conv_same_reflect(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Real/complex 'same' conv with reflect padding (reference
    _conv1d_same_real_reflect, ce_dl_cnn.py:433-451; replicate for length-1 input)."""
    x = np.asarray(x).reshape(-1)
    h = np.asarray(h, dtype=np.float64).reshape(-1)
    if h.size == 0:
        return x.copy()
    pad = h.size // 2
    if x.size == 1:
        xp = np.concatenate([np.repeat(x[0], pad), x, np.repeat(x[-1], pad)])
    else:
        left = x[1 : pad + 1][::-1]
        right = x[-pad - 1 : -1][::-1]
        xp = np.concatenate([left, x, right])
    full = np.convolve(xp, h, mode="full")
    start = pad + h.size // 2
    return full[start : start + x.size]


def cnn_lowpass(x: np.ndarray, passes: int = 2) -> np.ndarray:
    """Fixed-weight [0.25, 0.5, 0.25] low-pass, reflect padded (reference
    _cnn_lowpass_1d_complex, ce_dl_cnn.py:454-470)."""
    x = np.asarray(x, dtype=np.complex128).reshape(-1)
    if x.size <= 2:
        return x.copy()
    h = np.array([0.25, 0.5, 0.25])
    y = x
    for _ in range(max(1, int(passes))):
        y = conv_same_reflect(y.real, h) + 1j * conv_same_reflect(y.imag, h)
    return y


def cnn_inpaint(x_sparse: np.ndarray, known_mask: np.ndarray, n_iters: int = 8) -> np.ndarray:
    """Partial-convolution iterative inpainting of sparse complex pilots (reference
    _cnn_inpaint_1d_complex, ce_dl_cnn.py:473-508)."""
    x_sparse = np.asarray(x_sparse, dtype=np.complex128).reshape(-1)
    known = np.asarray(known_mask, dtype=bool).reshape(-1)
    if known.all():
        return cnn_lowpass(x_sparse, passes=2)
    x_known = x_sparse.copy()
    x_curr = x_sparse.copy()
    m = known.astype(np.float64)
    h = np.array([0.25, 0.5, 0.25])
    eps = 1e-12
    for _ in range(max(1, int(n_iters))):
        den = conv_same_reflect(m, h)
        num = conv_same_reflect(x_curr.real * m, h) + 1j * conv_same_reflect(x_curr.imag * m, h)
        prop = num / (den + eps)
        m = np.maximum(m, (den > eps).astype(np.float64))
        x_curr = np.where(known, x_known, prop)
    x_lp = cnn_lowpass(x_curr, passes=2)
    return np.where(known, x_known, x_lp)


# ---------------------------------------------------------------------------
# Estimator chain
# ---------------------------------------------------------------------------


@dataclass
class OracleResult:
    channel_est_rg: np.ndarray  # (n_sc, n_sym, n_layers) complex128
    noise_est: float
    rsrp: float
    epre: float
    time_alignment: float
    cfo_hz: Optional[float]


def _compensate_cfo(
    rec_x_pilots: np.ndarray,  # (n_re, n_dsym, n_layers)
    dmrs_sym_idx: np.ndarray,
    scs_khz: float,
    cp_durations_ms: np.ndarray,
    cfo_compensate: bool,
    cfo_estimator: str = "first_pair",
) -> Tuple[np.ndarray, Optional[float]]:
    """Reference compensate_cfo (ce_rule_baseline.py:363-463). scs is in kHz here so
    CP(ms) * scs(kHz) is a dimensionless fraction of the OFDM symbol duration.
    cfo_estimator="wls" (no reference counterpart) fits the phase slope over ALL
    consecutive DM-RS pairs with magnitude weights — mirror of
    models/estimator._process_hop's WLS branch."""
    n_dsym = rec_x_pilots.shape[1]
    if n_dsym < 2:
        return rec_x_pilots, None
    n_layers = rec_x_pilots.shape[2]
    cpds = cp_durations_ms * scs_khz

    if cfo_estimator == "wls":
        num = den = 0.0
        for j in range(n_dsym - 1):
            a, b = int(dmrs_sym_idx[j]), int(dmrs_sym_idx[j + 1])
            dt = (b - a) + float(np.sum(cpds[a + 1 : b + 1]))
            inner = np.array(
                [
                    np.sum(np.conj(rec_x_pilots[:, j, l]) * rec_x_pilots[:, j + 1, l])
                    for l in range(n_layers)
                ]
            )
            for l in range(0, n_layers - 1, 2):
                pair = inner[l] + inner[l + 1]
                num += abs(pair) * dt * float(np.angle(pair))
                den += abs(pair) * dt * dt
            if n_layers % 2 == 1:
                pair = inner[n_layers - 1]
                num += abs(pair) * dt * float(np.angle(pair))
                den += abs(pair) * dt * dt
        cfo = num / (2.0 * np.pi * max(den, 1e-30))
    else:
        n_syms = int(dmrs_sym_idx[1] - dmrs_sym_idx[0])
        inner = np.array(
            [np.sum(np.conj(rec_x_pilots[:, 0, l]) * rec_x_pilots[:, 1, l]) for l in range(n_layers)]
        )
        cfo_acc = 0.0
        for l in range(0, n_layers - 1, 2):
            cfo_acc += float(np.angle(inner[l] + inner[l + 1]))
        if n_layers % 2 == 1:
            cfo_acc += float(np.angle(inner[n_layers - 1]))

        cp_sum = float(np.sum(cpds[dmrs_sym_idx[0] + 1 : dmrs_sym_idx[1] + 1]))
        n_samples = n_syms + cp_sum
        cfo = cfo_acc / (2.0 * np.pi * n_samples) / math.ceil(n_layers / 2)

    if cfo_compensate:
        sst = symbol_start_times(cpds)
        ph = 2.0 * np.pi * sst * cfo
        rot = np.exp(-1j * ph[dmrs_sym_idx])
        rec_x_pilots = rec_x_pilots * rot[None, :, None]
    return rec_x_pilots, cfo


def symbol_start_times(cpds_symbol_units: np.ndarray) -> np.ndarray:
    """cumsum([CPD_0, CPD_1..13 + 1]) — symbol start times in OFDM-symbol units
    assuming a 14-symbol slot (reference ce_rule_baseline.py:441-449, 825-836)."""
    cpds = np.asarray(cpds_symbol_units, dtype=np.float64)
    if cpds.size < 14:
        raise ValueError("cp_durations must have length >= 14")
    vec = np.empty(14)
    vec[0] = cpds[0]
    vec[1:] = cpds[1:14] + 1.0
    return np.cumsum(vec)


def _hop_re_indices(hop: HopConfig, i_cdm: int) -> np.ndarray:
    """Absolute subcarrier indices of this CDM group's pilot REs:
    kron(maskPRBs, DMRSREmask[:, i_cdm]) (reference ce_rule_baseline.py:583-588)."""
    mask = np.kron(hop.prb_mask_np.astype(np.int64), hop.dmrs_re_mask_np[:, i_cdm].astype(np.int64)) > 0
    return np.nonzero(mask)[0], mask


def _interp_full(
    estimated: np.ndarray,  # (n_re, ncols)
    hop: HopConfig,
    i_cdm: int,
    interp: str,
) -> np.ndarray:
    """Per-subcarrier interpolation of pilot-position estimates onto the hop band:
    (n_re, ncols) -> (n_sc_hop, ncols) (reference fill_ch_est_cdm interpolation,
    ce_rule_baseline.py:237-360 / ce_dl_cnn.py:233-322)."""
    ncols = estimated.shape[1]
    n_sc_hop = hop.n_prbs * NRE
    re_mask_col = hop.dmrs_re_mask_np[:, i_cdm]
    mask_all = np.tile(re_mask_col, hop.n_prbs)
    filled = np.nonzero(mask_all)[0]
    if filled.size == 0:
        return np.zeros((n_sc_hop, ncols), dtype=np.complex128)

    full = np.zeros((n_sc_hop, ncols), dtype=np.complex128)
    full[filled, :] = estimated

    if interp == "linear":
        # Linear interp between pilots, constant extrapolation outside.
        for i in range(filled.size - 1):
            a, b = filled[i], filled[i + 1]
            gap = b - a - 1
            if gap <= 0:
                continue
            w = np.arange(1, gap + 1, dtype=np.float64)[:, None] / float(gap + 1)
            full[a + 1 : b, :] = full[a, :][None, :] + w * (full[b, :] - full[a, :])[None, :]
        full[: filled[0] + 1, :] = full[filled[0], :]
        full[filled[-1] :, :] = full[filled[-1], :]
    elif interp == "cnn":
        n_iters = max(6, n_sc_hop // 8)
        for l in range(ncols):
            full[:, l] = cnn_inpaint(full[:, l], mask_all, n_iters=n_iters)
    else:
        raise ValueError(f"Unknown interpolation strategy {interp}.")
    return full


def _fill_ch_est(
    channel: np.ndarray,  # (n_sc, n_sym, n_layers) — mutated
    estimated: np.ndarray,  # (n_re, n_layers_in_cdm)
    hop: HopConfig,
    i_cdm: int,
    interp: str,
) -> None:
    """Grid fill with per-subcarrier interpolation, broadcast over allocated symbols
    (reference fill_ch_est_cdm, ce_rule_baseline.py:237-360 / ce_dl_cnn.py:233-322)."""
    n_layers = estimated.shape[1]
    n_sc_hop = hop.n_prbs * NRE
    full = _interp_full(estimated, hop, i_cdm, interp)
    sc0 = NRE * hop.prb_start
    sym0 = hop.start_symbol
    for l in range(n_layers):
        l_true = l + i_cdm * 2
        channel[sc0 : sc0 + n_sc_hop, sym0 : sym0 + hop.n_allocated_symbols, l_true] = full[:, l][:, None]


def _time_interp_matrix(
    dmrs_sym_idx: np.ndarray, start_symbol: int, n_alloc_syms: int, config: EstimatorConfig
) -> np.ndarray:
    """(n_alloc_syms, n_dsym) time-interpolation weights: linear in symbol start
    time between DM-RS symbols, constant extrapolation outside (independent
    float64 mirror of models/plan._time_interp_matrix)."""
    cpds = config.cp_durations_np * config.scs_hz / 1000.0
    sst = symbol_start_times(cpds)
    t_d = sst[np.asarray(dmrs_sym_idx)].astype(np.float64)
    t_s = sst[start_symbol : start_symbol + n_alloc_syms].astype(np.float64)
    n_dsym = t_d.size
    T = np.zeros((n_alloc_syms, n_dsym), dtype=np.float64)
    for i, t in enumerate(t_s):
        if t <= t_d[0]:
            T[i, 0] = 1.0
        elif t >= t_d[-1]:
            T[i, -1] = 1.0
        else:
            j = int(np.searchsorted(t_d, t, side="left"))
            a = (t - t_d[j - 1]) / (t_d[j] - t_d[j - 1])
            T[i, j - 1] = 1.0 - a
            T[i, j] = a
    return T


def _apply_smoothing(
    h: np.ndarray,  # (n_re, ncols) — mutated and returned
    hop: HopConfig,
    config: EstimatorConfig,
    n_layers: int,
) -> np.ndarray:
    """Frequency smoothing switch on per-column profiles (ce_rule_baseline.py:645-680
    plus the wiener extension). `n_layers` drives the CDM pairing decision, which is
    a property of the layer layout — not of how many profile columns are smoothed."""
    smoothing = config.smoothing
    if smoothing == "mean":
        h = np.ones_like(h) * h.mean(axis=0, keepdims=True)
    elif smoothing == "filter":
        dmrs_per_prb = int(hop.dmrs_re_mask_np[:, 0].sum())
        n_prbs_masked = int(hop.prb_mask_np.sum())
        stride = NRE // dmrs_per_prb
        rc, _ = get_rc_filter(stride, min(3, n_prbs_masked))
        n_pils = min(12, rc.size // 2) if n_prbs_masked > 1 else dmrs_per_prb
        for l in range(h.shape[1]):
            vb = create_virtual_pilots(h[:n_pils, l], n_pils)
            ve = create_virtual_pilots(h[-n_pils:, l][::-1], n_pils)
            x = np.concatenate([vb, h[:, l], ve[::-1]])
            tmp = conv_same(x, rc)
            rc_sm = tmp[n_pils : tmp.size - n_pils]
            if config.cnn_alpha > 0.0:
                alpha = min(1.0, max(0.0, config.cnn_alpha))
                cnn_sm = cnn_lowpass(rc_sm, passes=1)
                rc_sm = rc_sm + alpha * (cnn_sm - rc_sm)
            h[:, l] = rc_sm
    elif smoothing == "wiener":
        # MMSE shrinkage in the eigenbasis of the exponential-PDP prior (same math
        # as models/estimator._smooth_wiener; see EstimatorConfig docstring).
        pos = np.nonzero(
            np.kron(hop.prb_mask_np.astype(np.int64), hop.dmrs_re_mask_np[:, 0].astype(np.int64))
        )[0].astype(np.float64)
        paired = n_layers >= 2 and h.shape[0] % 2 == 0
        hd = h
        if paired:
            pos = 0.5 * (pos[0::2] + pos[1::2])
            hd = h[0::2, :]
        if pos.size >= 2:  # degenerate lattice: pass-through (plan mirrors this)
            dmat = (pos[:, None] - pos[None, :]) * config.scs_hz * float(config.wiener_delay_spread_s)
            r = 1.0 / (1.0 + 2j * np.pi * dmat)
            lam, u = np.linalg.eigh(r)
            lam = np.clip(lam, 0.0, None)
            diff = hd[1:, :] - hd[:-1, :]
            sig2 = max(float(np.mean(np.abs(diff) ** 2)) / 2.0, 1e-20)
            p_hat = max(float(np.mean(np.abs(hd) ** 2)) - sig2, 1e-20)
            g = lam / (lam + sig2 / p_hat)
            hs = u @ (g[:, None] * (u.conj().T @ hd))
            h = np.repeat(hs, 2, axis=0) if paired else hs
    elif smoothing == "none":
        pass
    else:
        raise ValueError(f"Unknown smoothing strategy {smoothing}.")
    return h


def _process_hop(
    hop: HopConfig,
    pilots: np.ndarray,  # (n_re, n_dsym, n_layers)
    received_rg: np.ndarray,  # (n_sc, n_sym)
    config: EstimatorConfig,
    beta: float,
    sst: Optional[np.ndarray],
    state: dict,
) -> None:
    """Reference process_hop (ce_rule_baseline.py:507-755)."""
    n_layers = pilots.shape[2]
    n_cdm = math.ceil(n_layers / 2)
    dmrs_sym_idx = np.nonzero(hop.dmrs_symbol_mask_np)[0]
    n_dsym = dmrs_sym_idx.size
    smoothing = config.smoothing

    received_pilots = np.empty((pilots.shape[0], n_dsym, n_cdm), dtype=np.complex128)
    rec_x_pilots = np.empty_like(pilots)

    mask_res = None
    for c in range(n_cdm):
        re_idx, mask_res = _hop_re_indices(hop, c)
        rx_sel = received_rg[np.ix_(re_idx, dmrs_sym_idx)]
        received_pilots[:, :, c] = rx_sel
        state["epre"] += float(np.sum(np.abs(rx_sel) ** 2))
        l0, l1 = c * 2, min(n_layers, (c + 1) * 2)
        rec_x_pilots[:, :, l0:l1] = rx_sel[:, :, None] * np.conj(pilots[:, :, l0:l1])

    rec_nocfo, cfo_hop = _compensate_cfo(
        rec_x_pilots,
        dmrs_sym_idx,
        config.scs_hz / 1000.0,
        config.cp_durations_np,
        config.cfo_compensate,
        cfo_estimator=config.cfo_estimator,
    )
    if cfo_hop is not None:
        state["cfo"] = cfo_hop if state["cfo"] is None else (state["cfo"] + cfo_hop) / 2.0

    h_p = np.sum(rec_nocfo, axis=1) / beta / n_dsym  # (n_re, n_layers)

    # CDM interference removal: average consecutive RE pairs (ce_rule_baseline.py:632-640).
    if n_layers >= 2:
        m = min(h_p[0::2].shape[0], h_p[1::2].shape[0])
        if m > 0:
            avg = (h_p[0 : 2 * m : 2] + h_p[1 : 2 * m : 2]) / 2.0
            h_p[0 : 2 * m : 2] = avg
            h_p[1 : 2 * m : 2] = avg

    h_p = _apply_smoothing(h_p, hop, config, n_layers)

    # Per-DM-RS-symbol smoothed profiles for time interpolation
    # (config.time_interp="linear" — no reference counterpart; columns pack
    # (layer, dmrs_sym) layer-major, mirroring models/estimator._process_hop).
    h_t = None
    t_mat = None
    if config.time_interp == "linear" and n_dsym >= 2:
        ht = np.transpose(rec_nocfo / beta, (0, 2, 1)).reshape(
            h_p.shape[0], n_layers * n_dsym
        )
        if n_layers >= 2:
            m = min(ht[0::2].shape[0], ht[1::2].shape[0])
            if m > 0:
                avg = (ht[0 : 2 * m : 2] + ht[1 : 2 * m : 2]) / 2.0
                ht[0 : 2 * m : 2] = avg
                ht[1 : 2 * m : 2] = avg
        h_t = _apply_smoothing(ht, hop, config, n_layers)
        t_mat = _time_interp_matrix(
            dmrs_sym_idx, hop.start_symbol, hop.n_allocated_symbols, config
        )

    # Time alignment from the 4096-point IFFT power-delay profile
    # (ce_rule_baseline.py:684-710). NB: scatter positions use the LAST CDM group's
    # RE mask over the full grid — a deliberate reference-scope quirk we preserve.
    fft_size = 4096
    est_sc = np.zeros((mask_res.size, n_layers), dtype=np.complex128)
    est_sc[np.nonzero(mask_res)[0], :] = h_p
    ir = np.fft.ifft(est_sc, n=fft_size, axis=0)
    pdp = np.sum(np.abs(ir) ** 2, axis=1)
    half_cp = int(math.floor((144 / 2) * fft_size / 2048))
    head, tail = pdp[:half_cp], pdp[-half_cp:]
    i_delay = int(np.argmax(head))
    i_adv = int(np.argmax(tail))
    if head[i_delay] >= tail[i_adv]:
        i_max = i_delay
    else:
        i_max = -(half_cp - i_adv)
    state["time_alignment"] += i_max / float(fft_size) / config.scs_hz

    # Reconstruct expected RX pilots, accumulate noise / RSRP, fill grid
    # (ce_rule_baseline.py:713-746).
    estimated_rx = np.zeros_like(received_pilots)
    for c in range(n_cdm):
        l0, l1 = c * 2, min(n_layers, (c + 1) * 2)
        if config.cfo_compensate and cfo_hop is not None:
            ph = np.exp(1j * 2.0 * np.pi * sst[dmrs_sym_idx] * cfo_hop)  # (n_dsym,)
        else:
            ph = np.ones(n_dsym, dtype=np.complex128)
        for l in range(l0, l1):
            estimated_rx[:, :, c] += beta * pilots[:, :, l] * (h_p[:, l][:, None] * ph[None, :])
        if h_t is not None:
            # Time-interpolated fill: interpolate each DM-RS symbol's profile in
            # frequency, then combine across time with the static weight matrix.
            cols = []
            for l in range(l0, l1):
                cols.extend(range(l * n_dsym, (l + 1) * n_dsym))
            full = _interp_full(h_t[:, cols], hop, c, config.interp)
            n_sc_hop = hop.n_prbs * NRE
            full = full.reshape(n_sc_hop, l1 - l0, n_dsym)
            block = np.einsum("snd,td->snt", full, t_mat)
            sc0 = NRE * hop.prb_start
            sym0 = hop.start_symbol
            for l in range(l0, l1):
                state["channel_est_rg"][
                    sc0 : sc0 + n_sc_hop, sym0 : sym0 + hop.n_allocated_symbols, l
                ] = block[:, l - l0, :]
        else:
            _fill_ch_est(state["channel_est_rg"], h_p[:, l0:l1], hop, c, config.interp)

    state["noise_est"] += float(np.sum(np.abs(received_pilots - estimated_rx) ** 2))
    state["rsrp"] += beta**2 * float(np.sum(np.abs(h_p) ** 2)) * n_dsym


def estimate(
    received_rg: np.ndarray,  # (n_sc, n_sym) complex
    pilots: np.ndarray,  # (n_re, n_dsym_total, n_layers) complex
    beta: float,
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
) -> OracleResult:
    """Full estimator (reference srs_channel_estimator, ce_rule_baseline.py:761-953)."""
    received_rg = np.asarray(received_rg, dtype=np.complex128)
    pilots = np.asarray(pilots, dtype=np.complex128)
    n_layers = pilots.shape[2]

    state = {
        "channel_est_rg": np.zeros((received_rg.shape[0], received_rg.shape[1], n_layers), np.complex128),
        "noise_est": 0.0,
        "rsrp": 0.0,
        "epre": 0.0,
        "time_alignment": 0.0,
        "cfo": None,
    }

    sst = None
    if config.cfo_compensate:
        cpds = config.cp_durations_np * config.scs_hz / 1000.0
        sst = symbol_start_times(cpds)

    n1 = hop1.n_dmrs_symbols
    _process_hop(hop1, pilots[:, :n1, :], received_rg, config, beta, sst, state)

    all_dmrs = hop1.dmrs_symbol_mask_np.copy()
    has_hop2 = hop2 is not None and not hop2.is_empty
    if has_hop2:
        h2 = hop2.dmrs_symbol_mask_np
        assert not np.any(all_dmrs & h2), "Hops should not overlap."
        assert np.array_equal(hop1.dmrs_re_mask_np, hop2.dmrs_re_mask_np), (
            "The DM-RS mask should be the same for the two hops."
        )
        all_dmrs = all_dmrs | h2
        _process_hop(hop2, pilots[:, n1:, :], received_rg, config, beta, sst, state)

    n_dmrs_symbols = int(all_dmrs.sum())
    dmrs_per_prb = int(hop1.dmrs_re_mask_np[:, 0].sum())
    n_pilots = hop1.n_prbs * dmrs_per_prb * n_dmrs_symbols

    rsrp = state["rsrp"] / n_pilots / n_layers
    epre = state["epre"] / n_pilots
    noise_est = state["noise_est"] / (math.ceil(n_layers / 2) * n_pilots - 1)
    time_alignment = state["time_alignment"] / (2.0 if has_hop2 else 1.0)

    cfo = state["cfo"]
    channel = state["channel_est_rg"]
    if config.cfo_compensate and cfo is not None:
        rot = np.exp(1j * 2.0 * np.pi * sst * cfo)  # (14,)
        channel = channel * rot[None, :, None]

    cfo_hz = None if cfo is None else cfo * config.scs_hz
    return OracleResult(channel, noise_est, rsrp, epre, time_alignment, cfo_hz)
