"""Estimation-quality evaluation of the port: `srsran_ce_tpu/validation/quality.py`
in torch. Channel NMSE against the synthetic ground truth across SNR,
geometry, Doppler, channel dispersion and soundings; CFO error; uncoded and
coded link BER through the whole receive chain.

Every sweep runs the port's builders on `device` (the card by default; a
device that is not there raises) with the JAX sweep's own arguments, seeds
and scoring. The synthetic cases are complex128, so the estimator sweeps
run in float64 as the JAX package does with x64 on (the denoiser still
computes in float32, as in JAX); the serving sweep takes complex64 problems
and runs in float32, as in JAX.

Used by `python -m srsran_ce_tpu_torch.validation.cli quality`.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from .. import devices
from ..config import NRE
from ..models import estimator
from ..utils import synthetic


def _t(a, device):
    return torch.as_tensor(np.asarray(a), device=device)


def channel_nmse_vs_truth(
    smoothing: str,
    snr_db: float,
    params=None,
    n_cases: int = 12,
    seed0: int = 900,
    device="cuda",
    **case_kwargs,
) -> float:
    """Mean channel NMSE (linear) vs ground truth over `n_cases` synthetic
    problems, on the allocated block only (the estimate is zero outside the
    hop allocation). `params` are the denoiser's, needed by the learned
    smoothings."""
    dev = devices.resolve(device)
    errs = []
    for i in range(n_cases):
        case = synthetic.make_case(seed=seed0 + i, snr_db=snr_db, smoothing=smoothing, **case_kwargs)
        nL = case.pilots.shape[2]
        fn = estimator.build_ri(case.hop1, case.hop2, case.config, nL)
        res = fn(_t(estimator.split_ri(case.received_rg), dev),
                 _t(estimator.split_ri(case.pilots), dev), float(case.beta), params)
        ch = estimator.merge_ri(res.channel_est_rg.cpu().numpy())
        err = den = 0.0
        for hop in [case.hop1] + ([case.hop2] if case.hop2 is not None else []):
            sc = slice(NRE * hop.prb_start, NRE * (hop.prb_start + hop.n_prbs))
            sy = slice(hop.start_symbol, hop.start_symbol + hop.n_allocated_symbols)
            tru = case.true_channel[sc, sy, :]
            err += float(np.sum(np.abs(ch[sc, sy, :] - tru) ** 2))
            den += float(np.sum(np.abs(tru) ** 2))
        errs.append(err / (den + 1e-300))
    return float(np.mean(errs))


def _db(x: float) -> float:
    return 10.0 * math.log10(x + 1e-300)


def geometry_sweep(params, snr_db: float = 0.0, n_prbs_list=(4, 52, 273), n_cases: int = 4,
                   device="cuda", **case_kwargs) -> dict:
    """Learned-vs-filter channel NMSE (dB) across pilot-lattice geometries
    (one fully convolutional checkpoint covers 4 through 273 PRB). Returns
    {n_prbs: {"n_re", "learned_db", "filter_db", "gain_db", "learned_wins"}}."""
    out = {}
    for p in n_prbs_list:
        kw = dict(n_cases=n_cases, n_prbs=int(p), device=device, **case_kwargs)
        l_lin = channel_nmse_vs_truth("learned", snr_db, params=params, **kw)
        f_lin = channel_nmse_vs_truth("filter", snr_db, **kw)
        out[int(p)] = {
            "n_re": int(p) * 6,
            "learned_db": _db(l_lin),
            "filter_db": _db(f_lin),
            "gain_db": 10.0 * (math.log10(f_lin + 1e-300) - math.log10(l_lin + 1e-300)),
            "learned_wins": bool(l_lin <= f_lin),
        }
    return out


def doppler_sweep(
    dopplers_hz: Sequence[float] = (0.0, 100.0, 300.0, 600.0),
    snr_db: float = 30.0,
    n_cases: int = 8,
    params2d=None,
    device="cuda",
    **case_kwargs,
) -> Dict[str, Dict[float, float]]:
    """NMSE (dB) vs ground truth across Doppler for the time strategies: the
    reference's time-averaged broadcast (time_interp="none"), linear time
    interpolation, and with `params2d` the 2-D denoiser (learned2d). CFO
    injection is off: a per-tap Doppler spread is not a common offset."""
    rows = [("none", "filter", None), ("linear", "filter", None)]
    if params2d is not None:
        rows.append(("learned2d", "learned2d", params2d))
    out: Dict[str, Dict[float, float]] = {}
    for label, smoothing, params in rows:
        out[label] = {
            float(dop): _db(channel_nmse_vs_truth(
                smoothing, snr_db, params=params, n_cases=n_cases, device=device,
                doppler_hz=float(dop), time_interp="none" if label == "none" else "linear",
                cfo_hz=0.0, **case_kwargs))
            for dop in dopplers_hz
        }
    return out


def delay_adapt_sweep(
    snr_db: float = 10.0,
    n_cases: int = 6,
    grid: Sequence[float] = (1e-9, 5e-8, 1.25e-7, 2.5e-7, 5e-7, 1e-6),
    device="cuda",
    **case_kwargs,
) -> Dict[str, Dict[str, float]]:
    """Fixed-prior vs auto-matched MMSE prior (serving's wiener_auto_delay),
    NMSE (dB) vs ground truth across channel dispersion classes (the fixed
    prior is the 250 ns default)."""
    from .. import serving

    kw = dict(n_prbs=52, n_layers=1, cfo_hz=0.0)
    kw.update(case_kwargs)
    out: Dict[str, Dict[str, float]] = {}
    for label, taps in (("flat_1tap", 1), ("default_6tap", 6), ("rich_12tap", 12)):
        cases = [synthetic.make_case(seed=940 + i, snr_db=snr_db, smoothing="wiener", n_taps=taps, **kw)
                 for i in range(n_cases)]
        probs = [serving.Problem(c.received_rg.astype(np.complex64), c.pilots.astype(np.complex64),
                                 1.0, c.hop1, c.hop2, c.config) for c in cases]

        def nmse_db(results) -> float:
            err = den = 0.0
            for r, c in zip(results, cases):
                hop = c.hop1
                sc = slice(NRE * hop.prb_start, NRE * (hop.prb_start + hop.n_prbs))
                tru = c.true_channel[sc, :, :]
                err += float(np.sum(np.abs(r.channel_est_rg[sc, :, :] - tru) ** 2))
                den += float(np.sum(np.abs(tru) ** 2))
            return _db(err / den)

        run = lambda **o: serving.process(probs, batch_size=max(4, n_cases), matmul_precision=None,
                                          device=device, **o)
        out[label] = {"fixed_db": nmse_db(run()), "auto_db": nmse_db(run(wiener_auto_delay=tuple(grid)))}
    return out


def tracking_sweep(
    n_slots: int = 8,
    snr_db: float = 0.0,
    n_cases: int = 6,
    smoothing: str = "filter",
    device="cuda",
    **case_kwargs,
) -> Dict[str, float]:
    """Multi-slot tracking gain on a static channel: NMSE (dB) of the
    single-slot estimate vs the tracked estimate after `n_slots` soundings."""
    from ..models import tracking

    dev = devices.resolve(device)
    kw = dict(n_prbs=24, n_layers=1, cfo_hz=0.0, cfo_compensate=False)
    kw.update(case_kwargs)
    single_err = tracked_err = den = 0.0
    for i in range(n_cases):
        cases = [synthetic.make_case(seed=7000 + i, snr_db=snr_db, smoothing=smoothing,
                                     noise_seed=100 * i + s, **kw) for s in range(n_slots)]
        c0 = cases[0]
        nL = c0.pilots.shape[2]
        fn = tracking.build_tracked_ri(c0.hop1, c0.hop2, c0.config, nL, device=dev)
        state = tracking.init_state(c0.hop1, c0.hop2, c0.config, nL, device=dev)
        res = None
        for c in cases:
            res, *state = fn(estimator.split_ri(c.received_rg), estimator.split_ri(c.pilots),
                             float(c.beta), *state)
        single = estimator.estimate(c0.received_rg, c0.pilots, c0.beta, c0.hop1, c0.hop2,
                                    c0.config, device=dev)
        truth = c0.true_channel
        single_err += float(np.sum(np.abs(single.channel_est_rg - truth) ** 2))
        ch = estimator.merge_ri(res.channel_est_rg.cpu().numpy())
        tracked_err += float(np.sum(np.abs(ch - truth) ** 2))
        den += float(np.sum(np.abs(truth) ** 2))
    return {
        "single_slot_db": _db(single_err / den),
        f"tracked_{n_slots}slots_db": _db(tracked_err / den),
    }


def cfo_rmse_sweep(
    snrs_db: Sequence[float] = (0.0, 5.0, 10.0),
    cfo_hz: float = 220.0,
    n_cases: int = 24,
    n_dmrs_syms: int = 4,
    device="cuda",
    **case_kwargs,
) -> Dict[str, Dict[float, float]]:
    """CFO estimation RMS error (Hz) across SNR for the reference's first-pair
    estimator and the WLS phase-slope fit (cfo_estimator="wls")."""
    dev = devices.resolve(device)
    out: Dict[str, Dict[float, float]] = {}
    for mode in ("first_pair", "wls"):
        row = {}
        for snr in snrs_db:
            errs = []
            for i in range(n_cases):
                case = synthetic.make_case(seed=3000 + i, snr_db=float(snr), cfo_hz=cfo_hz,
                                           n_dmrs_syms=n_dmrs_syms, cfo_estimator=mode, **case_kwargs)
                fn = estimator.build_ri(case.hop1, case.hop2, case.config, case.pilots.shape[2])
                res = fn(_t(estimator.split_ri(case.received_rg), dev),
                         _t(estimator.split_ri(case.pilots), dev), float(case.beta))
                errs.append(float(res.cfo_hz) - cfo_hz)
            row[float(snr)] = float(np.sqrt(np.mean(np.square(errs))))
        out[mode] = row
    return out


def sweep(
    snrs_db: Sequence[float] = (0.0, 5.0, 10.0, 20.0),
    smoothings: Sequence[str] = ("filter", "wiener", "learned", "mean", "none"),
    params=None,
    n_cases: int = 12,
    device="cuda",
    **case_kwargs,
) -> Dict[str, Dict[float, float]]:
    """NMSE (dB) table {smoothing: {snr_db: nmse_db}}."""
    return {
        sm: {float(snr): _db(channel_nmse_vs_truth(sm, snr, params=params, n_cases=n_cases,
                                                   device=device, **case_kwargs))
             for snr in snrs_db}
        for sm in smoothings
    }


def _llr_hard_bits(res) -> np.ndarray:
    """(n_sc, n_sym, nL, nbits) uint8 hard decisions of a receiver's int8 planes."""
    llr = np.stack([p.cpu().numpy() for p in res.llr], axis=-1)  # (nL, sym, sc, nbits)
    return (np.transpose(llr, (2, 1, 0, 3)) < 0).astype(np.uint8)


def _perfect_csi_bits(case, nbits):
    """Hard decisions of the perfect-CSI MMSE receiver, float64 numpy: x =
    (H^H H + sI)^-1 H^H y with s = N0 (data beta 1), alpha-unbiased, nearest
    constellation point (the sign pattern of the max-log LLRs)."""
    from ..ops import demap

    n_sym = case.received_rg.shape[-1]
    rot = synthetic.symbol_cfo_rotation(case.config, case.cfo_hz, n_sym)
    h = case.true_channels * rot[None, None, :, None]  # (n_rx, sc, sym, nL)
    nL = h.shape[-1]
    H = np.transpose(h, (1, 2, 0, 3))  # (sc, sym, rx, nL)
    y = np.transpose(case.received_rg, (1, 2, 0))[..., None]  # (sc, sym, rx, 1)
    Hh = np.conj(np.swapaxes(H, -1, -2))
    s = case.noise_var
    inv = np.linalg.inv(Hh @ H + s * np.eye(nL))
    x = (inv @ (Hh @ y))[..., 0]  # (sc, sym, nL)
    d = np.real(np.einsum("...ll->...l", inv))
    sinr = np.maximum(1.0 / np.maximum(d * s, 1e-30) - 1.0, 0.0)
    alpha = sinr / (1.0 + sinr)
    xt = np.where(alpha > 0, x / np.maximum(alpha, 1e-30), 0.0)
    pts = demap.constellation(case.modulation)
    idx = np.argmin(np.abs(xt[..., None] - pts[None, None, None, :]), axis=-1)
    shifts = np.arange(nbits - 1, -1, -1)
    return ((idx[..., None] >> shifts) & 1).astype(np.uint8)  # (sc, sym, nL, nbits)


def ber_sweep(
    snrs_db: Sequence[float] = (0.0, 5.0, 10.0, 15.0, 20.0),
    modulation: str = "16qam",
    n_rx: int = 2,
    n_layers: int = 2,
    n_prbs: int = 24,
    n_cases: int = 4,
    seed0: int = 4200,
    scramble: bool = True,
    device="cuda",
    **case_kwargs,
) -> Dict[float, Dict[str, float]]:
    """Link-level uncoded BER vs SNR through the whole receiver (estimate ->
    joint MMSE -> max-log int8 demap -> descramble) against the perfect-CSI
    MMSE bound on the same realizations, scored on the `data_mask` REs.
    Returns {snr_db: {"ber", "ber_perfect_csi", "n_bits"}}."""
    from ..models import receiver
    from ..ops import demap

    dev = devices.resolve(device)
    nbits = demap.bits_per_symbol(modulation)
    out: Dict[float, Dict[str, float]] = {}
    for snr in snrs_db:
        errs = errs_ideal = total = 0
        for i in range(n_cases):
            case = synthetic.make_mimo_case(seed=seed0 + i, n_rx=n_rx, modulation=modulation,
                                            scramble=scramble, snr_db=float(snr), n_prbs=n_prbs,
                                            n_layers=n_layers, **case_kwargs)
            fn = receiver.build_receiver_ri(case.hop1, case.hop2, case.config, n_layers, n_rx,
                                            modulation=modulation, device=dev)
            dec = _llr_hard_bits(fn(estimator.split_ri(case.received_rg),
                                    estimator.split_ri(case.pilots), float(case.beta)))
            dec_i = _perfect_csi_bits(case, nbits)
            if case.scramble_c is not None:
                dec = dec ^ case.scramble_c
                dec_i = dec_i ^ case.scramble_c
            mask = np.broadcast_to(case.data_mask[:, :, None, None], case.bits.shape)
            errs += int(np.sum((dec != case.bits) & mask))
            errs_ideal += int(np.sum((dec_i != case.bits) & mask))
            total += int(mask.sum())
        out[float(snr)] = {"ber": errs / total, "ber_perfect_csi": errs_ideal / total,
                           "n_bits": total}
    return out


def coded_ber_sweep(
    snrs_db: Sequence[float] = (8.0, 10.0, 12.0),
    modulation: str = "16qam",
    n_rx: int = 2,
    n_layers: int = 2,
    n_prbs: int = 24,
    n_cases: int = 2,
    seed0: int = 5100,
    code=None,
    n_iters: int = 25,
    scramble: bool = True,
    device="cuda",
    **case_kwargs,
) -> Dict[float, Dict[str, float]]:
    """Coded link-level evaluation: LDPC codewords through the whole uplink
    (encode -> scramble -> Gray QAM -> MIMO channel + CFO + AWGN -> estimate
    -> joint MMSE -> int8 max-log demap -> descramble -> min-sum decode on
    the "xla" tier, as the JAX sweep builds it), scored on the systematic
    payload. The codeword bits are scattered over the data REs by a seeded
    channel interleaver (transport.layout); positions they do not fill stay
    random and count only for the uncoded BER.

    Returns {snr_db: {"coded_ber", "coded_bler", "parity_ok_frac",
    "uncoded_ber", "n_info_bits", "n_words"}}."""
    from .. import transport
    from ..models import receiver
    from ..ops import demap, ldpc

    dev = devices.resolve(device)
    if code is None:
        code = ldpc.array_code(6, 16, 61)  # rate ~0.63, n=976
    plan = ldpc.make_ldpc_plan(code)
    dec = ldpc.build_decoder(code, n_iters=n_iters, device=dev)
    nbits = demap.bits_per_symbol(modulation)
    mk = dict(n_rx=n_rx, modulation=modulation, scramble=scramble, n_prbs=n_prbs,
              n_layers=n_layers, **case_kwargs)
    out: Dict[float, Dict[str, float]] = {}
    for snr in snrs_db:
        info_errs = n_info = word_errs = n_words = ok_words = 0
        unc_errs = unc_total = 0
        for i in range(n_cases):
            seed = seed0 + i
            # the hops and grid shape of the MIMO link, without its channels
            geo = synthetic.make_case(seed=seed, snr_db=float(snr), n_prbs=n_prbs,
                                      n_layers=n_layers, **case_kwargs)
            n_sc, n_sym = geo.received_rg.shape
            coding = transport.TransportCoding(code=code, interleave_seed=seed ^ 0xC0DED)
            lay = transport.layout(coding, geo.hop1, geo.hop2, n_sc, n_sym, n_layers, nbits)
            rng = np.random.default_rng(seed ^ 0xC0DED)
            u = rng.integers(0, 2, (lay.c_words, plan.k), dtype=np.uint8)
            bits = transport.place_codewords(lay, ldpc.encode(code, u), n_layers, nbits, fill_rng=rng)
            stream = bits[lay.mask].reshape(-1)
            case = synthetic.make_mimo_case(seed=seed, snr_db=float(snr), bits=bits, **mk)
            fn = receiver.build_receiver_ri(case.hop1, case.hop2, case.config, n_layers, n_rx,
                                            modulation=modulation, device=dev)
            res = fn(estimator.split_ri(case.received_rg), estimator.split_ri(case.pilots),
                     float(case.beta))
            llr = np.stack([p.cpu().numpy() for p in res.llr], axis=-1)
            llr = np.transpose(llr, (2, 1, 0, 3)).astype(np.float32)
            if case.scramble_c is not None:
                llr = demap.descramble_llrs(llr, case.scramble_c)
            cw_llrs = transport.extract_streams(lay, llr)
            d = dec(cw_llrs)
            info = d.info.cpu().numpy()
            info_errs += int(np.sum(info != u))
            n_info += int(u.size)
            word_errs += int(np.sum(np.any(info != u, axis=-1)))
            ok_words += int(d.ok.sum())
            n_words += lay.c_words
            tx = stream[lay.perm].reshape(lay.c_words, code.n)
            unc_errs += int(np.sum((cw_llrs < 0) != tx))
            unc_total += int(tx.size)
        out[float(snr)] = {
            "coded_ber": info_errs / n_info,
            "coded_bler": word_errs / n_words,
            "parity_ok_frac": ok_words / n_words,
            "uncoded_ber": unc_errs / unc_total,
            "n_info_bits": n_info,
            "n_words": n_words,
        }
    return out
