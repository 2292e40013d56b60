"""The estimation of the CE configurations in plain PyTorch, float64: the
frozen numpy estimator (`oracle.py`) step for step, for what those
configurations run.

It runs one problem at a time on any torch device (the card included, with
TF32 pinned off), imports neither JAX nor the program, and reads the hop and
estimator configurations through their numpy properties. The steps: the LS
de-spread of the DM-RS REs, the first-pair CFO and its compensation, the time
average, the CDM pair average, the virtual pilots (straight-line fits of the
modulus and the unwrapped phase) and the raised-cosine smoothing, the
4096-point TA search, noise, RSRP and EPRE, and the linear fill into the
factored profiles.

Departures from `oracle.py`, each on purpose:
  - only what the CE configurations run: one hop, DM-RS type 1 (any CDM
    groups), `smoothing` "filter", `interp` "linear", `time_interp` "none",
    the first-pair CFO estimator; anything else raises;
  - the result is factored, as the program returns it: the profile of each
    layer over the hop's subcarriers and the CFO's rotation of each symbol;
    `channel_est_rg` expands them (profile times rotation over the hop's
    symbols), which is the oracle's grid;
  - the raised-cosine taps are designed here in torch (MATLAB's
    rcosdesign 'normal', subsampled at the pilot stride), not taken from the
    oracle;
  - the 'same' convolution is a sum over the taps, the TA's inverse FFT
    `torch.fft.ifft`, and the scalars sums in torch's order: float64
    rounding apart, the oracle's numbers.

    python -m cebench.reference.ce_torch --workload <cell> --seed <n> [--device cuda]

holds it to the oracle on every slot of a run's pool and prints the worst
NMSE and scalar error.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from dataclasses import dataclass

import numpy as np
import torch

NRE = 12
FFT_SIZE = 4096
C128 = torch.complex128
F64 = torch.float64


@dataclass
class TorchEstimate:
    profiles: torch.Tensor  # (n_layers, n_sc) complex128, zero outside the hop's band
    sym_rot: torch.Tensor  # (n_sym,) complex128
    start_symbol: int
    n_allocated_symbols: int
    noise_est: float
    rsrp: float
    epre: float
    time_alignment: float
    cfo_hz: float

    @property
    def channel_est_rg(self) -> np.ndarray:
        """(n_sc, n_sym, n_layers) complex128: the oracle's grid."""
        n_sym = self.sym_rot.shape[0]
        out = torch.zeros((self.profiles.shape[1], n_sym, self.profiles.shape[0]), dtype=C128,
                          device=self.profiles.device)
        s0, s1 = self.start_symbol, self.start_symbol + self.n_allocated_symbols
        out[:, s0:s1, :] = self.profiles.T[:, None, :] * self.sym_rot[None, s0:s1, None]
        return out.cpu().numpy()


def rc_taps(stride: int, n_rbs: int, device) -> torch.Tensor:
    """The smoothing filter (odd length, sum 1): rcosdesign(0.2, n_rbs, 10,
    'normal') sampled every `stride` taps about its centre."""
    beta, sps = 0.2, 10
    n = torch.arange(-n_rbs * sps // 2, n_rbs * sps // 2 + 1, dtype=F64, device=device)
    t = n / sps
    sinc = torch.where(t == 0, torch.ones_like(t), torch.sin(math.pi * t) / (math.pi * t))
    h = sinc * torch.cos(math.pi * beta * t) / (1.0 - (2.0 * beta * t) ** 2)
    t0 = 1.0 / (2.0 * beta)
    singular = ~torch.isfinite(h) | ((t.abs() - t0).abs() < 1e-6 / sps)
    limit = (math.pi * beta / 2.0) * math.sin(1.0 / (2.0 * beta))
    h = torch.where(singular, torch.full_like(h, limit), h)
    half = h.numel() // 2
    kmax = (half // stride) * stride
    taps = h[torch.arange(-kmax, kmax + 1, stride, device=device) + (h.numel() - 1) // 2]
    return taps / taps.sum()


def unwrap(ph: torch.Tensor) -> torch.Tensor:
    """numpy.unwrap of a 1-D phase (a wrapped -pi after a positive step
    maps to +pi)."""
    if ph.numel() <= 1:
        return ph.clone()
    dd = ph[1:] - ph[:-1]
    ddmod = torch.remainder(dd + math.pi, 2.0 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0), ddmod + 2.0 * math.pi, ddmod)
    corr = torch.where(dd.abs() < math.pi, torch.zeros_like(dd), ddmod - dd)
    return ph + torch.cat([ph.new_zeros(1), torch.cumsum(corr, 0)])


def virtual_pilots(p: torch.Tensor, n_virtuals: int) -> torch.Tensor:
    """Straight-line least-squares fits of |p| and its unwrapped phase over
    the indices 0..n-1, evaluated at -n_virtuals..-1."""
    n = p.numel()
    if n == 1:
        return p.expand(n_virtuals).clone()
    x = torch.arange(n, dtype=F64, device=p.device)
    k = torch.arange(-n_virtuals, 0, dtype=F64, device=p.device)
    mx = x.mean()
    denom = torch.sum(x * x) - n * mx * mx

    def line(y):
        a = (torch.sum(x * y) - n * mx * y.mean()) / denom
        return a * k + (y.mean() - a * mx)

    return line(p.abs()) * torch.exp(1j * line(unwrap(torch.angle(p))))


def smooth(h: torch.Tensor, taps: torch.Tensor, n_pils: int) -> torch.Tensor:
    """One column of pilot estimates (n_re,) smoothed: the virtual pilots at
    both edges, the 'same' convolution with zero padding, the edges cut."""
    vb = virtual_pilots(h[:n_pils], n_pils)
    ve = virtual_pilots(torch.flip(h[-n_pils:], (0,)), n_pils)
    x = torch.cat([vb, h, torch.flip(ve, (0,))])
    K = taps.numel()
    hw = (K - 1) // 2
    xp = torch.cat([x.new_zeros(hw), x, x.new_zeros(hw)])
    y = x.new_zeros(x.numel())
    for t in range(K):  # y[n] = sum_t taps[t] x[n + hw - t]
        y = y + taps[t] * xp[2 * hw - t: 2 * hw - t + x.numel()]
    return y[n_pils: n_pils + h.numel()]


def estimate(received_rg, pilots, beta: float, hop1, hop2, config, device="cpu") -> TorchEstimate:
    """The estimate of one problem: `received_rg` (n_sc, n_sym) and `pilots`
    (n_re, n_dsym, n_layers), complex, as the oracle takes them."""
    if hop2 is not None and not hop2.is_empty:
        raise ValueError("ce_torch holds one hop")
    if (config.smoothing, config.interp, config.time_interp) != ("filter", "linear", "none"):
        raise ValueError("ce_torch holds smoothing 'filter', interp 'linear', time_interp 'none'")
    if getattr(config, "cfo_estimator", "first_pair") != "first_pair":
        raise ValueError("ce_torch holds the first-pair CFO estimator")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _estimate(received_rg, pilots, float(beta), hop1, config, torch.device(device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _estimate(received_rg, pilots, beta, hop, config, device) -> TorchEstimate:
    rg = torch.as_tensor(np.asarray(received_rg, np.complex128), device=device)
    pil = torch.as_tensor(np.asarray(pilots, np.complex128), device=device)
    n_sc, n_sym = rg.shape
    n_re, nd, nL = pil.shape
    n_cdm = math.ceil(nL / 2)
    dsym = torch.as_tensor(np.nonzero(hop.dmrs_symbol_mask_np)[0], device=device)
    re_mask, prb_mask = hop.dmrs_re_mask_np, hop.prb_mask_np
    cpds = np.asarray(config.cp_durations_np, np.float64) * config.scs_hz / 1000.0
    vec = np.concatenate([[cpds[0]], cpds[1:14] + 1.0])
    sst = torch.as_tensor(np.cumsum(vec), device=device)  # symbol start times (symbol units)

    # LS de-spread of each CDM group's DM-RS REs
    rx = torch.empty((n_re, nd, n_cdm), dtype=C128, device=device)
    rec = torch.empty((n_re, nd, nL), dtype=C128, device=device)
    epre = 0.0
    re_idx = []
    for c in range(n_cdm):
        mask = np.kron(prb_mask.astype(np.int64), re_mask[:, c].astype(np.int64)) > 0
        idx = torch.as_tensor(np.nonzero(mask)[0], device=device)
        re_idx.append(idx)
        sel = rg[idx][:, dsym]
        rx[:, :, c] = sel
        epre += float(torch.sum(sel.real ** 2 + sel.imag ** 2))
        l0, l1 = 2 * c, min(nL, 2 * c + 2)
        rec[:, :, l0:l1] = sel[:, :, None] * torch.conj(pil[:, :, l0:l1])

    # the first-pair CFO, then its compensation at the DM-RS symbols' times
    cfo = None
    if nd >= 2:
        inner = torch.sum(torch.conj(rec[:, 0, :]) * rec[:, 1, :], dim=0)
        acc = 0.0
        for l in range(0, nL - 1, 2):
            acc += float(torch.angle(inner[l] + inner[l + 1]))
        if nL % 2 == 1:
            acc += float(torch.angle(inner[nL - 1]))
        d0, d1 = int(dsym[0]), int(dsym[1])
        n_samples = (d1 - d0) + float(np.sum(cpds[d0 + 1: d1 + 1]))
        cfo = acc / (2.0 * math.pi * n_samples) / n_cdm
        if config.cfo_compensate:
            rec = rec * torch.exp(-1j * 2.0 * math.pi * sst[dsym] * cfo)[None, :, None]

    # time average, CDM pair average, smoothing
    h = torch.sum(rec, dim=1) / beta / nd  # (n_re, nL)
    if nL >= 2:
        m = n_re // 2
        avg = (h[0:2 * m:2] + h[1:2 * m:2]) / 2.0
        h = h.clone()
        h[0:2 * m:2] = avg
        h[1:2 * m:2] = avg
    dmrs_per_prb = int(re_mask[:, 0].sum())
    n_prbs_masked = int(prb_mask.sum())
    taps = rc_taps(NRE // dmrs_per_prb, min(3, n_prbs_masked), device)
    n_pils = min(12, taps.numel() // 2) if n_prbs_masked > 1 else dmrs_per_prb
    h = torch.stack([smooth(h[:, l], taps, n_pils) for l in range(nL)], dim=1)

    # time alignment: the last CDM group's REs scattered into a 4096-point
    # inverse FFT, the power-delay profile's first maxima in its two windows
    est_sc = torch.zeros((n_sc, nL), dtype=C128, device=device)
    est_sc[re_idx[-1]] = h
    if n_sc < FFT_SIZE:
        est_sc = torch.cat([est_sc, est_sc.new_zeros((FFT_SIZE - n_sc, nL))])
    pdp = torch.sum(torch.fft.ifft(est_sc[:FFT_SIZE], dim=0).abs() ** 2, dim=1).cpu().numpy()
    half_cp = int(math.floor((144 / 2) * FFT_SIZE / 2048))
    head, tail = pdp[:half_cp], pdp[-half_cp:]
    i_d, i_a = int(np.argmax(head)), int(np.argmax(tail))
    i_max = i_d if head[i_d] >= tail[i_a] else -(half_cp - i_a)
    ta = i_max / float(FFT_SIZE) / config.scs_hz

    # noise and RSRP against the pilots rebuilt from the smoothed estimates
    rotate = config.cfo_compensate and cfo is not None
    ph = (torch.exp(1j * 2.0 * math.pi * sst[dsym] * cfo) if rotate
          else torch.ones(nd, dtype=C128, device=device))
    est_rx = torch.zeros_like(rx)
    for c in range(n_cdm):
        for l in range(2 * c, min(nL, 2 * c + 2)):
            est_rx[:, :, c] += beta * pil[:, :, l] * (h[:, l][:, None] * ph[None, :])
    d = rx - est_rx
    noise = float(torch.sum(d.real ** 2 + d.imag ** 2))
    rsrp = beta ** 2 * float(torch.sum(h.real ** 2 + h.imag ** 2)) * nd

    # the linear fill of each layer's profile over the hop's band
    n_sc_hop, sc0 = hop.n_prbs * NRE, NRE * hop.prb_start
    profiles = torch.zeros((nL, n_sc), dtype=C128, device=device)
    pos = torch.arange(n_sc_hop, dtype=F64, device=device)
    for c in range(n_cdm):
        filled = torch.as_tensor(np.nonzero(np.tile(re_mask[:, c], hop.n_prbs))[0], device=device)
        # filled[left] <= pos < filled[right]: the pilots themselves exact
        right = torch.searchsorted(filled, pos.to(filled.dtype), right=True)
        right = right.clamp(1, filled.numel() - 1)
        left = right - 1
        fl, fr = filled[left].to(F64), filled[right].to(F64)
        w = ((pos - fl) / (fr - fl)).clamp(0.0, 1.0)
        for l in range(2 * c, min(nL, 2 * c + 2)):
            full = h[left, l] + w * (h[right, l] - h[left, l])
            full = torch.where(pos <= fl[0], h[0, l], full)
            full = torch.where(pos >= filled[-1].to(F64), h[-1, l], full)
            profiles[l, sc0: sc0 + n_sc_hop] = full

    n_pilots = hop.n_prbs * dmrs_per_prb * nd
    rot = (torch.exp(1j * 2.0 * math.pi * sst * cfo) if rotate
           else torch.ones(n_sym, dtype=C128, device=device))
    return TorchEstimate(
        profiles=profiles, sym_rot=rot, start_symbol=hop.start_symbol,
        n_allocated_symbols=hop.n_allocated_symbols,
        noise_est=noise / (n_cdm * n_pilots - 1), rsrp=rsrp / n_pilots / nL, epre=epre / n_pilots,
        time_alignment=ta, cfo_hz=math.nan if cfo is None else cfo * config.scs_hz)


def reference(slot, device="cpu") -> list:
    """The estimate of each antenna of a CE slot (`gen.slots.ce_slot`)."""
    return [estimate(slot.rg[r], slot.pilots, slot.beta, slot.hop1, slot.hop2, slot.config,
                     device) for r in range(slot.rg.shape[0])]


def main(argv=None) -> int:
    from cebench import spec
    from cebench.reference import numbers, oracle

    ap = argparse.ArgumentParser(description="ce_torch against the oracle on a run's pool")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    cell = spec.load_workload(args.workload)
    chain = spec.load_module("chains", cell.config["chain"])
    traffic = spec.load_module("traffic", cell.traffic["kind"])
    worst_n = worst_s = 0.0
    n = 0
    for i in range(traffic.pool_slots(cell.traffic)):
        slot = chain.make_slot(cell.config, args.seed, i)
        for r in range(slot.rg.shape[0]):
            mine = estimate(slot.rg[r], slot.pilots, slot.beta, slot.hop1, slot.hop2, slot.config,
                            args.device)
            o = oracle.estimate(slot.rg[r], slot.pilots, slot.beta, slot.hop1, slot.hop2,
                                slot.config)
            worst_n = max(worst_n, numbers.nmse(mine.channel_est_rg, o.channel_est_rg))
            worst_s = max(worst_s, numbers.scalar_err(numbers.scalars_of(mine),
                                                      numbers.scalars_of(o)))
            n += 1
    print(json.dumps({"workload": args.workload, "seed": args.seed, "device": args.device,
                      "problems": n, "worst_nmse": worst_n, "worst_scalar_err": worst_s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
