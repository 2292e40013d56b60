"""Subcarrier-block sharding with overlap-save halo exchange:
`srsran_ce_tpu/parallel/subcarrier.py` on `torch.distributed`.

One wideband problem's frequency axis is split into contiguous blocks over
the mesh axis `sp`, one block a rank, and the only cross-rank traffic is the
collective layer's (`parallel/comm.py`):

  - a (K-1)/2-pilot halo exchange feeding the raised-cosine smoothing
    convolution (overlap-save: interior ranks exchange real neighbour taps,
    only the outermost synthesize virtual pilots);
  - a 1-pilot halo for the linear grid interpolation across the seams;
  - psums of the CFO inner products and of the EPRE / noise / RSRP sums;
  - an all_gather of the smoothed pilot estimates for the time-alignment PDP.

Every smoothing mode runs: "filter" (halo exchange, and the cnn_alpha blend
over a 1-halo), "mean" (a psum), "none", "wiener" (the tiny raw pilot vector
gathered, the exact shrinkage run replicated, the local slice kept),
"learned" and "learned2d" (the denoisers with a halo exchange before every
convolution, `models/denoiser.apply_sharded{,_2d}`; the built function then
takes the params as a trailing replicated argument). Interpolation is linear
(1-pilot halos) or the CNN inpainting operator (each rank applies its column
block of the exact operator to the gathered pilots). A shard count that does
not divide the band pads the pilot and subcarrier axes on the last rank's
tail (`ShardPlan.pad`), masked in the smoothing and cut by `gather_outputs`.

Frequency-hopped (two-hop) problems take another route (`HoppedShardPlan`):
the received grid is all_gathered, the exact unsharded per-hop front runs
replicated on every rank, and each rank fills only its own block of output
subcarriers from its column window of each hop's operator (BASELINE.json
config[4]).

SPMD, as every path of `parallel/`: each rank calls the built function on its
own blocks and gets its own blocks back. `fn.shard_inputs(...)` cuts a global
input into this rank's (padded, sliced) block and `fn.gather_outputs(res)`
assembles the global, logical result (tests, chip_smoke and the deep fuzz
use them). Where JAX branches on `axis_index` inside the traced program, the
rank here is a Python integer, so the edge handling of the outermost ranks
is plain control flow; every rank still issues every collective, in the
same order.

On the card each call replays one CUDA graph per key (`graphs.Graphed`); the
key's first call runs eagerly, which also creates an NCCL communicator
outside any capture. A gloo group cannot be captured: run a gloo world on
the card under `graphs.eager()`.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import devices, graphs
from ..config import NRE, EstimatorConfig, HopConfig
from ..models import denoiser as _dn
from ..models import estimator as _est
from ..models import receiver as _rcv
from ..models import tracking as _trk
from ..models.plan import EstimatorPlan, make_plan, plan_tensors
from ..ops import demap, dsp, mathx
from ..ops.kernels import full_f32_matmul
from . import mesh as _mesh


@dataclass(eq=False)
class ShardPlan:
    """Static per-shard geometry of the single-hop route (a numpy copy of the
    JAX ShardPlan). When n_sp does not divide the pilot count, the global
    pilot / subcarrier axes are padded to n_sp * R pilot slots (`pad` of them
    on the last shard's tail); the last shard holds `n_rlast` real pilots."""

    plan: EstimatorPlan
    n_sp: int
    comb: int
    offs: Tuple[int, ...]  # per-CDM first-pilot offset within the comb
    L: int  # local subcarriers per shard (padded geometry)
    R: int  # local pilot REs per shard (per CDM, padded geometry)
    hw: int  # conv halo width: (K-1)//2, the denoiser's, or 0
    pad: int  # padded pilot slots on the last shard's tail
    n_rlast: int  # real pilots on the last shard (== R when pad == 0)
    local_re_idx: np.ndarray  # (n_cdm, R) local sc index of local pilots
    interp_jl: np.ndarray  # (n_cdm, L) left anchor into the halo-extended (R+2) array
    interp_jr: np.ndarray
    interp_alpha: np.ndarray  # (n_cdm, L)
    first_zone: np.ndarray  # (n_cdm, L) bool: q <= off_c (constant extrapolation, first shard)
    last_zone: np.ndarray  # (n_cdm, L) bool: past the last real pilot (last shard)


def _comb_structure(re_mask_col: np.ndarray) -> Tuple[int, int]:
    """(comb, offset) of an arithmetic-progression RE mask column, or raise."""
    pos = np.nonzero(re_mask_col)[0]
    assert pos.size > 0, "empty DMRS RE mask column"
    if pos.size == 1:
        comb = NRE
    else:
        d = np.diff(pos)
        assert np.all(d == d[0]), f"RE mask not comb-uniform: {pos}"
        comb = int(d[0])
    assert NRE % comb == 0 and pos[0] < comb, f"RE mask not a comb pattern: {pos}"
    return comb, int(pos[0])


def make_shard_plan(plan: EstimatorPlan, n_sp: int) -> ShardPlan:
    """The single-hop shard geometry; raises AssertionError on a geometry the
    route does not take (as the JAX function)."""
    hp = plan.hop1
    hop = hp.hop
    assert plan.hop2 is None, "subcarrier sharding supports single-hop problems"
    assert plan.config.interp in ("linear", "cnn"), "unknown interpolation"
    prb_mask = hop.prb_mask_np
    assert prb_mask.all() and hop.prb_start == 0 and hop.n_prbs == prb_mask.size, (
        "subcarrier sharding requires a contiguous full-band hop"
    )

    re_mask = hop.dmrs_re_mask_np
    combs_offs = [_comb_structure(re_mask[:, c]) for c in range(hp.n_cdm)]
    combs = {c for c, _ in combs_offs}
    assert len(combs) == 1, "all CDM groups must share one comb"
    comb = combs.pop()
    offs = tuple(o for _, o in combs_offs)

    R = -(-hp.n_re // n_sp)
    L = R * comb
    pad = n_sp * R - hp.n_re
    n_rlast = R - pad
    assert n_rlast >= 1, (
        f"n_sp={n_sp} too large for n_re={hp.n_re}: last shard would hold no pilots"
    )
    if hp.n_layers >= 2:
        assert R % 2 == 0 and n_rlast % 2 == 0, (
            "CDM pair averaging requires even per-shard pilot counts "
            f"(R={R}, n_rlast={n_rlast}); choose a different n_sp"
        )
    if pad:
        assert plan.config.smoothing not in ("learned", "learned2d"), (
            "padded (non-divisible) sharding is not wired for learned smoothing: "
            "the denoiser's conv stack has no band-edge re-anchoring; choose an "
            "n_sp dividing n_prbs"
        )

    hw = 0
    if plan.config.smoothing == "filter":
        hw = (hp.rc_taps.size - 1) // 2
        assert n_rlast >= max(hw, hp.n_pils), (
            f"last shard's real pilot block ({n_rlast}) must cover halo ({hw}) "
            f"and virtual pilots ({hp.n_pils})"
        )
        if plan.config.cnn_alpha > 0.0:
            assert n_rlast >= 2, "cnn_alpha reflect padding needs >= 2 real local pilots"
    elif plan.config.smoothing == "learned":
        hw = _dn.halo_width()
        assert R >= hw, f"local pilot block ({R}) must cover the denoiser halo ({hw})"
    elif plan.config.smoothing == "learned2d":
        hw = _dn.halo_width_2d()
        assert R >= hw, f"local pilot block ({R}) must cover the 2-D denoiser halo ({hw})"

    local_re_idx = np.stack(
        [offs[c] + comb * np.arange(R, dtype=np.int32) for c in range(hp.n_cdm)]
    )
    q = np.arange(L)
    jl = np.empty((hp.n_cdm, L), np.int32)
    jr = np.empty((hp.n_cdm, L), np.int32)
    al = np.empty((hp.n_cdm, L), np.float64)
    fz = np.empty((hp.n_cdm, L), bool)
    lz = np.empty((hp.n_cdm, L), bool)
    for c in range(hp.n_cdm):
        off = offs[c]
        # anchors into the halo-extended pilot array hh of length R+2
        # (hh[0] = left neighbour's last pilot, hh[R+1] = right neighbour's first)
        jl[c] = np.floor_divide(q - off, comb) + 1
        jr[c] = jl[c] + 1
        al[c] = np.mod(q - off, comb) / comb
        fz[c] = q <= off
        lz[c] = q >= off + (n_rlast - 1) * comb
    return ShardPlan(plan=plan, n_sp=n_sp, comb=comb, offs=offs, L=L, R=R, hw=hw, pad=pad,
                     n_rlast=n_rlast, local_re_idx=local_re_idx, interp_jl=jl, interp_jr=jr,
                     interp_alpha=al, first_zone=fz, last_zone=lz)


@dataclass(eq=False)
class HoppedShardPlan:
    """Static geometry of the frequency-hopped route: L output subcarriers a
    shard, n_sp * L >= n_sc (the padded tail sits on the last shard). The
    JAX plan carries each hop's operators embedded into full-grid columns;
    here each rank slices its column window out of the hop's own operator
    (the plan's tensors), so nothing of size n_re x n_sc is built."""

    plan: EstimatorPlan
    n_sp: int
    L: int
    n_sc: int


def make_hopped_shard_plan(plan: EstimatorPlan, n_sp: int) -> HoppedShardPlan:
    assert plan.hop2 is not None, "use make_shard_plan for single-hop problems"
    n_sc = len(plan.hop1.hop.prb_mask) * NRE
    L = -(-n_sc // n_sp)
    # each rank writes every local column of a hop's symbol block, so the hop
    # symbol ranges must not overlap (true for frequency hopping)
    s1 = set(range(plan.hop1.sym_start, plan.hop1.sym_start + plan.hop1.n_alloc_syms))
    s2 = set(range(plan.hop2.sym_start, plan.hop2.sym_start + plan.hop2.n_alloc_syms))
    assert not (s1 & s2), "hopped SP sharding requires disjoint hop symbol ranges"
    return HoppedShardPlan(plan=plan, n_sp=n_sp, L=L, n_sc=n_sc)


# ---------------------------------------------------------------------------
# Padding helpers (the non-divisible route)
# ---------------------------------------------------------------------------


def _pad_to(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """Zero-pad dimension `dim` of x up to length n (x itself when already there)."""
    cur = x.shape[dim]
    if cur == n:
        return x
    shape = list(x.shape)
    shape[dim] = n - cur
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _slice_to(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    return x if x.shape[dim] == n else x.narrow(dim, 0, n)


def _block(x: torch.Tensor, dim: int, n_pad: int, rank: int, width: int) -> torch.Tensor:
    """Rank `rank`'s block of `width` along `dim` after padding it to n_pad."""
    return _pad_to(x, dim, n_pad).narrow(dim, rank * width, width).contiguous()


# ---------------------------------------------------------------------------
# The per-rank bodies
# ---------------------------------------------------------------------------


def _shard_tables(sp: ShardPlan, ht: dict, rank: int, device, dtype) -> dict:
    """The single-hop route's static tensors for `rank` on (device, dtype)."""
    hp = sp.plan.hop1
    idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    real = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)
    t = dict(
        re_idx=idx(sp.local_re_idx.reshape(-1)),
        jl=[idx(a) for a in sp.interp_jl],
        jr=[idx(a) for a in sp.interp_jr],
        alpha=[real(a) for a in sp.interp_alpha],
        first_zone=[torch.as_tensor(a, device=device) for a in sp.first_zone],
        last_zone=[torch.as_tensor(a, device=device) for a in sp.last_zone],
        valid=real(np.arange(sp.R) < sp.n_rlast),
        pair_ok=real(np.arange(sp.R - 1) < sp.n_rlast - 1),
        w_local=None,
    )
    if sp.plan.config.interp == "cnn":
        # this rank's column block of each CDM group's inpainting operator
        # (zero columns for the padded tail)
        t["w_local"] = [
            _block(w, 1, sp.n_sp * sp.L, rank, sp.L) for w in ht["interp"]
        ]
    return t


def _sharded_problem(sp: ShardPlan, pt: dict, tb: dict, comm, rg, pil, beta, params=None,
                     out_layout: str = "ref", h_prev=None, track_w=None):
    """The single-hop body for this rank's block of a batch of problems.

    rg (B, L, n_sym) complex, pil (B, R, n_dsym, nL) complex, beta (B,) real;
    `pt` the plan's tensors, `tb` this rank's `_shard_tables`. Returns the
    local EstimateResult (channel (B, 2, L, n_sym, nL)) or FactoredResult
    (profiles (B, 2, 1, nL, L), the rotation replicated), in ri layout.

    h_prev / track_w: the tracking state (models/tracking.py): this rank's
    (B, nL, R) slice of the previous tracked pilot estimate and the (B,)
    weights. The gain statistics pool over the ranks (psums; the pilot
    difference across each seam rides a 1-halo exchange), so the tracked
    result equals the unsharded tracker's. Returns (result, (h_blend ri,
    w_new)) when tracking."""
    plan = sp.plan
    hp = plan.hop1
    ht = pt["hops"][0]
    config = plan.config
    nL, nd, R = hp.n_layers, hp.n_dsym, sp.R
    B = rg.shape[0]
    rdtype = rg.real.dtype
    first, last = comm.rank == 0, comm.rank == comm.size - 1
    sst = pt["sst"]
    sst_d = None if sst is None else sst[ht["dmrs_sym_idx"]]

    # --- gather + LS de-spread (local) ---
    rx = rg.index_select(1, tb["re_idx"]).reshape(B, hp.n_cdm, R, rg.shape[2])
    rx = rx.index_select(3, ht["dmrs_sym_idx"])  # (B, n_cdm, R, nd)
    epre_loc = dsp.fro_norm_sq(rx, batch_dims=1)
    rx_l = rx.repeat_interleave(2, dim=1)[:, :nL]  # layer l reads CDM group l // 2
    pil_l = pil.permute(0, 3, 1, 2)  # (B, nL, R, nd)
    rec_x = rx_l * torch.conj(pil_l)

    # --- CFO: global inner products by psum ---
    cfo_hop = None
    if hp.cfo_possible:
        if hp.cfo_pair_dt is not None:
            # WLS over every consecutive DM-RS pair; all the pairs ride one psum
            inner_all = comm.psum(torch.stack(
                [torch.sum(torch.conj(rec_x[..., j]) * rec_x[..., j + 1], dim=2)
                 for j in range(nd - 1)], dim=1))  # (B, n_pairs, nL)
            num = torch.zeros(B, dtype=rdtype, device=rg.device)
            den = torch.zeros(B, dtype=rdtype, device=rg.device)
            for j in range(nd - 1):
                dt = float(hp.cfo_pair_dt[j])
                for c in range(hp.n_cdm):
                    pair = inner_all[:, j, 2 * c] + (
                        inner_all[:, j, 2 * c + 1] if 2 * c + 1 < nL else 0.0)
                    num = num + pair.abs() * dt * torch.angle(pair)
                    den = den + pair.abs() * dt * dt
            cfo_hop = num / (2.0 * math.pi * den.clamp_min(1e-30))
        else:
            inner = comm.psum(torch.sum(torch.conj(rec_x[..., 0]) * rec_x[..., 1], dim=2))
            acc = torch.zeros(B, dtype=rdtype, device=rg.device)
            for c in range(hp.n_cdm):
                pair = inner[:, 2 * c] + (inner[:, 2 * c + 1] if 2 * c + 1 < nL else 0.0)
                acc = acc + torch.angle(pair)
            cfo_hop = acc / (2.0 * math.pi * hp.n_samples) / hp.n_cdm
        if config.cfo_compensate:
            rot_d = torch.exp(-1j * (2.0 * math.pi * sst_d[None, :] * cfo_hop[:, None]))
            rec_x = rec_x * rot_d[:, None, None, :]

    # --- time average + CDM pair average (local; R is even with >= 2 layers) ---
    pair_average = _est._pair_average
    h_raw = torch.sum(rec_x, dim=-1) / beta[:, None, None] / nd  # (B, nL, R)
    h_p = pair_average(h_raw) if nL >= 2 else h_raw
    h_t = None
    if hp.time_interp_mat is not None:
        # per-DM-RS-symbol rows, (layer, dmrs_sym) layer-major
        h_t = rec_x.permute(0, 1, 3, 2).reshape(B, nL * nd, R) / beta[:, None, None]
        if nL >= 2:
            h_t = pair_average(h_t)

    def mask_tail(h):
        """Zero the last shard's padded tail (the smoothing may spill into it)."""
        return h * tb["valid"] if sp.pad and last else h

    def exchange(x, w):
        return comm.halo_exchange(x, w)

    def smooth_rows(h):  # (B, rows, R) -> (B, rows, R)
        if hp.smoothing == "mean":
            mean = comm.psum(torch.sum(h, dim=-1)) / hp.n_re  # (B, rows)
            return mask_tail(mean[..., None].expand(h.shape))
        if hp.smoothing == "filter":
            hw, n_pils = sp.hw, hp.n_pils
            lh, rh = exchange(h, hw)
            # the outermost shards synthesize virtual pilots; zeros beyond
            # them match the unsharded zero padding (n_pils <= hw)
            if first:
                vb = _est._virtual_pilots(h[..., :n_pils], ht["vp"], n_pils)
                lh = dsp._pad_last(vb, hw - n_pils, 0)
            if last:
                # the band-edge extension starts right after the last REAL
                # pilot (inside h when its tail is padded)
                tail = torch.flip(h[..., sp.n_rlast - n_pils : sp.n_rlast], dims=(-1,))
                ve = _est._virtual_pilots(tail, ht["vp"], n_pils)
                ext = torch.cat([lh, h[..., : sp.n_rlast],
                                 dsp._pad_last(torch.flip(ve, dims=(-1,)), 0,
                                               sp.pad + hw - n_pils)], dim=-1)
            else:
                ext = torch.cat([lh, h, rh], dim=-1)  # (B, rows, R + 2 hw)
            h = dsp.conv_valid(ext, hp.rc_taps)
            if config.cnn_alpha > 0.0:
                # the 3-tap low-pass blend: interior seams use the neighbours'
                # taps, the outermost shards reflect locally (the global
                # reflection of element 0 is element 1, on shard 0)
                alpha = min(1.0, max(0.0, config.cnn_alpha))
                lh2, rh2 = exchange(h, 1)
                if first:
                    lh2 = h[..., 1:2]
                hl = h
                if last:
                    rh2 = h[..., sp.n_rlast - 2 : sp.n_rlast - 1]
                    if sp.pad:  # the reflection sits where the conv's garbage is
                        hl = torch.cat([h[..., : sp.n_rlast], rh2, h[..., sp.n_rlast + 1 :]],
                                       dim=-1)
                lp = dsp.conv_valid(torch.cat([lh2, hl, rh2], dim=-1), np.asarray([0.25, 0.5, 0.25]))
                h = h + alpha * (lp - h)
            return mask_tail(h)
        if hp.smoothing == "learned":
            if params is None:
                raise ValueError("smoothing='learned' needs denoiser params")
            return _dn.apply_sharded(params, h, exchange)
        if hp.smoothing == "wiener":
            # the eigenbasis projection is global and tiny: gather the raw
            # pilots, shrink replicated, keep this shard's R columns
            h_all = comm.all_gather(h, -1)[..., : hp.n_re]
            h_sm = _pad_to(_est._smooth_wiener(ht, hp, h_all), -1, sp.n_sp * R)
            return h_sm[..., comm.rank * R : (comm.rank + 1) * R]
        return h  # "none"

    h_pre = h_p  # pre-smoothing estimates (tracking blends in this domain)
    if hp.smoothing == "learned2d":
        if params is None:
            raise ValueError("smoothing='learned2d' needs denoiser params")
        h_p = _dn.apply_sharded_2d(params, h_p[:, :, None, :], exchange)[:, :, 0, :]
        if h_t is not None:
            h_t = _dn.apply_sharded_2d(params, h_t.reshape(B, nL, nd, R), exchange).reshape(
                B, nL * nd, R)
    else:
        h_p = smooth_rows(h_p)
        if h_t is not None:
            h_t = smooth_rows(h_t)

    # --- time alignment: the gathered (tiny) smoothed pilots, a shared PDP ---
    h_all = comm.all_gather(h_p, -1)  # (B, nL, n_sp R)
    k = hp.ta_scatter_idx.size
    hcl = hp.half_cp_len
    z = h_p.new_zeros((B, hp.fft_size, nL))
    z[:, ht["ta_idx"], :] = h_all[..., :k].transpose(1, 2)
    pdp = torch.sum(torch.fft.ifft(z, dim=1).abs() ** 2, dim=2)  # (B, fft_size)
    head, tail = pdp[:, :hcl], pdp[:, -hcl:]
    i_delay = mathx.argmax_last(head)
    i_adv = mathx.argmax_last(tail)
    i_max = torch.where(
        head.gather(1, i_delay[:, None])[:, 0] >= tail.gather(1, i_adv[:, None])[:, 0],
        i_delay.to(rdtype), -(hcl - i_adv).to(rdtype))
    ta = i_max / float(hp.fft_size) / float(config.scs_hz)

    # --- reconstruction; noise, RSRP, EPRE: local sums, one psum ---
    cfo_on = config.cfo_compensate and cfo_hop is not None
    if cfo_on:
        ph = torch.exp(1j * (2.0 * math.pi * sst_d[None, :] * cfo_hop[:, None]))  # (B, nd)
        h_ph = h_p[..., None] * ph[:, None, None, :]
    else:
        h_ph = h_p[..., None]
    contrib = beta[:, None, None, None] * pil_l * h_ph  # (B, nL, R, nd)
    est_rx = torch.stack([contrib[:, l0:l1].sum(dim=1) for l0, l1 in hp.layer_slices], dim=1)
    noise_loc = dsp.fro_norm_sq(rx - est_rx, batch_dims=1)
    rsrp_loc = beta**2 * dsp.fro_norm_sq(h_p, batch_dims=1) * nd
    sums = comm.psum(torch.stack([epre_loc, noise_loc, rsrp_loc], dim=1))  # (B, 3)
    epre = sums[:, 0] / plan.n_pilots
    noise = sums[:, 1] / plan.noise_den
    rsrp = sums[:, 2] / plan.n_pilots / nL
    n_sym = rg.shape[2]
    if cfo_on:
        rot = torch.exp(1j * (2.0 * math.pi * sst[None, :] * cfo_hop[:, None]))  # (B, n_sym)
    else:
        rot = torch.ones((B, n_sym), dtype=rg.dtype, device=rg.device)
    cfo_hz = (cfo_hop * config.scs_hz if cfo_hop is not None
              else torch.full((B,), math.nan, dtype=rdtype, device=rg.device))

    # --- grid fill (rows per layer rpl > 1 on the time-interpolation path) ---
    def fill_rows(h, h_all_rows, rpl):  # (B, rows, R) -> (B, rows, L)
        outs = []
        if config.interp == "cnn":
            # this rank's column block of the exact inpainting operator, applied
            # to the gathered pilots: no halos
            for c, (l0, l1) in enumerate(hp.layer_slices):
                outs.append(dsp.inpaint_matmul(
                    h_all_rows[:, l0 * rpl : l1 * rpl, : hp.n_re], tb["w_local"][c]))
            return torch.cat(outs, dim=1)
        lh1, rh1 = exchange(h, 1)
        hh = torch.cat([lh1, h, rh1], dim=-1)  # (B, rows, R + 2)
        for c, (l0, l1) in enumerate(hp.layer_slices):
            vals = hh[:, l0 * rpl : l1 * rpl]
            base = dsp.lerp_gather(vals, tb["jl"][c], tb["jr"][c], tb["alpha"][c])
            if first:
                base = torch.where(tb["first_zone"][c], vals[..., 1:2], base)
            if last:
                # constant extrapolation from the last REAL pilot (hh index n_rlast)
                base = torch.where(tb["last_zone"][c], vals[..., sp.n_rlast : sp.n_rlast + 1], base)
            outs.append(base)
        return torch.cat(outs, dim=1)

    # --- multi-slot tracking blend (the unsharded tracker's gain, pooled) ---
    track_out = None
    h_fill, h_all_fill = h_p, h_all
    if h_prev is not None:
        if h_t is not None:
            raise ValueError("tracking requires time_interp='none'")
        # the unsharded tracker blends the RAW estimate where the fused filter
        # matrices hold the pair average, the pair-averaged one otherwise
        track_raw = _est._use_fused_smooth(hp, "xla") and nL >= 2
        h_obs = h_raw if track_raw else h_pre
        anchor = None
        if cfo_on:
            # the state lives in the anchor-free domain (cfo_hop is a psum:
            # the same anchor on every rank)
            t_bar = float(np.mean(plan.symbol_start_time[hp.dmrs_sym_idx]))
            anchor = torch.exp(1j * (2.0 * math.pi * t_bar) * cfo_hop)[:, None, None]
            h_obs = h_obs * anchor
        d = h_obs[..., 1:] - h_obs[..., :-1]
        if sp.pad and last:
            d = d * tb["pair_ok"]  # no pair touching the padded tail
        s_loc = torch.sum(d.real**2 + d.imag**2, dim=(1, 2)) / 2.0
        if comm.size > 1:
            _, rh = exchange(h_obs, 1)
            if not last:
                ds = rh[..., 0] - h_obs[..., -1]
                s_loc = s_loc + torch.sum(ds.real**2 + ds.imag**2, dim=1) / 2.0
        e = h_obs - h_prev
        i_loc = torch.sum(e.real**2 + e.imag**2, dim=(1, 2))
        stats = comm.psum(torch.stack([s_loc, i_loc], dim=1))
        sig2 = (stats[:, 0] / (nL * (hp.n_re - 1))).clamp_min(1e-30)
        innov = (stats[:, 1] / (nL * hp.n_re)).clamp_min(1e-30)
        w = track_w.to(rdtype)
        a_static = 1.0 / (w + 1.0)
        a_move = torch.clamp(1.0 - 2.0 * sig2 / innov, 0.0, 1.0)
        a = torch.where(w < 0.5, torch.ones_like(w), torch.maximum(a_static, a_move))
        h_blend = h_prev + a[:, None, None] * (h_obs - h_prev)
        h_cur = h_blend if anchor is None else h_blend * torch.conj(anchor)
        h_fill = smooth_rows(pair_average(h_cur) if track_raw else h_cur)
        h_all_fill = comm.all_gather(h_fill, -1) if config.interp == "cnn" else None
        w_new = torch.clamp(1.0 / a.clamp_min(1e-3), max=64.0)
        track_out = (_est._complex_to_ri(h_blend), w_new)

    def ret(res):
        return res if track_out is None else (res, track_out)

    if out_layout == "factored":
        full = fill_rows(h_fill, h_all_fill, 1)  # (B, nL, L)
        return ret(_est.result_to_ri(_est.FactoredResult(
            full[:, None], rot, noise, rsrp, epre, ta, cfo_hz)))

    syms = slice(hp.sym_start, hp.sym_start + hp.n_alloc_syms)
    if h_t is not None:
        ht_all = comm.all_gather(h_t, -1) if config.interp == "cnn" else None
        ft = fill_rows(h_t, ht_all, nd).reshape(B, nL, nd, sp.L)
        mm = lambda a: torch.einsum("blds,dt->blts", a, ht["time_interp_t"])
        block = torch.complex(mm(ft.real), mm(ft.imag)).permute(0, 3, 2, 1)  # (B, L, n_alloc, nL)
    else:
        full = fill_rows(h_fill, h_all_fill, 1)  # (B, nL, L)
        block = full.transpose(1, 2)[:, :, None, :]
    block = block * rot[:, None, syms, None]
    channel = rg.real.new_zeros((B, 2, sp.L, n_sym, nL))
    _est._write_block(channel, block.expand(B, sp.L, hp.n_alloc_syms, nL),
                      (slice(None), syms, slice(None)))
    return ret(_est.EstimateResult(channel, noise, rsrp, epre, ta, cfo_hz))


def _sharded_problem_hopped(hsp: HoppedShardPlan, pt: dict, comm, rg, pil, beta,
                            out_layout: str = "ref", h_prev=None, track_w=None):
    """The frequency-hopped body for this rank's block of a batch of problems.

    rg (B, L, n_sym) complex: this rank's subcarriers; pil (B, n_re,
    n_dsym_total, nL) complex, replicated. The received grid is gathered, the
    exact unsharded per-hop front (`estimator._process_hop`) runs replicated,
    and this rank fills its own L output subcarriers from its column window of
    each hop's fill operator. h_prev / track_w: the unsharded tracker's state
    (replicated, a tuple of per-hop (B, nL, n_re)); the blend is the unsharded
    `estimator._track_blend` verbatim. Returns the local EstimateResult /
    FactoredResult (profiles (B, 2, 2, nL, L)), with (h_blend ri tuple,
    w_new) when tracking."""
    plan = hsp.plan
    config = plan.config
    nL = plan.n_layers
    B, L, n_sym = rg.shape
    rdtype = rg.real.dtype
    sst = pt["sst"]
    lo_g = comm.rank * L  # this rank's first global subcarrier

    rg_full = comm.all_gather(rg, 1)  # (B, n_sp L, n_sym)
    hops = [(plan.hop1, pt["hops"][0], pil[:, :, : plan.n_dsym1]),
            (plan.hop2, pt["hops"][1], pil[:, :, plan.n_dsym1 :])]
    zeros = torch.zeros(B, dtype=rdtype, device=rg.device)
    epre, noise, rsrp, ta = zeros, zeros, zeros, zeros
    cfo = None
    h_ps, h_ts, h_pres, cfo_hs = [], [], [], []
    for hp, ht, pil_h in hops:
        sst_d = None if sst is None else sst[ht["dmrs_sym_idx"]]
        e_i, cfo_h, ta_i, n_i, r_i, h_p, h_t, h_pre = _est._process_hop(
            hp, ht, config, rg_full, pil_h, beta, sst_d, "xla")
        epre, noise, rsrp, ta = epre + e_i, noise + n_i, rsrp + r_i, ta + ta_i
        if cfo_h is not None:
            cfo = cfo_h if cfo is None else (cfo + cfo_h) / 2.0
        h_ps.append(h_p)
        h_ts.append(h_t)
        h_pres.append(h_pre)
        cfo_hs.append(cfo_h)

    track_out = None
    if h_prev is not None:
        if any(h_t is not None for h_t in h_ts):
            raise ValueError("tracking requires time_interp='none'")
        h_ps, (h_blend, w_new) = _est._track_blend(
            plan, [(hp, ht) for hp, ht, _ in hops], h_pres, cfo_hs, h_prev,
            track_w.to(rdtype), "xla", None)
        track_out = (tuple(_est._complex_to_ri(h) for h in h_blend), w_new)

    rsrp = rsrp / plan.n_pilots / nL
    epre = epre / plan.n_pilots
    noise = noise / plan.noise_den
    ta = ta / 2.0
    cfo_hz = cfo * config.scs_hz if cfo is not None else torch.full_like(zeros, math.nan)
    if config.cfo_compensate and cfo is not None:
        rot = torch.exp(1j * (2.0 * math.pi * sst[None, :] * cfo[:, None]))  # (B, n_sym)
    else:
        rot = torch.ones((B, n_sym), dtype=rg.dtype, device=rg.device)

    def window(hp):
        """This rank's columns of the hop band: (local lo, hi, hop-relative lo, hi)."""
        lo = max(lo_g, hp.sc_start)
        hi = min(lo_g + L, hp.sc_start + hp.n_sc_hop)
        return lo - lo_g, hi - lo_g, lo - hp.sc_start, hi - hp.sc_start

    def fill(hp, ht, vals, rpl, c0, c1):  # (B, nL rpl, n_re) -> (B, nL rpl, c1 - c0)
        return torch.cat([dsp.inpaint_matmul(vals[:, l0 * rpl : l1 * rpl], ht["interp"][c][:, c0:c1])
                          for c, (l0, l1) in enumerate(hp.layer_slices)], dim=1)

    def ret(res):
        return res if track_out is None else (res, track_out)

    if out_layout == "factored":
        if any(h_t is not None for h_t in h_ts):
            raise ValueError("out_layout='factored' requires time_interp='none'")
        profiles = rg.new_zeros((B, 2, nL, L))
        for h, ((hp, ht, _), h_p) in enumerate(zip(hops, h_ps)):
            a0, a1, c0, c1 = window(hp)
            if a1 > a0:
                profiles[:, h, :, a0:a1] = fill(hp, ht, h_p, 1, c0, c1)
        return ret(_est.result_to_ri(_est.FactoredResult(
            profiles, rot, noise, rsrp, epre, ta, cfo_hz)))

    channel = rg.real.new_zeros((B, 2, L, n_sym, nL))
    for (hp, ht, _), h_p, h_t in zip(hops, h_ps, h_ts):
        a0, a1, c0, c1 = window(hp)
        if a1 <= a0:
            continue
        syms = slice(hp.sym_start, hp.sym_start + hp.n_alloc_syms)
        rot_slice = rot[:, syms]
        if h_t is not None:
            ft = fill(hp, ht, h_t, hp.n_dsym, c0, c1).reshape(B, nL, hp.n_dsym, c1 - c0)
            mm = lambda a: torch.einsum("blds,dt->blts", a, ht["time_interp_t"])
            block = torch.complex(mm(ft.real), mm(ft.imag)) * rot_slice[:, None, :, None]
            block = block.permute(0, 3, 2, 1)
        else:
            full = fill(hp, ht, h_p, 1, c0, c1)
            block = full.transpose(1, 2)[:, :, None, :] * rot_slice[:, None, :, None]
        _est._write_block(channel, block, (slice(a0, a1), syms, slice(None)))
    return ret(_est.EstimateResult(channel, noise, rsrp, epre, ta, cfo_hz))


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

#: result fields sharded over the subcarriers, by the dimension (from the end)
#: that carries them; every other field is replicated over sp
_SC_DIMS = {"channel_est_rg": -3, "profiles": -1, "x": -1, "sinr": -1, "llr": -1}


class ShardedBuilder:
    """The function a `build_sp*` returns: this rank's blocks in, this rank's
    blocks out, on the inputs' device and dtype (float32 or float64), with
    `shard_inputs` / `gather_outputs` for global arrays.

    kind "est": fn(rg_ri, pil_ri, beta[, params]) -> EstimateResult |
    FactoredResult; "tracked": fn(rg_ri, pil_ri, beta, h_prev_ri, w) ->
    (result, h_new_ri, w_new); "receiver": fn(rg_ri, pil_ri, beta) ->
    ReceiverResult | LlrResult. rg_ri (2, L, n_sym) (the receiver: (2, n_rx,
    L, n_sym)); pil_ri (2, R, n_dsym, nL) on the single-hop route, the whole
    (2, n_re, n_dsym, nL) on the hopped one; batched builders add a leading
    problem axis (this rank's dp slice)."""

    def __init__(self, plan, mesh, sp_axis: str, dp_axis: Optional[str], batched: bool,
                 out_layout: str, kind: str, device, rx: Optional[dict] = None):
        self.plan = plan
        self.mesh = mesh
        self.sp_axis, self.dp_axis = sp_axis, dp_axis
        self.batched = batched
        self.out_layout = out_layout
        self.kind = kind
        self.device = device
        self.rx = rx or {}
        self.comm = _mesh.comm(mesh, sp_axis)
        n_sp = self.comm.size
        self.hopped = plan.hop2 is not None
        if self.hopped:
            self.sp = make_hopped_shard_plan(plan, n_sp)
            self.n_re_pad = None
        else:
            self.sp = make_shard_plan(plan, n_sp)
            self.n_re_pad = n_sp * self.sp.R
        self.n_sc = len(plan.hop1.hop.prb_mask) * NRE
        self.L = self.sp.L
        self._tensors: dict = {}
        p = plan
        self._graphed = graphs.Graphed(self._forward, (
            f"ShardedBuilder(kind={kind!r}, out_layout={out_layout!r}, batched={batched}, "
            f"n_sp={n_sp}, rank={self.comm.rank}, n_layers={p.n_layers}, smoothing="
            f"{p.config.smoothing!r}, interp={p.config.interp!r}, hopped={self.hopped}, "
            f"n_sc={self.n_sc})"))

    # -- global <-> local -------------------------------------------------
    def shard_inputs(self, rg_ri, pil_ri, h_prev_ri=None):
        """This rank's blocks of global inputs (numpy or tensors; numpy goes to
        the build's device): the dp slice of a batch, the subcarrier block of
        the grid and (single hop) the pilot block, padded when n_sp does not
        divide the band. A single-hop tracking state is cut like the pilots."""
        as_t = lambda a: a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a), device=self.device)
        rg_ri, pil_ri = as_t(rg_ri), as_t(pil_ri)
        if self.batched:
            rg_ri = _mesh.batch_slice(rg_ri, self.mesh, self.dp_axis)
            pil_ri = _mesh.batch_slice(pil_ri, self.mesh, self.dp_axis)
        r, n_sp = self.comm.rank, self.comm.size
        rg = _block(rg_ri, rg_ri.dim() - 2, n_sp * self.L, r, self.L)
        pil = pil_ri if self.hopped else _block(pil_ri, pil_ri.dim() - 3, self.n_re_pad, r, self.sp.R)
        if h_prev_ri is None:
            return rg, pil
        h = tuple(as_t(x) for x in h_prev_ri)
        if not self.hopped:
            h = tuple(_block(x, x.dim() - 1, self.n_re_pad, r, self.sp.R) for x in h)
        return rg, pil, h

    def gather_outputs(self, out):
        """The global, logical result of this rank's: the subcarrier blocks
        gathered over sp and cut to the band (a single-hop tracking state: to
        the pilots), then, batched, the problems over dp."""
        c = self.comm

        def sc(name, v):
            if isinstance(v, tuple):
                return tuple(sc(name, x) for x in v)
            if name not in _SC_DIMS or not torch.is_tensor(v):
                return v
            dim = v.dim() + _SC_DIMS[name]
            return _slice_to(c.all_gather(v, dim), dim, self.n_sc)

        def result(res):
            return type(res)(**{f.name: sc(f.name, getattr(res, f.name))
                                for f in dataclasses.fields(res)})

        if self.kind == "tracked":
            res, h_new, w_new = out
            if not self.hopped:
                h_new = tuple(_slice_to(c.all_gather(h, h.dim() - 1), h.dim() - 1,
                                        self.plan.hop1.n_re) for h in h_new)
            out = (result(res), h_new, w_new)
        else:
            out = result(out)
        if self.batched:
            out = _mesh.gather_batch(out, self.mesh, self.dp_axis)
        return out

    # -- calls --------------------------------------------------------------
    def _tables(self, device, dtype):
        key = (torch.device(device), dtype)
        hit = self._tensors.get(key)
        if hit is None:
            pt = plan_tensors(self.plan, key[0], dtype)
            tb = None if self.hopped else _shard_tables(self.sp, pt["hops"][0], self.comm.rank,
                                                        key[0], dtype)
            hit = self._tensors[key] = (pt, tb)
        return hit

    def __call__(self, rg_ri, pil_ri, beta, *rest):
        rg_ri = rg_ri if torch.is_tensor(rg_ri) else torch.as_tensor(rg_ri, device=self.device)
        dev, dt = rg_ri.device, rg_ri.dtype
        if dt not in (torch.float32, torch.float64):
            raise TypeError(f"the sharded builders take float32 or float64 ri tensors, not {dt}")
        as_t = lambda a: torch.as_tensor(a, device=dev, dtype=dt)
        pil_ri, beta = as_t(pil_ri), as_t(beta)
        if self.kind == "tracked":
            h_prev_ri, w = rest
            res, *state = self._graphed(rg_ri, pil_ri, beta, as_t(w), *(as_t(h) for h in h_prev_ri))
            return res, tuple(state[:-1]), state[-1]
        params = rest[0] if rest else None
        if params is None and self.plan.config.smoothing in ("learned", "learned2d"):
            raise ValueError(f"smoothing={self.plan.config.smoothing!r} needs denoiser params")
        return self._graphed(rg_ri, pil_ri, beta, params)

    def _body(self, rg, pil, beta, params, out_layout, h_prev=None, w=None):
        pt, tb = self._tables(rg.device, rg.real.dtype)
        if self.hopped:
            return _sharded_problem_hopped(self.sp, pt, self.comm, rg, pil, beta, out_layout,
                                           h_prev, w)
        return _sharded_problem(self.sp, pt, tb, self.comm, rg, pil, beta, params, out_layout,
                                h_prev, w)

    def _forward(self, rg_ri, pil_ri, beta, *rest):
        one = not self.batched
        if one:
            rg_ri, pil_ri, beta = rg_ri[None], pil_ri[None], beta.reshape(1)
        rg = _est._ri_to_complex(rg_ri)
        pil = _est._ri_to_complex(pil_ri)
        with full_f32_matmul():
            if self.kind == "receiver":
                out = self._receiver(rg, pil, beta)
            elif self.kind == "tracked":
                w, *h_prev_ri = rest
                if one:
                    w, h_prev_ri = w.reshape(1), [h[None] for h in h_prev_ri]
                h_prev = tuple(_est._ri_to_complex(h) for h in h_prev_ri)
                res, (h_new, w_new) = self._body(rg, pil, beta, None, self.out_layout,
                                                 h_prev if self.hopped else h_prev[0], w)
                h_new = h_new if self.hopped else (h_new,)
                if one:
                    res = _unbatch(res)
                    h_new, w_new = tuple(h[0] for h in h_new), w_new[0]
                return (res, *h_new, w_new)
            else:
                out = self._body(rg, pil, beta, rest[0], self.out_layout)
        return _unbatch(out) if one else out

    def _receiver(self, rg, pil, beta):
        """Per-port factored estimation on the sharded front, folded into the
        problem axis as `receiver.receiver_impl` folds it, then the plain
        receiver's cross-port MMSE tail: per subcarrier, so shard-local."""
        B, n_rx, L, n_sym = rg.shape
        est = self._body(rg.reshape(B * n_rx, L, n_sym), pil.repeat_interleave(n_rx, dim=0),
                         beta.repeat_interleave(n_rx, dim=0), None, "factored")
        rx = self.rx
        return _rcv._equalize_tail(self.plan, rg, est, True, rx["data_beta"], rx["modulation"],
                                   rx["llr_scale"])


def _unbatch(res):
    return type(res)(*(
        tuple(p[0] for p in v) if isinstance(v, tuple) else v[0]
        for v in (getattr(res, f.name) for f in dataclasses.fields(res))
    ))


def _checked(hop1, hop2, config, out_layout, device):
    """(hop2, device) after the JAX builders' checks. The builders are not
    cached: a builder holds its mesh's groups, which die with their world."""
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    if out_layout not in ("ref", "factored"):
        raise ValueError(f"out_layout={out_layout!r}: one of 'ref', 'factored'")
    if out_layout == "factored" and config.time_interp != "none":
        raise ValueError("out_layout='factored' requires time_interp='none'")
    dsp.precision_of(config.matmul_precision)
    return hop2, devices.resolve(device)


def build_sp(hop1: HopConfig, hop2: Optional[HopConfig], config: EstimatorConfig, n_layers: int,
             mesh, sp_axis: str = "sp", out_layout: str = "ref", device="cuda") -> ShardedBuilder:
    """Single-problem subcarrier-sharded estimator (the wideband low-latency
    path): fn(rg_ri, pil_ri, beta[, params]) on this rank's blocks ->
    EstimateResult with channel (2, L, n_sym, nL), or with out_layout=
    "factored" a FactoredResult with profiles (2, n_hops, nL, L) and the
    rotation replicated. Numpy inputs go to `device` (the card by default)."""
    hop2, device = _checked(hop1, hop2, config, out_layout, device)
    return ShardedBuilder(make_plan(hop1, hop2, config, n_layers), mesh, sp_axis, None, False,
                          out_layout, "est", device)


def build_sp_batched(hop1: HopConfig, hop2: Optional[HopConfig], config: EstimatorConfig,
                     n_layers: int, mesh, dp_axis: str = "dp", sp_axis: str = "sp",
                     out_layout: str = "ref", device="cuda") -> ShardedBuilder:
    """Batched estimator sharded over problems (dp: each rank takes its slice of
    the batch) and subcarriers (sp): as `build_sp` with a leading problem
    axis on every argument and output."""
    hop2, device = _checked(hop1, hop2, config, out_layout, device)
    return ShardedBuilder(make_plan(hop1, hop2, config, n_layers), mesh, sp_axis, dp_axis, True,
                          out_layout, "est", device)


def build_sp_tracked(hop1: HopConfig, hop2: Optional[HopConfig], config: EstimatorConfig,
                     n_layers: int, mesh, sp_axis: str = "sp", out_layout: str = "ref",
                     device="cuda") -> ShardedBuilder:
    """Subcarrier-sharded estimator with multi-slot tracking:
    fn(rg_ri, pil_ri, beta, h_prev_ri, w) -> (result, h_new_ri, w_new). The
    state is a tuple of per-hop (2, nL, n_re) ri tensors (`tracking.init_state`
    for slot 0), cut to this rank's pilot block on the single-hop route
    (`shard_inputs`), replicated on the hopped one. The tracked result equals
    `tracking.build_tracked_ri`'s."""
    hop2, device = _checked(hop1, hop2, config, out_layout, device)
    _trk.check_config(config)
    return ShardedBuilder(make_plan(hop1, hop2, config, n_layers), mesh, sp_axis, None, False,
                          out_layout, "tracked", device)


def build_sp_receiver(hop1: HopConfig, hop2: Optional[HopConfig], config: EstimatorConfig,
                      n_layers: int, mesh, dp_axis: str = "dp", sp_axis: str = "sp",
                      data_beta: float = 1.0, modulation: Optional[str] = None,
                      llr_scale: float = 8.0, device="cuda") -> ShardedBuilder:
    """Subcarrier-sharded joint multi-RX receiver, batched over dp:
    fn(rg_ri (B, 2, n_rx, L, n_sym), pil_ri, beta (B,)) -> ReceiverResult with
    x (B, 2, nL, n_sym, L) and sinr (B, n_hops, nL, L), or with `modulation`
    an LlrResult. The factored front per port, then the per-subcarrier MMSE
    (and demap): no collective beyond the front's. Requires time_interp=
    "none" and refuses the learned smoothings, as JAX does."""
    if config.time_interp != "none":
        raise ValueError("build_sp_receiver requires time_interp='none'")
    if config.smoothing in ("learned", "learned2d"):
        raise ValueError("learned smoothing on the SP receiver is not wired (as in JAX)")
    if modulation is not None:
        demap.bits_per_symbol(modulation)
    hop2, device = _checked(hop1, hop2, config, "factored", device)
    return ShardedBuilder(make_plan(hop1, hop2, config, n_layers), mesh, sp_axis, dp_axis, True,
                          "factored", "receiver", device,
                          dict(data_beta=float(data_beta), modulation=modulation,
                               llr_scale=float(llr_scale)))
