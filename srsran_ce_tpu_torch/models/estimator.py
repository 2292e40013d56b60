"""Plan-driven estimator of the PyTorch/CUDA port: `srsran_ce_tpu/models/estimator.py`
in torch, batched over a leading problem axis.

The JAX module runs one problem per call and adds the problem axis with
`jax.vmap`; here every function carries it as axis 0 and every reduction stays
per problem (the Frobenius norms, the wiener noise/power means, the CFO pair
sums, the PDP over layers, the TA argmax). Inside, the math is complex
(`torch.complex64` / `complex128`, following the inputs), with each real
operator applied to the real and imaginary parts apart, as in the JAX module;
inputs and outputs cross the API in the ri layout (a leading re/im axis of 2).

The three kernel tiers of the JAX package:

  "xla"          plain torch (the default; float32 or float64 on any device).
  "pallas"       the per-problem front with `_smooth` through K5 (`rc_smooth`)
                 and, in the reference layout, the grid through K6
                 (`fused_fill_rotate`); in the serve layout the deferred route:
                 the "xla" front, then the batched serve fill K2. (The TPU
                 package falls back from that route to a per-problem K2 fill
                 when its VMEM budget is exceeded; the CUDA kernels have no
                 such budget, so every serve plan without time interpolation
                 takes it, and time-interpolated fills are plain on every
                 tier, as in JAX.)
  "pallas_front" the fused front K1 per hop, then K2 (serve) or one matmul per
                 CDM group (factored).

On CUDA tensors the kernels launch (float32 only: a float64 CUDA tensor sent
to a kernel tier raises); on CPU tensors their plain versions run. The plain
products run in IEEE f32 (TF32 off) or f64. `config.matmul_precision` "high"
and "highest" both mean full precision here (`ops/dsp.precision_of`).

Learned smoothing ("learned", "learned2d") runs the denoisers of
`models/denoiser.py` on the `params` passed to the built function (float32
convolutions, as in JAX). Multi-slot tracking (`models/tracking.py`) blends
each hop's pilot estimates with the previous slot's inside `_estimate_impl`
(`h_prev`, `track_w`).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from .. import devices, graphs
from ..config import EstimatorConfig, HopConfig
from ..ops import dsp, mathx
from ..ops.kernels import fill_rotate as _k6
from ..ops.kernels import fill_rotate_serve as _k2
from ..ops.kernels import front as _k1
from ..ops.kernels import front_finish as _finish
from ..ops.kernels import full_f32_matmul
from ..ops.kernels import rc_smooth as _k5
from . import denoiser as _dn
from .plan import EstimatorPlan, HopPlan, make_plan, plan_tensors

_OUT_DTYPES = {None: None, "bfloat16": torch.bfloat16}


@dataclass
class EstimateResult:
    """Outputs of a batch of problems, ri layout. `channel_est_rg` is
    (B, 2, n_sc, n_sym, nL) in the reference layout and (B, 2, nL, n_sym, n_sc)
    in the serve layout; `cfo_hz` is NaN when no hop has two DM-RS symbols."""

    channel_est_rg: torch.Tensor
    noise_est: torch.Tensor
    rsrp: torch.Tensor
    epre: torch.Tensor
    time_alignment: torch.Tensor
    cfo_hz: torch.Tensor


@dataclass
class FactoredResult:
    """Rank-1 factored output (`out_layout="factored"`): the grid is
    profiles[h, l, sc] * sym_rot[sym] over hop h's symbols, zero elsewhere.
    profiles (B, 2, n_hops, nL, n_sc), sym_rot (B, 2, n_sym), in ri layout;
    expand with `reconstruct_factored`."""

    profiles: torch.Tensor
    sym_rot: torch.Tensor
    noise_est: torch.Tensor
    rsrp: torch.Tensor
    epre: torch.Tensor
    time_alignment: torch.Tensor
    cfo_hz: torch.Tensor


def split_ri(x: np.ndarray) -> np.ndarray:
    """Host-side complex -> (2, ...) real-pair conversion."""
    x = np.asarray(x)
    rdt = np.float64 if x.dtype == np.complex128 else np.float32
    return np.stack([x.real.astype(rdt), x.imag.astype(rdt)])


def merge_ri(x_ri: np.ndarray) -> np.ndarray:
    """Host-side (2, ...) real-pair -> complex conversion."""
    x_ri = np.asarray(x_ri)
    cdt = np.complex128 if x_ri.dtype == np.float64 else np.complex64
    out = np.empty(x_ri.shape[1:], cdt)
    out.real = x_ri[0]
    out.imag = x_ri[1]
    return out


def reconstruct_factored(
    profiles: np.ndarray,
    sym_rot: np.ndarray,
    hop1: HopConfig,
    hop2: Optional[HopConfig] = None,
    n_sym: int = 14,
) -> np.ndarray:
    """Expand a FactoredResult to the reference-layout dense grid (host-side).

    profiles: (..., n_hops, n_layers, n_sc) complex; sym_rot: (..., n_sym)
    complex (use merge_ri first on ri arrays). Returns (..., n_sc, n_sym,
    n_layers)."""
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    hop_cfgs = [hop1] + ([hop2] if hop2 is not None else [])
    profiles = np.asarray(profiles)
    sym_rot = np.asarray(sym_rot)
    *lead, n_hops, nL, n_sc = profiles.shape
    if n_hops != len(hop_cfgs):
        raise ValueError(f"profiles carry {n_hops} hops, the configs {len(hop_cfgs)}")
    grid = np.zeros((*lead, n_sc, n_sym, nL), dtype=profiles.dtype)
    for h, hc in enumerate(hop_cfgs):
        s0, s1 = hc.start_symbol, hc.start_symbol + hc.n_allocated_symbols
        prof = np.moveaxis(profiles[..., h, :, :], -2, -1)  # (..., n_sc, nL)
        grid[..., :, s0:s1, :] = prof[..., :, None, :] * sym_rot[..., None, s0:s1, None]
    return grid


def _ri_to_complex(x_ri: torch.Tensor) -> torch.Tensor:
    """(B, 2, ...) real -> (B, ...) complex."""
    return torch.complex(x_ri[:, 0], x_ri[:, 1])


def _complex_to_ri(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) complex -> (B, 2, ...) real."""
    return torch.stack([x.real, x.imag], dim=1)


def result_to_ri(res):
    """The result with every complex field in ri layout (the factored profiles
    and rotation; the grids are born in ri layout)."""
    values = (getattr(res, f.name) for f in fields(res))
    return type(res)(*(_complex_to_ri(v) if v.is_complex() else v for v in values))


# ---------------------------------------------------------------------------
# Eligibility of the kernel routes
# ---------------------------------------------------------------------------


def _serve_pallas_deferred_ok(plan: EstimatorPlan) -> bool:
    """True when the batched serve fill (K2) covers the plan: a rank-1-in-time
    fill (no time interpolation) with an interpolation or inpainting operator
    for every CDM group. (The TPU gate's 12 MB VMEM budget has no counterpart:
    the CUDA kernel streams the operator from L2 in chunks of any size.)"""
    for hp in (plan.hop1, plan.hop2):
        if hp is None:
            continue
        if hp.time_interp_mat is not None:
            return False
        if plan.config.interp == "linear" and hp.interp_matrix is None:
            return False
        if plan.config.interp == "cnn" and hp.inpaint_schedules is None:
            return False
    return True


def _front_banded(hp: HopPlan) -> bool:
    """True when K1 can smooth the hop on its banded route: 'filter'
    smoothing, from the plan's raised-cosine taps, at any band."""
    return hp.smoothing == "filter" and hp.rc_taps is not None


def _front_pallas_ok(plan: EstimatorPlan) -> bool:
    """True when the fused front kernel (K1) covers the plan: 'filter'
    smoothing (no alpha blend) on K1's banded route (`_front_banded`), the
    first-pair CFO estimator, no time interpolation, the paired CDM layer
    layout, the direct-DFT TA path, an interpolation or inpainting operator for the fill,
    and a launch of the kernel for the hop's shape (`front.launch_plan`, the
    plan the kernel's wrapper launches; whether one exists does not depend on
    the batch or the card)."""
    config = plan.config
    if config.time_interp != "none" or config.cnn_alpha > 0.0:
        return False
    if config.smoothing != "filter":
        return False
    nL = plan.n_layers
    if nL > _k1._MAX_LAYERS:
        return False
    for hp in (plan.hop1, plan.hop2):
        if hp is None:
            continue
        if not _front_banded(hp) or hp.cfo_pair_dt is not None:
            return False
        if hp.vp_matrix is None and hp.n_pils != 1:
            return False
        if hp.ta_dft_cos is None:
            return False
        if config.interp == "linear" and hp.interp_matrix is None:
            return False
        if config.interp == "cnn" and hp.inpaint_schedules is None:
            return False
        if hp.layer_slices != tuple((2 * c, min(2 * c + 2, nL)) for c in range(hp.n_cdm)):
            return False
        if hp.n_pils > _k1._MAX_PILS or hp.n_dsym > _k1._MAX_DSYM:
            return False
        try:
            _k1.launch_plan(1, hp.n_re, nL, hp.n_pils, hp.half_cp_len,
                            hp.ta_dft_cos.shape[0], _k1.NOMINAL_CAPS, hp.rc_taps.size)
        except ValueError:
            return False
    return True


def _front_mats(hp: HopPlan) -> dict:
    """Static arrays of the fused front kernel: the raised-cosine taps, which
    stand in for the TPU kernel's five smoothing matrices (the plan's fused
    operator holds the same filter), `vp`, the fit matrix itself (v = vp @ y;
    a (1, 1) zero stands in when n_pils == 1, no fit), and the TA DFT."""
    vp = hp.vp_matrix if hp.vp_matrix is not None else np.zeros((1, 1))
    return dict(taps=hp.rc_taps, vp=vp, ta_c=hp.ta_dft_cos, ta_s=hp.ta_dft_sin)


def _gather_rx(hp: HopPlan, ht: dict, rg: torch.Tensor) -> torch.Tensor:
    """The hop's received pilot REs, time-major: (..., n_cdm, n_dsym, n_re)
    from a grid (..., n_sc, n_sym) — ri (B, 2, n_sc, n_sym) or complex
    (B, n_sc, n_sym) (`ops.kernels.front.gather_rx` with the hop's tables)."""
    return _k1.gather_rx(rg, ht["re_idx"], ht["dmrs_sym_idx"], hp.n_cdm)


# ---------------------------------------------------------------------------
# Smoothing
# ---------------------------------------------------------------------------


def _virtual_pilots(h: torch.Tensor, vp: Optional[torch.Tensor], n_pils: int) -> torch.Tensor:
    """Extrapolate n_pils virtual pilots to the left of h[..., :n_pils]: the
    linear LS fit of modulus and unwrapped phase as two matmuls with the static
    fit matrix `vp` (v = vp @ y; ce_rule_baseline.py:69-140). Pass a flipped
    tail to extrapolate past the right edge."""
    if n_pils == 1 or vp is None:
        # n==1 fit degenerates; the reference extrapolates the constant value
        return h[..., :1].expand(h.shape[:-1] + (n_pils,))
    m = vp.transpose(0, 1)
    v_amp = torch.matmul(h.abs(), m)
    v_ph = torch.matmul(dsp.unwrap_phase(torch.angle(h)), m)
    return v_amp * torch.exp(1j * v_ph)


def _use_fused_smooth(hp: HopPlan, kernels: str) -> bool:
    """True when the filter chain runs as the fused plan matrices (XLA tier):
    the CDM pair-average is then folded into the matrices and _process_hop
    must NOT apply it explicitly."""
    return kernels == "xla" and hp.smoothing == "filter" and hp.smooth_mat is not None


def _cmm(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Complex rows times a real matrix, one real product per part."""
    return torch.complex(torch.matmul(x.real, m), torch.matmul(x.imag, m))


def _smooth_fused(ht: dict, hp: HopPlan, h_p: torch.Tensor) -> torch.Tensor:
    """Fused filter smoothing: pair-average + RC conv (+ alpha blend) as plan
    matrices, only the virtual-pilot fit nonlinear. h_p: (B, R, n_re) RAW (before
    the pair-average). The JAX function pins these products to HIGHEST; the
    port runs every product at full precision anyway."""
    fm = ht["fused"]
    n_pils = hp.n_pils
    e_l = _cmm(h_p, fm["pair_l"])  # == h_avg[..., :n_pils]
    e_r = _cmm(h_p, fm["pair_r"])
    vb = _virtual_pilots(e_l, ht["vp"], n_pils)
    ve = _virtual_pilots(torch.flip(e_r, dims=(-1,)), ht["vp"], n_pils)
    return (
        _cmm(h_p, fm["smooth"])
        + _cmm(vb, fm["smooth_vb"])
        + _cmm(torch.flip(ve, dims=(-1,)), fm["smooth_ve"])
    )


def _smooth_wiener(ht: dict, hp: HopPlan, h_p: torch.Tensor) -> torch.Tensor:
    """MMSE-optimal linear smoothing (smoothing="wiener"): the noise level from
    adjacent pilot differences and the channel power from the total, each per
    problem over all of its rows, then h_s = U diag(lam / (lam + sigma^2/P)) U^H h.
    h_p: (B, R, n_re) pair-averaged pilot estimates."""
    if ht["wiener"] is None:
        return h_p  # degenerate (<2-point) pilot lattice: pass-through
    u_r, u_i, lam = ht["wiener"]
    h_d = h_p[..., ::2] if hp.wiener_paired else h_p
    per_problem = tuple(range(1, h_d.dim()))
    d = h_d[..., 1:] - h_d[..., :-1]
    sig2 = torch.mean(d.real**2 + d.imag**2, dim=per_problem) / 2.0
    sig2 = sig2.clamp_min(1e-20)
    pwr = torch.mean(h_d.real**2 + h_d.imag**2, dim=per_problem)
    p_hat = (pwr - sig2).clamp_min(1e-20)
    hr, hi = h_d.real, h_d.imag
    zr = torch.matmul(hr, u_r) + torch.matmul(hi, u_i)  # z = h @ conj(U)
    zi = torch.matmul(hi, u_r) - torch.matmul(hr, u_i)
    g = lam / (lam + (sig2 / p_hat)[:, None])  # (B, m)
    g = g.reshape(g.shape[:1] + (1,) * (h_d.dim() - 2) + g.shape[1:])
    zr = zr * g
    zi = zi * g
    o_r = torch.matmul(zr, u_r.T) - torch.matmul(zi, u_i.T)  # h_s = z @ U^T
    o_i = torch.matmul(zr, u_i.T) + torch.matmul(zi, u_r.T)
    out = torch.complex(o_r, o_i)
    if hp.wiener_paired:
        out = out.repeat_interleave(2, dim=-1)
    return out


def _smooth(
    hp: HopPlan, ht: dict, config: EstimatorConfig, h_p: torch.Tensor, kernels: str = "xla",
    params=None,
) -> torch.Tensor:
    """Frequency-domain smoothing switch (ce_rule_baseline.py:645-680; CNN alpha
    blend from ce_dl_cnn.py:690-717; "learned" through models/denoiser.py with
    `params`). h_p: (B, R, n_re) — RAW when _use_fused_smooth (the pair-average
    lives in the fused matrices), pair-averaged otherwise. With
    kernels="pallas" the RC filter is K5."""
    smoothing = hp.smoothing
    if smoothing == "none":
        return h_p
    if smoothing == "learned":
        return _dn.apply_complex(params, h_p)
    if smoothing == "mean":
        return h_p.mean(dim=-1, keepdim=True).expand_as(h_p)
    if smoothing == "wiener":
        return _smooth_wiener(ht, hp, h_p)
    if _use_fused_smooth(hp, kernels):
        return _smooth_fused(ht, hp, h_p)
    n_pils = hp.n_pils
    v_begin = _virtual_pilots(h_p[..., :n_pils], ht["vp"], n_pils)
    tail_rev = torch.flip(h_p[..., -n_pils:], dims=(-1,))
    v_end = _virtual_pilots(tail_rev, ht["vp"], n_pils)
    x_ext = torch.cat([v_begin, h_p, torch.flip(v_end, dims=(-1,))], dim=-1)
    K = hp.rc_taps.size
    hw = (K - 1) // 2
    if kernels == "pallas":
        R = h_p.shape[1]
        # the valid convolution of K5 keeps n_re outputs when each side carries
        # exactly hw samples: zero padding beyond the virtual pilots when
        # hw > n_pils (stride-1 filters), the outer virtual pilots cut when
        # hw < n_pils (a 1-PRB band; the JAX package omits this cut and fails
        # there, ROADMAP.md queue 3)
        d = hw - n_pils
        if d > 0:
            x_ext = dsp._pad_last(x_ext, d, d)
        elif d < 0:
            x_ext = x_ext[..., -d : x_ext.shape[-1] + d]
        xr = torch.cat([x_ext.real, x_ext.imag], dim=1).contiguous()  # (B, 2R, n_ext)
        y = _k5.rc_smooth(xr, hp.rc_taps)
        out = torch.complex(y[:, :R], y[:, R:])
    else:
        y = dsp.conv_same_zero(x_ext, hp.rc_taps)
        out = y[..., n_pils : y.shape[-1] - n_pils]
    if config.cnn_alpha > 0.0:
        alpha = min(1.0, max(0.0, config.cnn_alpha))
        out = out + alpha * (dsp.cnn_lowpass(out, passes=1) - out)
    return out


# ---------------------------------------------------------------------------
# Grid fill
# ---------------------------------------------------------------------------


def _grid_fill(
    hp: HopPlan, ht: dict, config: EstimatorConfig, h_p: torch.Tensor, rows_per_layer: int = 1
) -> torch.Tensor:
    """Interpolate pilot-position estimates to every subcarrier of the hop band:
    (B, nL * rows_per_layer, n_re) -> (B, nL * rows_per_layer, n_sc_hop).

    Linear: one matmul with the interpolation matrix per CDM group (the plan
    always builds it, so the JAX function's gather fallback has no caller
    here). CNN: the precomputed inpainting operator when the chain is deep
    (> 16 iterations), else the partial-conv chain itself
    (ce_dl_cnn.py:473-508).
    rows_per_layer > 1: h_p packs (layer, dmrs_sym) layer-major (time
    interpolation). The JAX function's precision argument has no counterpart:
    every product here runs at full precision."""
    outs = []
    for c, (l0, l1) in enumerate(hp.layer_slices):
        vals = h_p[:, l0 * rows_per_layer : l1 * rows_per_layer]
        if config.interp == "linear":
            full = dsp.inpaint_matmul(vals, ht["interp"][c])
        else:  # "cnn"
            transient, steady = hp.inpaint_schedules[c]
            if len(transient) + steady > dsp.INPAINT_CHAIN_MAX_ITERS:
                full = dsp.inpaint_matmul(vals, ht["interp"][c])
            else:
                filled, consts = ht["inpaint"][c]
                sparse = vals.new_zeros(vals.shape[:-1] + (hp.n_sc_hop,))
                sparse[..., filled] = vals
                full = dsp.cnn_inpaint(sparse, hp.inpaint_known[c], 0,
                                       schedule=hp.inpaint_schedules[c], consts=consts)
        outs.append(full)
    return torch.cat(outs, dim=1)


def _grid_fill_rotate_pallas(
    hp: HopPlan, ht: dict, h_p: torch.Tensor, rot_slice: torch.Tensor, channel: torch.Tensor
) -> None:
    """Reference-layout fill through K6: interp-operator matmul + symbol
    broadcast + CFO rotation, every CDM group in one launch, written straight
    into the hop's block of the ri grid `channel` (B, 2, n_sc, n_sym, nL).

    h_p: (B, nL, n_re) complex; rot_slice: (B, n_alloc) complex. The TPU
    function's 6 MB operator guard (VMEM) is dropped: the kernel takes any
    size."""
    _k6.fused_fill_rotate(
        _complex_to_ri(h_p).contiguous(), ht["interp"], _complex_to_ri(rot_slice).contiguous(),
        hp.layer_slices, out=channel, sc_start=hp.sc_start, sym_start=hp.sym_start,
    )


def _serve_fill_pallas_batched(
    plan: EstimatorPlan,
    pt: dict,
    h_ps_ri,  # tuple per hop of (B, 2, n_layers, n_re) real
    rot_ri: torch.Tensor,  # (B, 2, n_sym) real
    n_sc: int,
    n_sym: int,
    out_dtype=None,
) -> torch.Tensor:
    """Batched serve-layout grid assembly: one K2 launch per hop over the whole
    problem batch and every CDM group. Returns (B, 2, n_layers, n_sym, n_sc)
    in `out_dtype` (a torch dtype; None keeps the inputs' dtype), cast before
    the placement into the zero grid."""
    B = rot_ri.shape[0]
    gdtype = h_ps_ri[0].dtype if out_dtype is None else out_dtype
    hops = [plan.hop1] + ([plan.hop2] if plan.hop2 is not None else [])
    channel = None
    for hp, ht, h_ri in zip(hops, pt["hops"], h_ps_ri):
        rot_slice = rot_ri[:, :, hp.sym_start : hp.sym_start + hp.n_alloc_syms].contiguous()
        blk = _k2.fused_fill_rotate_serve(
            h_ri.contiguous(), ht["interp"], rot_slice, layer_slices=hp.layer_slices
        )  # (B, 2, nL, n_alloc, n_sc_hop)
        if blk.dtype != gdtype:
            blk = blk.to(gdtype)
        if (
            len(hops) == 1 and hp.sc_start == 0 and hp.n_sc_hop == n_sc
            and hp.sym_start == 0 and hp.n_alloc_syms == n_sym
        ):
            return blk  # the hop covers the grid: no zero-grid pass
        if channel is None:
            channel = blk.new_zeros((B, 2, plan.n_layers, n_sym, n_sc))
        channel[
            :, :, :, hp.sym_start : hp.sym_start + hp.n_alloc_syms,
            hp.sc_start : hp.sc_start + hp.n_sc_hop,
        ] = blk
    return channel


def _serve_fill_xla_ri(
    hp: HopPlan, ht: dict, h_p: torch.Tensor, rot_slice: torch.Tensor
) -> torch.Tensor:
    """Serve fill in explicit real (ri) arithmetic: (B, 2, nL, n_alloc, n_sc_hop).
    The route of out_dtype="bfloat16": the block is cast before the grid write.
    h_p: (B, nL, n_re) complex; rot_slice: (B, n_alloc) complex. The JAX
    function's gather fallback serves plans without an interpolation or
    inpainting operator, which the plan always builds."""
    w = ht["interp"]
    parts = [h_p[:, l0:l1] for l0, l1 in hp.layer_slices]
    fr = torch.cat([torch.matmul(v.real, w[c]) for c, v in enumerate(parts)], dim=1)[:, :, None, :]
    fi = torch.cat([torch.matmul(v.imag, w[c]) for c, v in enumerate(parts)], dim=1)[:, :, None, :]
    rr = rot_slice.real[:, None, :, None]  # (B, 1, n_alloc, 1)
    ri = rot_slice.imag[:, None, :, None]
    return torch.stack([fr * rr - fi * ri, fr * ri + fi * rr], dim=1)


def _write_block(channel: torch.Tensor, block: torch.Tensor, index: tuple) -> None:
    """channel[b, :, *index] = block for an ri grid (B, 2, ...): a complex block
    (B, ...) goes in as its two parts, an ri block (B, 2, ...) as it is; the
    assignment casts to the grid's dtype."""
    if block.is_complex():
        channel[(slice(None), 0) + index] = block.real
        channel[(slice(None), 1) + index] = block.imag
    else:
        channel[(slice(None), slice(None)) + index] = block


# ---------------------------------------------------------------------------
# Per-hop front and the whole estimator
# ---------------------------------------------------------------------------


def _pair_average(h: torch.Tensor) -> torch.Tensor:
    """CDM interference removal: adjacent-RE pair average along the last axis
    (ce_rule_baseline.py:632-640); an odd last RE stays as it is."""
    m = h.shape[-1] // 2
    pairs = h[..., : 2 * m].reshape(h.shape[:-1] + (m, 2))
    avg = pairs.mean(dim=-1, keepdim=True).expand(h.shape[:-1] + (m, 2))
    return torch.cat([avg.reshape(h.shape[:-1] + (2 * m,)), h[..., 2 * m :]], dim=-1)


def _process_hop(
    hp: HopPlan,
    ht: dict,
    config: EstimatorConfig,
    received_rg: torch.Tensor,  # (B, n_sc, n_sym) complex
    pilots_h: torch.Tensor,  # (B, n_re, n_dsym, n_layers) complex
    beta: torch.Tensor,  # (B,) real
    sst_d: Optional[torch.Tensor],  # (n_dsym,) DM-RS symbol start times, None without CFO compensation
    kernels: str = "xla",
    params=None,
):
    """One hop for a batch of problems (reference process_hop,
    ce_rule_baseline.py:507-755).

    Returns (epre_inc, cfo_hop | None, ta_inc, noise_inc, rsrp_inc, h_p, h_t,
    h_pre): per-problem (B,) scalars, the smoothed pilot estimates h_p
    (B, nL, n_re), with time interpolation the per-DM-RS-symbol estimates h_t
    (B, nL * n_dsym, n_re) (else None), and h_pre, the estimates before
    smoothing that multi-slot tracking blends: RAW when the fused smoothing
    matrices run (they hold the CDM pair average), pair-averaged otherwise."""
    rdtype = received_rg.real.dtype
    B = received_rg.shape[0]
    nL = hp.n_layers
    nd = hp.n_dsym

    # --- Pilot RE gather + LS de-spread (ce_rule_baseline.py:583-605) ---
    rx = _gather_rx(hp, ht, received_rg)  # (B, n_cdm, n_dsym, n_re)
    epre_inc = dsp.fro_norm_sq(rx, batch_dims=1)
    rx_l = rx.repeat_interleave(2, dim=1)[:, :nL]  # layer l reads CDM group l // 2: (B, nL, n_dsym, n_re)
    pil_l = pilots_h.permute(0, 3, 2, 1)  # (B, nL, n_dsym, n_re)
    rec_x = rx_l * torch.conj(pil_l)

    # --- CFO estimate / compensation (ce_rule_baseline.py:363-463) ---
    cfo_hop = None
    rec_x_nocfo = rec_x
    if hp.cfo_possible:
        if hp.cfo_pair_dt is not None:
            # WLS phase-slope fit over all consecutive DM-RS pairs
            # (config.cfo_estimator="wls"), magnitude weights
            num = torch.zeros(B, dtype=rdtype, device=rx.device)
            den = torch.zeros(B, dtype=rdtype, device=rx.device)
            for j in range(nd - 1):
                inner = torch.sum(torch.conj(rec_x[:, :, j]) * rec_x[:, :, j + 1], dim=-1)  # (B, nL)
                dt = float(hp.cfo_pair_dt[j])
                for c in range(hp.n_cdm):
                    pair = inner[:, 2 * c] + (inner[:, 2 * c + 1] if 2 * c + 1 < nL else 0.0)
                    num = num + pair.abs() * dt * torch.angle(pair)
                    den = den + pair.abs() * dt * dt
            cfo_hop = num / (2.0 * math.pi * den.clamp_min(1e-30))
        else:
            inner = torch.sum(torch.conj(rec_x[:, :, 0]) * rec_x[:, :, 1], dim=-1)  # (B, nL)
            acc = torch.zeros(B, dtype=rdtype, device=rx.device)
            for c in range(hp.n_cdm):
                pair = inner[:, 2 * c] + (inner[:, 2 * c + 1] if 2 * c + 1 < nL else 0.0)
                acc = acc + torch.angle(pair)
            cfo_hop = acc / (2.0 * math.pi * hp.n_samples) / hp.n_cdm
        if config.cfo_compensate:
            rot = torch.exp(-1j * (2.0 * math.pi * sst_d[None, :] * cfo_hop[:, None]))  # (B, nd)
            rec_x_nocfo = rec_x * rot[:, None, :, None]

    # --- Time average (ce_rule_baseline.py:625) ---
    h_p = torch.sum(rec_x_nocfo, dim=2) / beta[:, None, None] / nd  # (B, nL, n_re)

    # --- CDM pair average, folded into the fused smoothing matrices when they run ---
    fused = _use_fused_smooth(hp, kernels)
    if nL >= 2 and not fused:
        h_p = _pair_average(h_p)

    # --- Smoothing (ce_rule_baseline.py:645-680) ---
    h_pre = h_p
    if hp.smoothing == "learned2d":
        # the 2-D denoiser sees the time-averaged profile as a one-symbol grid
        h_p = _dn.apply_complex_2d(params, h_p[:, :, None, :])[:, :, 0, :]
    else:
        h_p = _smooth(hp, ht, config, h_p, kernels, params)

    # --- Per-DM-RS-symbol estimates for time interpolation, rows (layer, dmrs_sym) ---
    h_t = None
    if hp.time_interp_mat is not None:
        ht_rows = (rec_x_nocfo / beta[:, None, None, None]).reshape(B, nL * nd, hp.n_re)
        if nL >= 2 and not fused:
            ht_rows = _pair_average(ht_rows)
        if hp.smoothing == "learned2d":
            h_t = _dn.apply_complex_2d(params, ht_rows.reshape(B, nL, nd, hp.n_re))
            h_t = h_t.reshape(B, nL * nd, hp.n_re)
        else:
            h_t = _smooth(hp, ht, config, ht_rows, kernels, params)

    # --- Time alignment from the power-delay profile (ce_rule_baseline.py:684-710) ---
    hcl = hp.half_cp_len
    k = hp.ta_scatter_idx.size
    if ht["ta"] is not None:
        # direct DFT on only the +-half_cp_len bins that feed the argmax
        C, S = ht["ta"]
        hr, hi = h_p.real[..., :k], h_p.imag[..., :k]
        re = torch.matmul(hr, C) - torch.matmul(hi, S)  # (B, nL, 2*hcl)
        im = torch.matmul(hr, S) + torch.matmul(hi, C)
        pdp = torch.sum(re**2 + im**2, dim=1)  # (B, 2*hcl)
        head, tail = pdp[:, :hcl], pdp[:, hcl:]
    else:
        z = h_p.new_zeros((B, hp.fft_size, nL))
        z[:, ht["ta_idx"], :] = h_p[..., :k].transpose(1, 2)
        pdp = torch.sum(torch.fft.ifft(z, dim=1).abs() ** 2, dim=2)  # (B, fft_size)
        head, tail = pdp[:, :hcl], pdp[:, -hcl:]
    i_delay = mathx.argmax_last(head)
    i_adv = mathx.argmax_last(tail)
    i_max = torch.where(
        head.gather(1, i_delay[:, None])[:, 0] >= tail.gather(1, i_adv[:, None])[:, 0],
        i_delay.to(rdtype),
        -(hcl - i_adv).to(rdtype),
    )
    ta_inc = i_max / float(hp.fft_size) / float(config.scs_hz)

    # --- Reconstruct expected RX pilots; noise / RSRP (ce_rule_baseline.py:713-746) ---
    if config.cfo_compensate and cfo_hop is not None:
        ph = torch.exp(1j * (2.0 * math.pi * sst_d[None, :] * cfo_hop[:, None]))  # (B, nd)
        h_ph = h_p[:, :, None, :] * ph[:, None, :, None]
    else:
        h_ph = h_p[:, :, None, :]
    contrib = beta[:, None, None, None] * pil_l * h_ph  # (B, nL, nd, n_re)
    est_rx = torch.stack([contrib[:, l0:l1].sum(dim=1) for l0, l1 in hp.layer_slices], dim=1)
    noise_inc = dsp.fro_norm_sq(rx - est_rx, batch_dims=1)
    rsrp_inc = beta**2 * dsp.fro_norm_sq(h_p, batch_dims=1) * nd
    return epre_inc, cfo_hop, ta_inc, noise_inc, rsrp_inc, h_p, h_t, h_pre


def _estimate_impl(
    plan: EstimatorPlan,
    pt: dict,
    received_rg: torch.Tensor,  # (B, n_sc, n_sym) complex
    pilots: torch.Tensor,  # (B, n_re, n_dsym_total, n_layers) complex
    beta: torch.Tensor,  # (B,) real
    kernels: str = "xla",
    out_layout: str = "ref",
    out_dtype=None,
    h_prev=None,
    track_w=None,
    defer_fill: bool = False,
    params=None,
):
    """The estimator over a batch of problems. `pt` holds the plan's tensors
    (`plan_tensors`) on the inputs' device and dtype; `out_dtype` is a torch
    dtype for the serve grid (None keeps the inputs' real dtype); `params`
    the denoiser's (learned smoothing).

    Returns an EstimateResult / FactoredResult in ri layout; with defer_fill
    (serve only, no time interpolation) the per-hop smoothed profiles
    (B, 2, nL, n_re), the CFO rotation (B, 2, n_sym) and the scalars instead,
    for the batched K2 fill.

    h_prev / track_w: the multi-slot tracking state (models/tracking.py), a
    tuple of per-hop complex (B, nL, n_re) pilot estimates and the (B,)
    weights. Each hop's estimate is then blended with its predecessor by a
    per-problem adaptive gain before the re-smooth and the fill, and the call
    returns (result, (blended estimates, w_new)). The scalar metrics stay
    single-slot (reference parity)."""
    tracked = h_prev is not None
    if tracked != (track_w is not None):
        raise ValueError("tracking needs both h_prev and track_w")
    if tracked and defer_fill:
        raise ValueError("defer_fill does not take a tracking state")
    if out_layout not in ("ref", "serve", "factored"):
        raise ValueError(f"out_layout {out_layout!r}")
    if out_dtype is not None and out_layout != "serve":
        raise ValueError("out_dtype requires the serve layout")
    rdtype = received_rg.real.dtype
    config = plan.config
    nL = plan.n_layers
    B, n_sc, n_sym = received_rg.shape
    beta = beta.to(rdtype)
    sst = pt["sst"]
    hops = [(plan.hop1, pt["hops"][0], pilots[:, :, : plan.n_dsym1])]
    if plan.hop2 is not None:
        hops.append((plan.hop2, pt["hops"][1], pilots[:, :, plan.n_dsym1 :]))

    zeros = torch.zeros(B, dtype=rdtype, device=received_rg.device)
    epre, noise, rsrp, ta = zeros, zeros, zeros, zeros
    cfo = None
    h_ps, h_ts, h_pres, cfo_hs = [], [], [], []
    for hp, ht, pil in hops:
        sst_d = None if sst is None else sst[ht["dmrs_sym_idx"]]
        e_i, cfo_h, ta_i, n_i, r_i, h_p, h_t, h_pre = _process_hop(
            hp, ht, config, received_rg, pil, beta, sst_d, kernels, params
        )
        epre = epre + e_i
        noise = noise + n_i
        rsrp = rsrp + r_i
        ta = ta + ta_i
        if cfo_h is not None:
            # reference combine rule (ce_rule_baseline.py:617-621)
            cfo = cfo_h if cfo is None else (cfo + cfo_h) / 2.0
        h_ps.append(h_p)
        h_ts.append(h_t)
        h_pres.append(h_pre)
        cfo_hs.append(cfo_h)

    track_out = None
    if tracked:
        if len(h_prev) != len(hops):
            raise ValueError(f"h_prev holds {len(h_prev)} hops, the plan {len(hops)}")
        if any(h_t is not None for h_t in h_ts):
            raise ValueError("tracking requires time_interp='none'")
        h_ps, track_out = _track_blend(
            plan, [(hp, ht) for hp, ht, _ in hops], h_pres, cfo_hs, h_prev,
            track_w.to(rdtype), kernels, params,
        )

    # --- Normalization (ce_rule_baseline.py:914-935) ---
    rsrp = rsrp / plan.n_pilots / nL
    epre = epre / plan.n_pilots
    noise = noise / plan.noise_den
    if plan.hop2 is not None:
        ta = ta / 2.0
    cfo_hz = cfo * config.scs_hz if cfo is not None else torch.full_like(zeros, math.nan)

    # --- Grid-wide CFO rotation (ce_rule_baseline.py:938-945), folded into the
    # hop-block writes (the grid is zero outside the hop allocations) ---
    if config.cfo_compensate and cfo is not None:
        if n_sym != sst.shape[0]:
            raise ValueError(f"the CFO grid rotation assumes a {sst.shape[0]}-symbol slot")
        rot = torch.exp(1j * (2.0 * math.pi * sst[None, :] * cfo[:, None]))  # (B, n_sym)
    else:
        rot = torch.ones((B, n_sym), dtype=received_rg.dtype, device=received_rg.device)

    if defer_fill:
        if out_layout != "serve" or any(h_t is not None for h_t in h_ts):
            raise ValueError("defer_fill requires the serve layout and time_interp='none'")
        return (
            tuple(_complex_to_ri(h_p) for h_p in h_ps), _complex_to_ri(rot),
            noise, rsrp, epre, ta, cfo_hz,
        )

    if out_layout == "factored":
        if any(h_t is not None for h_t in h_ts):
            raise ValueError("out_layout='factored' requires time_interp='none'")
        profiles = received_rg.new_zeros((B, len(hops), nL, n_sc))
        for h, ((hp, ht, _), h_p) in enumerate(zip(hops, h_ps)):
            profiles[:, h, :, hp.sc_start : hp.sc_start + hp.n_sc_hop] = _grid_fill(hp, ht, config, h_p)
        res = result_to_ri(FactoredResult(profiles, rot, noise, rsrp, epre, ta, cfo_hz))
        return res if track_out is None else (res, track_out)

    serve = out_layout == "serve"
    grid_shape = (nL, n_sym, n_sc) if serve else (n_sc, n_sym, nL)
    channel = torch.zeros(
        (B, 2) + grid_shape, dtype=out_dtype or rdtype, device=received_rg.device
    )
    for (hp, ht, _), h_p, h_t in zip(hops, h_ps, h_ts):
        syms = slice(hp.sym_start, hp.sym_start + hp.n_alloc_syms)
        scs = slice(hp.sc_start, hp.sc_start + hp.n_sc_hop)
        at = (slice(None), syms, scs) if serve else (scs, syms, slice(None))
        rot_slice = rot[:, syms]
        if h_t is not None:
            # time-interpolated fill: per-DM-RS-symbol profiles combined with the
            # static (n_dsym, n_alloc) weights, then rotated (plain on every tier)
            ft = _grid_fill(hp, ht, config, h_t, rows_per_layer=hp.n_dsym)
            ft = ft.reshape(B, nL, hp.n_dsym, hp.n_sc_hop)
            mm = lambda a: torch.einsum("blds,dt->blts", a, ht["time_interp_t"])
            block = torch.complex(mm(ft.real), mm(ft.imag)) * rot_slice[:, None, :, None]
            _write_block(channel, block if serve else block.permute(0, 3, 2, 1), at)
        elif serve and out_dtype is not None:
            _write_block(channel, _serve_fill_xla_ri(hp, ht, h_p, rot_slice), at)
        elif serve and kernels == "pallas":
            # the JAX tier's per-problem K2 fill (estimator.py:1155-1156), every
            # problem of the batch in one launch; the receiver's route (the
            # BatchedEstimator takes the deferred fill instead)
            blk = _k2.fused_fill_rotate_serve(
                _complex_to_ri(h_p).contiguous(), ht["interp"],
                _complex_to_ri(rot_slice).contiguous(), layer_slices=hp.layer_slices,
            )  # (B, 2, nL, n_alloc, n_sc_hop)
            _write_block(channel, blk, at)
        elif serve:
            full = _grid_fill(hp, ht, config, h_p)  # (B, nL, n_sc_hop)
            _write_block(channel, full[:, :, None, :] * rot_slice[:, None, :, None], at)
        elif kernels == "pallas":
            _grid_fill_rotate_pallas(hp, ht, h_p, rot_slice, channel)
        else:
            full = _grid_fill(hp, ht, config, h_p)
            block = full.transpose(1, 2)[:, :, None, :] * rot_slice[:, None, :, None]
            _write_block(channel, block, at)  # (B, n_sc_hop, n_alloc, nL)
    res = EstimateResult(channel, noise, rsrp, epre, ta, cfo_hz)
    return res if track_out is None else (res, track_out)


def _track_blend(plan, hops, h_pres, cfo_hs, h_prev, w, kernels, params):
    """The multi-slot tracking blend (no reference counterpart), per problem.

    Each hop's pre-smoothing estimate is phase-anchored first: with CFO
    compensation on, this slot's pilot average carries the phase
    exp(-j 2 pi t_bar cfo_hat) of its own CFO estimate at the DM-RS-symbol
    centroid t_bar, consistent within the slot but not across slots, so the
    tracked state lives in the anchor-free domain: the estimate is multiplied
    by exp(+j 2 pi t_bar cfo_hat) before the blend and by its conjugate before
    the re-smooth. The gain pools two statistics over
    the hops: sig2, the observation noise proxy from adjacent pilot
    differences, and innov, the mean distance to the tracked state. The gain
    is 1 on the first slot (w < 0.5), the running average 1/(w+1) on a static
    channel, and snaps toward 1 when innov exceeds 2 sig2 (the channel
    moved). Returns the re-smoothed estimates in this slot's convention and
    (the blended state, w_new = min(1/max(a, 1e-3), 64))."""
    config = plan.config
    sst = plan.symbol_start_time
    anchors = []
    for (hp, _), cfo_h in zip(hops, cfo_hs):
        if config.cfo_compensate and cfo_h is not None:
            t_bar = float(np.mean(sst[hp.dmrs_sym_idx]))
            anchors.append(torch.exp(1j * (2.0 * math.pi * t_bar) * cfo_h)[:, None, None])
        else:
            anchors.append(None)
    h_obs = [h if an is None else h * an for h, an in zip(h_pres, anchors)]
    sig2 = innov = 0.0
    n_s = n_i = 0
    for h_ob, h_pr in zip(h_obs, h_prev):
        d = h_ob[..., 1:] - h_ob[..., :-1]
        sig2 = sig2 + (d.real**2 + d.imag**2).sum(dim=(1, 2)) / 2.0
        e = h_ob - h_pr
        innov = innov + (e.real**2 + e.imag**2).sum(dim=(1, 2))
        n_s += d[0].numel()
        n_i += e[0].numel()
    sig2 = (sig2 / max(n_s, 1)).clamp_min(1e-30)
    innov = (innov / max(n_i, 1)).clamp_min(1e-30)
    a_static = 1.0 / (w + 1.0)
    # static channel: innov ~ sig2 (1 + 1/w), so a_move clips to 0 and the
    # running average rules; a moved channel pushes innov >> 2 sig2
    a_move = torch.clamp(1.0 - 2.0 * sig2 / innov, 0.0, 1.0)
    a = torch.where(w < 0.5, torch.ones_like(w), torch.maximum(a_static, a_move))
    a_c = a[:, None, None]
    h_blend = [h_pr + a_c * (h_ob - h_pr) for h_ob, h_pr in zip(h_obs, h_prev)]
    h_ps = [
        _smooth(hp, ht, config, h_b if an is None else h_b * torch.conj(an), kernels, params)
        for (hp, ht), h_b, an in zip(hops, h_blend, anchors)
    ]
    w_new = torch.clamp(1.0 / a.clamp_min(1e-3), max=64.0)
    return h_ps, (tuple(h_blend), w_new)


# ---------------------------------------------------------------------------
# The fused-front tier (K1)
# ---------------------------------------------------------------------------


def _front_pallas_batched(
    plan: EstimatorPlan, pt: dict, rg_ri: torch.Tensor, pil_ri: torch.Tensor,
    beta: torch.Tensor, out_layout: str, out_dtype=None,
):
    """The batched estimator over K1, its finish and K2.

    plan: an EstimatorPlan of either package; pt: `plan_tensors(plan, ...)` on
    the inputs' device and dtype. rg_ri (B, 2, n_sc, n_sym); pil_ri
    (B, 2, n_re, n_dsym_total, nL); beta (B,). K1 reads both as staged,
    through each hop's RE and symbol tables and its view of the pilots, so
    nothing is gathered or permuted in front of it. Returns EstimateResult
    (serve) or FactoredResult (factored). One `front_finish` launch a call takes the
    scalars and the rotation, and with linear interpolation the factored
    profiles too (its two-tap tables); the "cnn" inpainting operator is not
    two-tap, so its factored profiles stay one product a CDM group."""
    config = plan.config
    nL = plan.n_layers
    B, _, n_sc, n_sym = rg_ri.shape
    hops = [plan.hop1] + ([plan.hop2] if plan.hop2 is not None else [])
    splits = [(0, plan.n_dsym1)] + (
        [(plan.n_dsym1, plan.n_dsym1 + plan.hop2.n_dsym)] if plan.hop2 is not None else []
    )

    h_ps, scs = [], []
    for hp, ht, (d0, d1) in zip(hops, pt["hops"], splits):
        h_s, sc = _k1.fused_front(
            rg_ri, pil_ri[:, :, :, d0:d1], beta, ht["front"],
            n_samples=hp.n_samples, half_cp_len=hp.half_cp_len, fft_size=hp.fft_size,
            scs_hz=config.scs_hz, cfo_possible=hp.cfo_possible,
            cfo_compensate=config.cfo_compensate,
            re_idx=ht["re_idx"], dmrs_sym_idx=ht["dmrs_sym_idx"],
        )
        h_ps.append(h_s)
        scs.append(sc)

    two_tap = out_layout == "factored" and config.interp == "linear"
    profiles, rot_ri, noise, rsrp, epre, ta, cfo_hz = _finish.front_finish(
        h_ps, scs, [ht["taps"] for ht in pt["hops"]] if two_tap else None, pt["sst"],
        sc_starts=[hp.sc_start for hp in hops], cfo_possible=[hp.cfo_possible for hp in hops],
        n_sc=n_sc, n_sym=n_sym, n_pilots=plan.n_pilots, noise_den=plan.noise_den,
        scs_hz=config.scs_hz, cfo_compensate=config.cfo_compensate,
    )

    if out_layout == "factored":
        if profiles is None:
            profiles = rg_ri.new_zeros((B, 2, len(hops), nL, n_sc))
            for h, (hp, ht, h_s) in enumerate(zip(hops, pt["hops"], h_ps)):
                for c, (l0, l1) in enumerate(hp.layer_slices):
                    # contiguous, the group's rows fold into one (B 2 n_lc, n_re) x
                    # (n_re, n_sc_hop) product; the strided slice runs as B 2
                    # batched products of n_lc rows each (~15x slower on an H100)
                    full = torch.matmul(h_s[:, :, l0:l1].contiguous(), ht["interp"][c])
                    profiles[:, :, h, l0:l1, hp.sc_start : hp.sc_start + hp.n_sc_hop] = full
        return FactoredResult(profiles, rot_ri, noise, rsrp, epre, ta, cfo_hz)

    channel = _serve_fill_pallas_batched(plan, pt, tuple(h_ps), rot_ri, n_sc, n_sym, out_dtype)
    return EstimateResult(channel, noise, rsrp, epre, ta, cfo_hz)


# ---------------------------------------------------------------------------
# Public builders
# ---------------------------------------------------------------------------


class BatchedEstimator:
    """`fn(rg_ri, pil_ri, beta[, params])` of `build_ri`: runs the estimator on
    the inputs' device and dtype, with the plan's device tensors built once per
    (device, dtype) and kept by this object. `params` (the denoiser's, a
    replicated argument, not batched) is required by the learned smoothings and
    moved to the inputs' device once (`denoiser.module_for`). On the card a
    call replays one CUDA graph per input shape (`graphs.Graphed`; eagerly
    inside `graphs.eager()`)."""

    def __init__(self, plan: EstimatorPlan, batched: bool, kernels: str, out_layout: str,
                 out_dtype=None):
        self.plan = plan
        self.batched = batched
        self.kernels = kernels
        self.out_layout = out_layout
        self.out_dtype = out_dtype
        self._tensors: dict = {}
        self._graphed = graphs.Graphed(self._forward, self._name())

    def _name(self) -> str:
        p = self.plan
        hops = [h for h in (p.hop1, p.hop2) if h is not None]
        return (f"{type(self).__name__}(kernels={self.kernels!r}, out_layout={self.out_layout!r}, "
                f"batched={self.batched}, n_layers={p.n_layers}, smoothing="
                f"{p.config.smoothing!r}, interp={p.config.interp!r}, hops "
                f"{[(h.sc_start, h.n_sc_hop, h.sym_start, h.n_alloc_syms) for h in hops]})")

    def plan_tensors(self, device, dtype) -> dict:
        key = (torch.device(device), dtype)
        pt = self._tensors.get(key)
        if pt is None:
            pt = self._tensors[key] = plan_tensors(self.plan, key[0], dtype,
                                                    k1=self.kernels == "pallas_front")
        return pt

    def __call__(self, rg_ri, pil_ri, beta, params=None):
        if params is None and self.plan.config.smoothing in ("learned", "learned2d"):
            raise ValueError(f"smoothing={self.plan.config.smoothing!r} needs denoiser params")
        rg_ri = torch.as_tensor(rg_ri)
        dev, dt = rg_ri.device, rg_ri.dtype
        if dt not in (torch.float32, torch.float64):
            raise TypeError(f"the estimator takes float32 or float64 ri tensors, not {dt}")
        if self.kernels != "xla" and dev.type == "cuda" and dt != torch.float32:
            raise TypeError(
                f"kernels={self.kernels!r} runs CUDA kernels, which take float32, not {dt} "
                "(kernels='xla' runs float64 on any device)"
            )
        pil_ri = torch.as_tensor(pil_ri, device=dev, dtype=dt)
        beta = torch.as_tensor(beta, device=dev, dtype=dt)
        return self._graphed(rg_ri, pil_ri, beta, params)

    def _forward(self, rg_ri, pil_ri, beta, params):
        if not self.batched:
            rg_ri, pil_ri, beta = rg_ri[None], pil_ri[None], beta.reshape(1)
        pt = self.plan_tensors(rg_ri.device, rg_ri.dtype)
        plan, kernels = self.plan, self.kernels
        with full_f32_matmul():
            if kernels == "pallas_front":
                res = _front_pallas_batched(
                    plan, pt, rg_ri, pil_ri, beta, self.out_layout, self.out_dtype
                )
            elif kernels == "pallas" and self.out_layout == "serve" and _serve_pallas_deferred_ok(plan):
                # deferred fill: the per-problem front on the "xla" tier (fused
                # smoothing matrices), then one batched K2 launch per hop
                h_ps, rot_ri, noise, rsrp, epre, ta, cfo_hz = _estimate_impl(
                    plan, pt, _ri_to_complex(rg_ri), _ri_to_complex(pil_ri), beta,
                    "xla", "serve", defer_fill=True, params=params,
                )
                channel = _serve_fill_pallas_batched(
                    plan, pt, h_ps, rot_ri, rg_ri.shape[2], rg_ri.shape[3], self.out_dtype
                )
                res = EstimateResult(channel, noise, rsrp, epre, ta, cfo_hz)
            else:
                res = _estimate_impl(
                    plan, pt, _ri_to_complex(rg_ri), _ri_to_complex(pil_ri), beta,
                    kernels, self.out_layout, self.out_dtype, params=params,
                )
        if not self.batched:
            res = type(res)(*(getattr(res, f.name)[0] for f in fields(res)))
        return res


@functools.lru_cache(maxsize=256)
def _build_ri_cached(plan_key, batched: bool, kernels: str, out_layout: str, out_dtype):
    plan = make_plan(*plan_key)
    if kernels == "pallas_front":
        if out_layout not in ("serve", "factored"):
            raise ValueError("kernels='pallas_front' supports the serve and factored layouts")
        if not _front_pallas_ok(plan):
            raise ValueError(
                "plan not eligible for the fused front kernel (needs 'filter' "
                "smoothing through the fused matrices or the banded route, first-pair "
                "CFO, no time interp, paired CDM layers, direct-DFT TA, shared-memory "
                "budget)"
            )
        if out_layout == "serve" and not _serve_pallas_deferred_ok(plan):
            raise ValueError("serve fill not eligible for the batched fill kernel")
    return BatchedEstimator(plan, batched, kernels, out_layout, _OUT_DTYPES[out_dtype])


def build_ri(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    batched: bool = False,
    kernels: str = "xla",
    out_layout: str = "ref",
    out_dtype: Optional[str] = None,
) -> BatchedEstimator:
    """`fn(rg_ri, pil_ri, beta[, params]) -> EstimateResult | FactoredResult` in
    ri layout, the signature of `srsran_ce_tpu.models.estimator.build_ri`;
    `params` (`models.denoiser.load_shipped` or `params_from_flax`) is required
    when config.smoothing is "learned" or "learned2d".

    rg_ri: (2, n_sc, n_sym); pil_ri: (2, n_re, n_dsym, n_layers); with
    batched=True a leading problem axis B comes first ((B, 2, ...)). Tensors
    stay on their device: CUDA inputs run the kernels of the chosen tier, CPU
    inputs their plain versions. channel_est_rg is (2, n_sc, n_sym, n_layers)
    per problem in the reference layout, (2, n_layers, n_sym, n_sc) in the
    serve layout; "factored" returns a FactoredResult.

    kernels: "xla" (plain torch), "pallas" (K5 smoothing and K6 fill in the
    reference layout; the xla front then K2 in the serve layout) or
    "pallas_front" (K1 then K2; serve and factored; not the learned
    smoothings, which it refuses as JAX does). out_dtype="bfloat16"
    (serve only) halves the grid: its values carry ~4e-3 relative error, the
    scalars stay full precision."""
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    if kernels not in ("xla", "pallas", "pallas_front"):
        raise ValueError(f"kernels={kernels!r}: one of 'xla', 'pallas', 'pallas_front'")
    if out_layout not in ("ref", "serve", "factored"):
        raise ValueError(f"out_layout={out_layout!r}: one of 'ref', 'serve', 'factored'")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype={out_dtype!r}: None or 'bfloat16'")
    if out_dtype is not None and out_layout != "serve":
        raise ValueError("out_dtype requires the serve layout")
    if out_layout == "factored" and config.time_interp != "none":
        raise ValueError("out_layout='factored' requires time_interp='none'")
    dsp.precision_of(config.matmul_precision)  # "high"/"highest" -> full f32; "default" raises
    return _build_ri_cached((hop1, hop2, config, n_layers), batched, kernels, out_layout, out_dtype)


@functools.lru_cache(maxsize=256)
def _front_serves(plan_key, out_layout: str) -> bool:
    plan = make_plan(*plan_key)
    if not _front_pallas_ok(plan):
        return False
    if out_layout == "factored":
        return True
    # past the plan's dense operator (1,024 pilot REs) the grid stays on "xla"
    hops = [hp for hp in (plan.hop1, plan.hop2) if hp is not None]
    return _serve_pallas_deferred_ok(plan) and all(hp.smooth_mat is not None for hp in hops)


def served_kernels(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    out_layout: str,
    device,
) -> str:
    """The kernel tier a served estimator takes (`serving.process`: out "grid"
    in the serve layout, "factored"), for the float32 inputs serving stages:
    "pallas_front" (K1, then K2's serve fill or one matmul per CDM group) on a
    CUDA device when the fused front covers the plan; "xla" otherwise (the
    CPU, and the plans K1 cannot take: learned or wiener smoothing, time
    interpolation, the CFO pair estimator, more than 8 layers, unpaired CDM
    slices). K1 smooths every band on its banded route; a band past 1,024
    pilot REs takes it for out "factored" only: its "grid" (K2's serve fill
    over the wide operator after it) stays on "xla". Both tiers compute one
    algorithm to within float32 rounding. Decided once per plan key."""
    if torch.device(device).type != "cuda":
        return "xla"
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    return "pallas_front" if _front_serves((hop1, hop2, config, n_layers), out_layout) else "xla"


def _to_numpy(res: EstimateResult) -> EstimateResult:
    """A batched or single ref-layout result on the host: the channel complex
    (..., n_sc, n_sym, nL), the scalars numpy arrays."""
    ch = res.channel_est_rg.cpu().numpy()
    ch = merge_ri(np.moveaxis(ch, -4, 0))
    return EstimateResult(ch, *(getattr(res, f.name).cpu().numpy() for f in fields(res)[1:]))


def build(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    device="cuda",
):
    """Complex host API: `fn(received_rg, pilots, beta) -> EstimateResult` with
    numpy complex inputs and outputs (ri conversion at the boundary), run on
    `device` (the card by default; raises when there is none).
    complex128 inputs run in float64, complex64 in float32."""
    device = devices.resolve(device)
    fn_ri = build_ri(hop1, hop2, config, n_layers, batched=False)

    def fn(received_rg, pilots, beta):
        rg = torch.as_tensor(split_ri(received_rg), device=device)
        pil = torch.as_tensor(split_ri(pilots), device=device)
        return _to_numpy(fn_ri(rg, pil, beta))

    return fn


def build_batched(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    device="cuda",
):
    """Batched complex host API: `fn(received_rg[B], pilots[B], beta[B])` with a
    leading problem axis on every output, run on `device` (the card by
    default); use build_ri(batched=True) for the zero-conversion serving path."""
    device = devices.resolve(device)
    fn_ri = build_ri(hop1, hop2, config, n_layers, batched=True)

    def fn(received_rg, pilots, beta):
        rg = torch.as_tensor(np.moveaxis(split_ri(received_rg), 0, 1), device=device)
        pil = torch.as_tensor(np.moveaxis(split_ri(pilots), 0, 1), device=device)
        return _to_numpy(fn_ri(rg, pil, np.asarray(beta)))

    return fn


def estimate(
    received_rg,
    pilots,
    beta,
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    device="cuda",
) -> EstimateResult:
    """One-shot API mirroring the reference call signature
    (srs_channel_estimator, ce_rule_baseline.py:761-768)."""
    n_layers = int(pilots.shape[-1])
    return build(hop1, hop2, config, n_layers, device)(received_rg, pilots, beta)
