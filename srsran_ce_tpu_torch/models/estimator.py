"""Batched estimator of the PyTorch/CUDA port: the kernel tier
`kernels="pallas_front"` of `srsran_ce_tpu/models/estimator.py`.

Per hop, the pilot-RE gather (plain torch indexing) feeds the fused front
(`ops.kernels.front`, K1); the cross-hop combine and normalization, the CFO
rotation and the placement of each hop's block into the zero grid are plain
tensor code; the serve-layout grid fill is `ops.kernels.fill_rotate_serve`
(K2), the factored layout one `torch.matmul` per CDM group. On CUDA tensors
both kernels launch; on CPU tensors their plain versions run (the CPU tests
hold them against the JAX package in float64).

Covered: `kernels="pallas_front"`, `out_layout="serve" | "factored"`,
`batched=True | False`, linear interpolation, f32 on CUDA (f32 or f64 on the
CPU). Everything else raises NotImplementedError naming its ROADMAP.md item;
plans outside the kernels' coverage raise ValueError, as the JAX package does.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from ..config import EstimatorConfig, HopConfig
from ..ops import dsp
from ..ops.kernels import full_f32_matmul
from ..ops.kernels import fill_rotate_serve as _k2
from ..ops.kernels import front as _k1
from .plan import EstimatorPlan, HopPlan, make_plan, plan_tensors


@dataclass
class EstimateResult:
    """Outputs of a batch of problems (ri layout). `channel_est_rg` is
    (B, 2, nL, n_sym, n_sc) in the serve layout; `cfo_hz` is NaN when no hop has
    two DM-RS symbols."""

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


def _serve_pallas_deferred_ok(plan: EstimatorPlan) -> bool:
    """True when the batched serve fill (K2) covers the plan: a rank-1-in-time
    fill (no time interpolation) with an interpolation operator for every CDM
    group. (The TPU gate's VMEM budget has no counterpart: the CUDA kernel
    streams the operator from L2 in chunks of any size.)"""
    for hp in (plan.hop1, plan.hop2):
        if hp is None:
            continue
        if hp.time_interp_mat is not None or hp.interp_matrix is None:
            return False
    return True


def _front_pallas_ok(plan: EstimatorPlan) -> bool:
    """True when the fused front kernel (K1) covers the plan: fused-matrix
    'filter' smoothing (no alpha blend), the first-pair CFO estimator, no time
    interpolation, the paired CDM layer layout, the direct-DFT TA path, and the
    block's working set inside the card's shared memory (`front.smem_bytes`,
    the same function the kernel's wrapper checks)."""
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
        if hp.smooth_mat is None or hp.cfo_pair_dt is not None:
            return False
        if hp.vp_matrix is None and hp.n_pils != 1:
            return False
        if hp.ta_dft_cos is None:
            return False
        if config.interp == "linear" and hp.interp_matrix is None:
            return False
        if hp.layer_slices != tuple((2 * c, min(2 * c + 2, nL)) for c in range(hp.n_cdm)):
            return False
        if hp.n_pils > _k1._MAX_PILS or hp.n_dsym > _k1._MAX_DSYM:
            return False
        if _k1.smem_bytes(hp.n_re, nL, hp.n_pils, hp.half_cp_len) > _k1.SMEM_LIMIT:
            return False
    return True


def _front_mats(hp: HopPlan) -> dict:
    """Static matrices of the fused front kernel, in plan order. The TPU
    version folds two flips into pair_r and smooth_ve (Mosaic has no lane
    reversal); here they are dropped and the kernel indexes the right edge
    reversed. `vp` is the fit matrix itself (v = vp @ y); a (1, 1) zero stands
    in when n_pils == 1 (no fit)."""
    return dict(
        pair_l=hp.pair_l_mat,
        pair_r=hp.pair_r_mat,
        vp=hp.vp_matrix if hp.vp_matrix is not None else np.zeros((1, 1)),
        smooth=hp.smooth_mat,
        smooth_vb=hp.smooth_vb_mat,
        smooth_ve=hp.smooth_ve_mat,
        ta_c=hp.ta_dft_cos,
        ta_s=hp.ta_dft_sin,
    )


def _gather_rx(hp: HopPlan, ht: dict, rg_ri: torch.Tensor) -> torch.Tensor:
    """The hop's received pilot REs, (B, 2, n_cdm, n_dsym, n_re), time-major.

    One index gather with the plan's RE table; the TPU package's reshape-and-
    slice form for contiguous combs (`fast_sel`, TPUs have no gather hardware)
    selects the same elements in the same order."""
    B = rg_ri.shape[0]
    g = rg_ri.index_select(2, ht["re_idx"]).index_select(3, ht["dmrs_sym_idx"])
    return g.reshape(B, 2, hp.n_cdm, hp.n_re, hp.n_dsym).transpose(3, 4).contiguous()


def _front_pallas_batched(
    plan: EstimatorPlan, pt: dict, rg_ri: torch.Tensor, pil_ri: torch.Tensor,
    beta: torch.Tensor, out_layout: str,
):
    """The batched estimator over the two kernels.

    plan: an EstimatorPlan of either package; pt: `plan_tensors(plan, ...)` on
    the inputs' device and dtype. rg_ri (B, 2, n_sc, n_sym); pil_ri
    (B, 2, n_re, n_dsym_total, nL); beta (B,). Returns EstimateResult (serve)
    or FactoredResult (factored)."""
    config = plan.config
    nL = plan.n_layers
    B, _, n_sc, n_sym = rg_ri.shape
    rdtype = rg_ri.dtype
    dev = rg_ri.device
    hops = [plan.hop1] + ([plan.hop2] if plan.hop2 is not None else [])
    splits = [(0, plan.n_dsym1)] + (
        [(plan.n_dsym1, plan.n_dsym1 + plan.hop2.n_dsym)] if plan.hop2 is not None else []
    )

    zeros = torch.zeros(B, dtype=rdtype, device=dev)
    epre, noise, rsrp, ta = zeros, zeros, zeros, zeros
    cfo = None
    h_ps = []
    for hp, ht, (d0, d1) in zip(hops, pt["hops"], splits):
        rx = _gather_rx(hp, ht, rg_ri)
        # pilots (B, 2, n_re, n_dsym, nL) -> (B, 2, nL, n_dsym, n_re)
        pil = pil_ri[:, :, :, d0:d1].permute(0, 1, 4, 3, 2).contiguous()
        h_s, sc = _k1.fused_front(
            rx, pil, beta, ht["front"],
            n_samples=hp.n_samples, half_cp_len=hp.half_cp_len, fft_size=hp.fft_size,
            scs_hz=config.scs_hz, cfo_possible=hp.cfo_possible,
            cfo_compensate=config.cfo_compensate,
        )
        h_ps.append(h_s)
        ta = ta + sc[:, 1]
        noise = noise + sc[:, 2]
        rsrp = rsrp + sc[:, 3]
        epre = epre + sc[:, 4]
        if hp.cfo_possible:
            cfo = sc[:, 0] if cfo is None else (cfo + sc[:, 0]) / 2.0

    rsrp = rsrp / plan.n_pilots / nL
    epre = epre / plan.n_pilots
    noise = noise / plan.noise_den
    if plan.hop2 is not None:
        ta = ta / 2.0
    cfo_hz = cfo * config.scs_hz if cfo is not None else torch.full_like(zeros, math.nan)

    if config.cfo_compensate and cfo is not None:
        phase = (2.0 * math.pi) * cfo[:, None] * pt["sst"][None, :]  # (B, 14)
        rot_ri = torch.stack([torch.cos(phase), torch.sin(phase)], dim=1)
    else:
        rot_ri = torch.stack(
            [torch.ones(B, n_sym, dtype=rdtype, device=dev),
             torch.zeros(B, n_sym, dtype=rdtype, device=dev)],
            dim=1,
        )

    if out_layout == "factored":
        profiles = torch.zeros((B, 2, len(hops), nL, n_sc), dtype=rdtype, device=dev)
        with full_f32_matmul():
            for h, (hp, ht, h_s) in enumerate(zip(hops, pt["hops"], h_ps)):
                for c, (l0, l1) in enumerate(hp.layer_slices):
                    full = torch.matmul(h_s[:, :, l0:l1], ht["interp"][c])  # (B, 2, n_lc, n_sc_hop)
                    profiles[:, :, h, l0:l1, hp.sc_start : hp.sc_start + hp.n_sc_hop] = full
        return FactoredResult(profiles, rot_ri, noise, rsrp, epre, ta, cfo_hz)

    channel = None
    for hp, ht, h_s in zip(hops, pt["hops"], h_ps):
        rot_slice = rot_ri[:, :, hp.sym_start : hp.sym_start + hp.n_alloc_syms].contiguous()
        blk = _k2.fused_fill_rotate_serve(
            h_s, ht["interp"], rot_slice, layer_slices=hp.layer_slices
        )  # (B, 2, nL, n_alloc, n_sc_hop)
        if (
            len(hops) == 1 and hp.sc_start == 0 and hp.n_sc_hop == n_sc
            and hp.sym_start == 0 and hp.n_alloc_syms == n_sym
        ):
            return EstimateResult(blk, noise, rsrp, epre, ta, cfo_hz)  # no zero-grid pass
        if channel is None:
            channel = torch.zeros((B, 2, nL, n_sym, n_sc), dtype=rdtype, device=dev)
        channel[
            :, :, :, hp.sym_start : hp.sym_start + hp.n_alloc_syms,
            hp.sc_start : hp.sc_start + hp.n_sc_hop,
        ] = blk
    return EstimateResult(channel, noise, rsrp, epre, ta, cfo_hz)


class BatchedEstimator:
    """`fn(rg_ri, pil_ri, beta)` of `build_ri`: runs the estimator on the
    inputs' device and dtype, with the plan's device tensors built once per
    (device, dtype) and kept by this object."""

    def __init__(self, plan: EstimatorPlan, batched: bool, out_layout: str):
        self.plan = plan
        self.batched = batched
        self.out_layout = out_layout
        self._tensors: dict = {}

    def plan_tensors(self, device, dtype) -> dict:
        key = (torch.device(device), dtype)
        pt = self._tensors.get(key)
        if pt is None:
            pt = self._tensors[key] = plan_tensors(self.plan, key[0], dtype)
        return pt

    def __call__(self, rg_ri, pil_ri, beta):
        rg_ri = torch.as_tensor(rg_ri)
        dev, dt = rg_ri.device, rg_ri.dtype
        pil_ri = torch.as_tensor(pil_ri, device=dev, dtype=dt)
        beta = torch.as_tensor(beta, device=dev, dtype=dt)
        if not self.batched:
            rg_ri, pil_ri, beta = rg_ri[None], pil_ri[None], beta.reshape(1)
        res = _front_pallas_batched(
            self.plan, self.plan_tensors(dev, dt), rg_ri, pil_ri, beta, self.out_layout
        )
        if not self.batched:
            res = type(res)(*(getattr(res, f.name)[0] for f in fields(res)))
        return res


@functools.lru_cache(maxsize=256)
def _build_ri_cached(plan_key, batched: bool, out_layout: str) -> BatchedEstimator:
    plan = make_plan(*plan_key)
    if not _front_pallas_ok(plan):
        raise ValueError(
            "plan not eligible for the fused front kernel (needs fused-matrix "
            "'filter' smoothing, first-pair CFO, no time interp, paired CDM "
            "layers, direct-DFT TA, shared-memory budget)"
        )
    if out_layout == "serve" and not _serve_pallas_deferred_ok(plan):
        raise ValueError("serve fill not eligible for the batched fill kernel")
    return BatchedEstimator(plan, batched, out_layout)


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
    """`fn(rg_ri, pil_ri, beta) -> EstimateResult | FactoredResult` in ri layout,
    the signature of `srsran_ce_tpu.models.estimator.build_ri`.

    rg_ri: (2, n_sc, n_sym); pil_ri: (2, n_re, n_dsym, n_layers); with
    batched=True a leading problem axis B comes first ((B, 2, ...)). Tensors
    stay on their device: CUDA inputs run the kernels, CPU inputs the plain
    versions. out_layout="serve" returns channel_est_rg as (2, nL, n_sym, n_sc)
    per problem; "factored" a FactoredResult.

    The port carries only the kernel tier: pass kernels="pallas_front" (the
    defaults mirror the JAX signature and raise NotImplementedError)."""
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    if kernels != "pallas_front":
        raise NotImplementedError(
            f"kernels={kernels!r}: the port carries only the kernel tier 'pallas_front'; "
            "the XLA tier (and 'pallas', K5/K6) is ROADMAP.md queue 1, item 3"
        )
    if out_layout not in ("serve", "factored"):
        raise NotImplementedError(
            f"out_layout={out_layout!r}: the reference layout is ROADMAP.md queue 1, item 3"
        )
    if out_dtype is not None:
        raise NotImplementedError(
            f"out_dtype={out_dtype!r}: the bf16 serve output is ROADMAP.md queue 1, item 3"
        )
    if config.interp != "linear":
        raise NotImplementedError(
            "interp='cnn' needs the inpainting operator (dsp.inpaint_operator), "
            "ROADMAP.md queue 1, item 2"
        )
    dsp.precision_of(config.matmul_precision)  # "high"/"highest" -> full f32; "default" raises
    if out_layout == "factored" and config.time_interp != "none":
        raise ValueError("out_layout='factored' requires time_interp='none'")
    return _build_ri_cached((hop1, hop2, config, n_layers), batched, out_layout)
