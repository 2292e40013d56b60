"""Joint multi-RX-port MMSE receiver of the port: `srsran_ce_tpu/models/receiver.py`
in torch.

An uplink receiver runs the estimator once per receive antenna and then jointly
MMSE-equalizes the data REs across ports (ops/equalize), optionally demapping
to int8 LLRs in the same call (ops/demap). The JAX module vmaps its
`_estimate_impl` over the RX axis; here the (B, n_rx) pairs fold into B·n_rx
problems of the port's batched `_estimate_impl` (one estimator code path) and
unfold after it. With `kernels="pallas"` that fold reaches K5 (the RC
smoothing FIR) and, in the dense layout, K2 (the serve fill), as the JAX tier
does.

Factored fast path (`mode="auto"` with time_interp="none"): each port's grid
is rank-1 in time per hop, the per-port CFO rotations cancel in the Gram
matrix, and the MMSE inverse is built once per subcarrier, exactly
(`equalize.mmse_equalize_factored_serve`).

Measurements (noise, RSRP, EPRE, TA, CFO) are means over the ports.

Shapes (ri layout, a leading re/im axis of 2, as every build_* of the port):
rg_ri (2, n_rx, n_sc, n_sym); pil_ri (2, n_re, n_dsym, nL), shared by the
ports; x (2, nL, n_sym, n_sc). Batched adds a leading problem axis B.

The learned smoothings take the denoiser's `params` as a fourth argument, as
the JAX receiver does. The tracked receiver (`build_tracked_receiver_ri`)
threads a per-port multi-slot tracking state (models/tracking.py) through the
factored path.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, fields
from typing import Optional

import torch

from .. import devices, graphs
from ..config import EstimatorConfig, HopConfig
from ..ops import demap, dsp, equalize
from ..ops.kernels import full_f32_matmul
from . import tracking
from .estimator import _complex_to_ri, _estimate_impl, _ri_to_complex
from .plan import make_plan, plan_tensors


@dataclass
class ReceiverResult:
    """Equalized symbols, SINR and the estimator's five measurements (port
    means), each with the problem axis leading when batched.

    x: (2, nL, n_sym, n_sc) ri, noise-normalized symbol estimates, zero
    outside the hop allocations. sinr: post-MMSE SINR (linear), (nL, n_sym,
    n_sc) dense, (n_hops, nL, n_sc) factored (time-invariant per hop)."""

    x: torch.Tensor
    sinr: torch.Tensor
    noise_est: torch.Tensor
    rsrp: torch.Tensor
    epre: torch.Tensor
    time_alignment: torch.Tensor
    cfo_hz: torch.Tensor


@dataclass
class LlrResult:
    """Soft-bit receiver output: llr is a TUPLE of nbits int8 planes, each
    (nL, n_sym, n_sc), in TS 38.211 word order, round(llr * llr_scale)
    clipped to [-127, 127] (positive = bit 0 likelier; 0 outside the hop
    allocations). sinr keeps ReceiverResult's shape."""

    llr: tuple
    sinr: torch.Tensor
    noise_est: torch.Tensor
    rsrp: torch.Tensor
    epre: torch.Tensor
    time_alignment: torch.Tensor
    cfo_hz: torch.Tensor


def receiver_impl(
    plan,
    pt: dict,
    rg: torch.Tensor,
    pil: torch.Tensor,
    beta: torch.Tensor,
    factored: bool,
    data_beta: float = 1.0,
    kernels: str = "xla",
    modulation: Optional[str] = None,
    llr_scale: float = 8.0,
    params=None,
):
    """Estimate + equalize (+ demap) over a batch: rg (B, n_rx, n_sc, n_sym)
    complex, pil (B, n_re, n_dsym, nL) complex, beta (B,). `pt` holds the
    plan's tensors on the inputs' device and dtype; `params` the denoiser's
    (learned smoothing). Problem b's ports are the estimator's problems
    b·n_rx ... b·n_rx + n_rx - 1."""
    B, n_rx, n_sc, n_sym = rg.shape
    est = _estimate_impl(
        plan, pt, rg.reshape(B * n_rx, n_sc, n_sym),
        pil.repeat_interleave(n_rx, dim=0), beta.repeat_interleave(n_rx, dim=0),
        kernels, "factored" if factored else "serve", params=params,
    )
    return _equalize_tail(plan, rg, est, factored, data_beta, modulation, llr_scale)


def _equalize_tail(plan, rg, est, factored, data_beta, modulation, llr_scale):
    """Cross-port MMSE equalization (+ the demap) of the folded estimator
    output `est` (B·n_rx problems, ri layout). Internally the tiny axes lead:
    y (n_rx, B, n_sym, n_sc), x (nL, B, n_sym, n_sc)."""
    B, n_rx, n_sc, n_sym = rg.shape
    hop_plans = [plan.hop1] + ([plan.hop2] if plan.hop2 is not None else [])
    nL = plan.n_layers
    port_mean = lambda t: t.reshape(B, n_rx).mean(dim=1)
    noise = port_mean(est.noise_est)
    y = rg.permute(1, 0, 3, 2)
    if factored:
        prof = _ri_to_complex(est.profiles).reshape(B, n_rx, len(hop_plans), nL, n_sc)
        rot = _ri_to_complex(est.sym_rot).reshape(B, n_rx, n_sym).transpose(0, 1)
        x = rg.new_zeros((nL, B, n_sym, n_sc))
        sinr_lead = []
        for h, hp in enumerate(hop_plans):
            xh, sh = equalize.mmse_equalize_factored_serve(
                y, prof[:, :, h].permute(1, 2, 0, 3), rot, noise[:, None],
                hp.sym_start, hp.n_alloc_syms, beta=data_beta,
            )
            x[:, :, hp.sym_start : hp.sym_start + hp.n_alloc_syms] = xh
            sinr_lead.append(sh)  # (nL, B, n_sc)
        sinr = torch.stack(sinr_lead, dim=1).permute(2, 1, 0, 3)  # (B, n_hops, nL, n_sc)
    else:
        ch = _ri_to_complex(est.channel_est_rg).reshape(B, n_rx, nL, n_sym, n_sc)
        x, sinr_lead = equalize.mmse_equalize_serve(
            y, ch.permute(1, 2, 0, 3, 4), noise[:, None, None], beta=data_beta
        )
        sinr = sinr_lead.transpose(0, 1)  # (B, nL, n_sym, n_sc)
    meas = dict(
        noise_est=noise,
        rsrp=port_mean(est.rsrp),
        epre=port_mean(est.epre),
        time_alignment=port_mean(est.time_alignment),
        cfo_hz=port_mean(est.cfo_hz),
    )
    if modulation is None:
        return ReceiverResult(x=_complex_to_ri(x.transpose(0, 1)), sinr=sinr, **meas)
    nbits = demap.bits_per_symbol(modulation)
    # jnp.round and torch.round both round half to even
    quant = lambda l: torch.clamp(torch.round(l * llr_scale), -127.0, 127.0).to(torch.int8)
    if factored:
        # each hop's symbols demapped against its per-subcarrier SINR
        # (broadcast over the symbols); zeros outside the allocations = erasures
        planes = [rg.new_zeros((nL, B, n_sym, n_sc), dtype=torch.int8) for _ in range(nbits)]
        for h, hp in enumerate(hop_plans):
            syms = slice(hp.sym_start, hp.sym_start + hp.n_alloc_syms)
            lst = demap._llr_list(x[:, :, syms], sinr_lead[h][:, :, None, :], modulation)
            for k in range(nbits):
                planes[k][:, :, syms] = quant(lst[k])
    else:
        planes = [quant(l) for l in demap._llr_list(x, sinr_lead, modulation)]
    llr = tuple(p.transpose(0, 1).contiguous() for p in planes)  # (B, nL, n_sym, n_sc)
    return LlrResult(llr=llr, sinr=sinr, **meas)


class BatchedReceiver:
    """`fn(rg_ri, pil_ri, beta[, params])` of `build_receiver_ri`. Tensors stay
    on their device (CUDA tensors run the kernels of the tier, CPU tensors
    their plain versions); numpy inputs go to the device given to
    `build_receiver_ri`. The plan's tensors are built once per (device,
    dtype) and kept here. `params` (the denoiser's, not batched) is required
    by the learned smoothings. On the card a call replays one CUDA graph per
    input shape (`graphs.Graphed`; eagerly inside `graphs.eager()`)."""

    def __init__(self, plan, n_rx: int, batched: bool, factored: bool, data_beta: float,
                 kernels: str, modulation: Optional[str], llr_scale: float, device: torch.device):
        self.plan = plan
        self.n_rx = n_rx
        self.batched = batched
        self.factored = factored
        self.data_beta = data_beta
        self.kernels = kernels
        self.modulation = modulation
        self.llr_scale = llr_scale
        self.device = device
        self._tensors: dict = {}
        self._graphed = graphs.Graphed(self._forward, self._name())

    def _name(self) -> str:
        p = self.plan
        return (f"{type(self).__name__}(n_rx={self.n_rx}, factored={self.factored}, "
                f"kernels={self.kernels!r}, modulation={self.modulation!r}, batched="
                f"{self.batched}, n_layers={p.n_layers}, smoothing={p.config.smoothing!r}, "
                f"n_sc_hop={p.hop1.n_sc_hop}, two hops={p.hop2 is not None})")

    def plan_tensors(self, device, dtype) -> dict:
        key = (torch.device(device), dtype)
        pt = self._tensors.get(key)
        if pt is None:
            pt = self._tensors[key] = plan_tensors(self.plan, key[0], dtype, k1=False)
        return pt

    def _inputs(self, rg_ri, pil_ri, beta):
        """The call's tensors on rg_ri's device and dtype, with the problem axis."""
        rg_ri = rg_ri if torch.is_tensor(rg_ri) else torch.as_tensor(rg_ri, device=self.device)
        dev, dt = rg_ri.device, rg_ri.dtype
        if dt not in (torch.float32, torch.float64):
            raise TypeError(f"the receiver takes float32 or float64 ri tensors, not {dt}")
        if self.kernels != "xla" and dev.type == "cuda" and dt != torch.float32:
            raise TypeError(f"kernels={self.kernels!r} runs CUDA kernels, which take float32, not {dt}")
        pil_ri = torch.as_tensor(pil_ri, device=dev, dtype=dt)
        beta = torch.as_tensor(beta, device=dev, dtype=dt)
        if rg_ri.dim() != 4 + self.batched or rg_ri.shape[-4] != 2 or rg_ri.shape[-3] != self.n_rx:
            raise ValueError(
                f"rg_ri must be ([B,] 2, n_rx={self.n_rx}, n_sc, n_sym), got {tuple(rg_ri.shape)}"
            )
        return rg_ri, pil_ri, beta

    def _unbatch(self, res):
        if self.batched:
            return res
        return type(res)(*(
            tuple(p[0] for p in v) if isinstance(v, tuple) else v[0]
            for v in (getattr(res, f.name) for f in fields(res))
        ))

    def __call__(self, rg_ri, pil_ri, beta, params=None):
        if params is None and self.plan.config.smoothing in ("learned", "learned2d"):
            raise ValueError(f"smoothing={self.plan.config.smoothing!r} needs denoiser params")
        return self._graphed(*self._inputs(rg_ri, pil_ri, beta), params)

    def _forward(self, rg_ri, pil_ri, beta, params):
        if not self.batched:
            rg_ri, pil_ri, beta = rg_ri[None], pil_ri[None], beta.reshape(1)
        with full_f32_matmul():
            res = receiver_impl(
                self.plan, self.plan_tensors(rg_ri.device, rg_ri.dtype), _ri_to_complex(rg_ri),
                _ri_to_complex(pil_ri), beta, self.factored, self.data_beta, self.kernels,
                self.modulation, self.llr_scale, params,
            )
        return self._unbatch(res)


@functools.lru_cache(maxsize=128)
def _build_receiver_cached(plan_key, n_rx, batched, mode, data_beta, kernels, modulation,
                           llr_scale, device):
    hop1, hop2, config, n_layers = plan_key
    plan = make_plan(hop1, hop2, config, n_layers)
    factored = mode == "factored" or (mode == "auto" and config.time_interp == "none")
    return BatchedReceiver(plan, n_rx, batched, factored, data_beta, kernels, modulation,
                           llr_scale, device)


def build_receiver_ri(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    n_rx: int,
    batched: bool = False,
    mode: str = "auto",
    data_beta: float = 1.0,
    kernels: str = "xla",
    modulation: Optional[str] = None,
    llr_scale: float = 8.0,
    device="cuda",
) -> BatchedReceiver:
    """`fn(rg_ri, pil_ri, beta[, params]) -> ReceiverResult | LlrResult` in ri
    layout, the signature of `srsran_ce_tpu.models.receiver.build_receiver_ri`
    (cached per arguments); `params` (the denoiser's, replicated) is required
    when config.smoothing is a learned mode.

    rg_ri (2, n_rx, n_sc, n_sym), one received grid per RX port; pil_ri
    (2, n_re, n_dsym, n_layers), shared; beta the pilot amplitude scale. With
    batched=True each gains a leading problem axis. Numpy inputs go to
    `device` (the card by default; the build raises when there is none);
    tensors stay on their own device.

    mode: "dense" equalizes the full per-RE grid; "factored" (time_interp
    "none" only) builds the filter once per subcarrier; "auto" picks factored
    exactly when time_interp="none". kernels: "xla" (plain torch) or "pallas"
    (K5 smoothing and, dense, the K2 fill). `data_beta` scales the data REs
    (the DM-RS boost `beta` scales only the pilots). `modulation` (one of
    ops/demap.MODULATIONS) adds the exact max-log demapper: an LlrResult with
    int8 LLRs quantized by `llr_scale`."""
    device = devices.resolve(device)
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    if mode not in ("auto", "dense", "factored"):
        raise ValueError(f"mode={mode!r}: one of 'auto', 'dense', 'factored'")
    if kernels not in ("xla", "pallas"):
        raise ValueError(f"kernels={kernels!r}: one of 'xla', 'pallas'")
    if n_rx < 1:
        raise ValueError(f"n_rx must be >= 1: {n_rx}")
    if mode == "factored" and config.time_interp != "none":
        raise ValueError("mode='factored' requires time_interp='none'")
    dsp.precision_of(config.matmul_precision)  # "high"/"highest" -> full f32; "default" raises
    if modulation is not None:
        demap.bits_per_symbol(modulation)  # validate early
    return _build_receiver_cached(
        (hop1, hop2, config, n_layers), int(n_rx), batched, mode, float(data_beta), kernels,
        modulation, float(llr_scale), device,
    )


def tracked_receiver_impl(plan, pt, rg, pil, beta, h_prev, w, data_beta: float = 1.0,
                          modulation: Optional[str] = None, llr_scale: float = 8.0):
    """Tracked multi-RX receiver over a batch: per-port tracked estimation (each
    RX port carries its own state; models/tracking.py) on the factored path,
    then the plain receiver's cross-port MMSE equalize (+ demap) tail, whose
    per-subcarrier filter is rebuilt each slot from the tracked profiles.

    rg (B, n_rx, n_sc, n_sym) complex; pil (B, n_re, n_dsym, nL) complex;
    beta (B,); h_prev a tuple (one per hop) of complex (B, n_rx, nL, n_re);
    w (B, n_rx). The (B, n_rx) pairs fold into the estimator's batch as in
    `receiver_impl`. Returns (ReceiverResult | LlrResult, h_new, w_new) in the
    state's shapes."""
    B, n_rx, n_sc, n_sym = rg.shape
    est, (h_new, w_new) = _estimate_impl(
        plan, pt, rg.reshape(B * n_rx, n_sc, n_sym),
        pil.repeat_interleave(n_rx, dim=0), beta.repeat_interleave(n_rx, dim=0),
        "xla", "factored",
        h_prev=tuple(h.reshape((B * n_rx,) + h.shape[2:]) for h in h_prev),
        track_w=w.reshape(B * n_rx),
    )
    out = _equalize_tail(plan, rg, est, True, data_beta, modulation, llr_scale)
    h_new = tuple(h.reshape((B, n_rx) + h.shape[1:]) for h in h_new)
    return out, h_new, w_new.reshape(B, n_rx)


class TrackedReceiver(BatchedReceiver):
    """`fn(rg_ri, pil_ri, beta, h_prev_ri, w) -> (result, h_new_ri, w_new)` of
    `build_tracked_receiver_ri`: the state is a tuple of per-hop ri tensors
    ([B,] n_rx, 2, nL, n_re) and the weights ([B,] n_rx)."""

    def __call__(self, rg_ri, pil_ri, beta, h_prev_ri, w):
        rg_ri, pil_ri, beta = self._inputs(rg_ri, pil_ri, beta)
        as_t = lambda a: torch.as_tensor(a, device=rg_ri.device, dtype=rg_ri.dtype)
        res, *state = self._graphed(rg_ri, pil_ri, beta, as_t(w), *(as_t(h) for h in h_prev_ri))
        return res, tuple(state[:-1]), state[-1]

    def _forward(self, rg_ri, pil_ri, beta, w, *h_prev_ri):
        """The state's hops come last; returns (result, *h_new_ri, w_new)."""
        if not self.batched:
            rg_ri, pil_ri, beta = rg_ri[None], pil_ri[None], beta.reshape(1)
            h_prev_ri, w = tuple(h[None] for h in h_prev_ri), w[None]
        with full_f32_matmul():
            res, h_new, w_new = tracked_receiver_impl(
                self.plan, self.plan_tensors(rg_ri.device, rg_ri.dtype), _ri_to_complex(rg_ri),
                _ri_to_complex(pil_ri), beta,
                tuple(torch.complex(h[:, :, 0], h[:, :, 1]) for h in h_prev_ri), w,
                self.data_beta, self.modulation, self.llr_scale,
            )
        h_new = tuple(torch.stack([h.real, h.imag], dim=2) for h in h_new)
        if not self.batched:
            h_new, w_new = tuple(h[0] for h in h_new), w_new[0]
        return (self._unbatch(res), *h_new, w_new)


@functools.lru_cache(maxsize=128)
def _build_tracked_receiver_cached(plan_key, n_rx, data_beta, modulation, llr_scale, batched,
                                   device):
    return TrackedReceiver(make_plan(*plan_key), n_rx, batched, True, data_beta, "xla",
                           modulation, llr_scale, device)


def build_tracked_receiver_ri(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    n_rx: int,
    data_beta: float = 1.0,
    modulation: Optional[str] = None,
    llr_scale: float = 8.0,
    batched: bool = False,
    device="cuda",
) -> TrackedReceiver:
    """The tracked multi-RX receiver,
    `fn(rg_ri, pil_ri, beta, h_prev_ri, w) -> (result, h_new_ri, w_new)`, the
    signature of `srsran_ce_tpu.models.receiver.build_tracked_receiver_ri`
    (cached per arguments).

    Thread the returned state into the next sounding's call; slot 0's state
    is `models.tracking.init_state(hop1, hop2, config, n_layers, batch=n_rx)`
    (weight 0: the first call equals the plain receiver). Requires
    time_interp="none" and refuses the learned smoothings, as JAX does.
    `modulation` adds the int8 demapper as in build_receiver_ri. With
    batched=True every argument, the state included, gains a leading problem
    axis. Numpy inputs go to `device` (the card by default)."""
    device = devices.resolve(device)
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    if n_rx < 1:
        raise ValueError(f"n_rx must be >= 1: {n_rx}")
    tracking.check_config(config)
    dsp.precision_of(config.matmul_precision)
    if modulation is not None:
        demap.bits_per_symbol(modulation)
    return _build_tracked_receiver_cached(
        (hop1, hop2, config, n_layers), int(n_rx), float(data_beta), modulation,
        float(llr_scale), batched, device,
    )
