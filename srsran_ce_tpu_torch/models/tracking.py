"""Multi-slot channel tracking of the port: `srsran_ce_tpu/models/tracking.py` in torch.

Real deployments sound SRS/DM-RS periodically, and the channel between
soundings is correlated. A first-order adaptive tracker blends each slot's
pilot estimates with the tracked state,

  h_track <- h_prev + a * (h_obs - h_prev),

with a per-problem gain from two runtime statistics (the adjacent-difference
noise proxy and the innovation; `estimator._track_blend`): the running average
1/(w+1) on a static channel, snapping back toward 1 when the channel moves.
The scalar metrics (noise, RSRP, EPRE, TA, CFO) stay single-slot.

The state is ri-layout tensors: a tuple with one (B, 2, nL, n_re) pilot-lattice
estimate per hop, and the (B,) weights w. `init_state` gives slot 0's (w = 0:
the first call passes its observation through); thread the returned state into
the next call. Tracking runs the plain tier, as the JAX builder hard-codes
kernels="xla".
"""
from __future__ import annotations

import functools
from dataclasses import fields
from typing import Optional

import torch

from .. import devices
from ..config import EstimatorConfig, HopConfig
from ..ops import dsp
from ..ops.kernels import full_f32_matmul
from . import estimator as _est
from .plan import make_plan


def init_state(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    batch: Optional[int] = None,
    dtype=torch.float32,
    device="cuda",
):
    """Zero tracking state (h_prev_ri tuple, w) on `device` (the card by
    default): per hop ([batch,] 2, n_layers, n_re), and w ([batch],)."""
    device = devices.resolve(device)
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    plan = make_plan(hop1, hop2, config, n_layers)
    hops = [plan.hop1] + ([plan.hop2] if plan.hop2 is not None else [])
    lead = () if batch is None else (batch,)
    h = tuple(torch.zeros(lead + (2, n_layers, hp.n_re), dtype=dtype, device=device)
              for hp in hops)
    return h, torch.zeros(lead, dtype=dtype, device=device)


def check_config(config: EstimatorConfig) -> None:
    """The JAX builders' refusals: tracking needs time_interp="none" and does
    not take the learned smoothings."""
    if config.time_interp != "none":
        raise ValueError("tracking requires time_interp='none'")
    if config.smoothing in ("learned", "learned2d"):
        raise ValueError(f"tracking does not take smoothing={config.smoothing!r} (as in JAX)")


class TrackedEstimator(_est.BatchedEstimator):
    """`fn(rg_ri, pil_ri, beta, h_prev_ri, w) -> (result, h_new_ri, w_new)` of
    `build_tracked_ri`, on the plain tier. Tensors stay on their device
    (numpy inputs go to the build's `device`); the plan's tensors are built
    once per (device, dtype)."""

    def __init__(self, plan, batched: bool, out_layout: str, device: torch.device):
        super().__init__(plan, batched, "xla", out_layout)
        self.device = device

    def __call__(self, rg_ri, pil_ri, beta, h_prev_ri, w):
        rg_ri = rg_ri if torch.is_tensor(rg_ri) else torch.as_tensor(rg_ri, device=self.device)
        dev, dt = rg_ri.device, rg_ri.dtype
        if dt not in (torch.float32, torch.float64):
            raise TypeError(f"the tracked estimator takes float32 or float64 ri tensors, not {dt}")
        as_t = lambda a: torch.as_tensor(a, device=dev, dtype=dt)
        pil_ri, beta, w = as_t(pil_ri), as_t(beta), as_t(w)
        h_prev_ri = tuple(as_t(h) for h in h_prev_ri)
        if not self.batched:
            rg_ri, pil_ri, beta, w = rg_ri[None], pil_ri[None], beta.reshape(1), w.reshape(1)
            h_prev_ri = tuple(h[None] for h in h_prev_ri)
        with full_f32_matmul():
            res, (h_new, w_new) = _est._estimate_impl(
                self.plan, self.plan_tensors(dev, dt), _est._ri_to_complex(rg_ri),
                _est._ri_to_complex(pil_ri), beta, "xla", self.out_layout,
                h_prev=tuple(_est._ri_to_complex(h) for h in h_prev_ri), track_w=w,
            )
        h_new = tuple(_est._complex_to_ri(h) for h in h_new)
        if not self.batched:
            res = type(res)(*(getattr(res, f.name)[0] for f in fields(res)))
            h_new, w_new = tuple(h[0] for h in h_new), w_new[0]
        return res, h_new, w_new


@functools.lru_cache(maxsize=256)
def _build_tracked_cached(plan_key, batched: bool, out_layout: str, device: torch.device):
    return TrackedEstimator(make_plan(*plan_key), batched, out_layout, device)


def build_tracked_ri(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    batched: bool = False,
    out_layout: str = "ref",
    device="cuda",
) -> TrackedEstimator:
    """The tracking estimator,
    `fn(rg_ri, pil_ri, beta, h_prev_ri, w) -> (result, h_new_ri, w_new)`, the
    signature of `srsran_ce_tpu.models.tracking.build_tracked_ri` (cached on
    its arguments).

    All arrays ri layout; with batched=True every argument gains a leading
    problem axis (the state too) and the problems track independently.
    out_layout is "ref", "serve" or "factored" (a FactoredResult: tracking
    already requires time_interp="none"). Numpy inputs go to `device` (the
    card by default; the build raises when there is none)."""
    device = devices.resolve(device)
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    if out_layout not in ("ref", "serve", "factored"):
        raise ValueError(f"out_layout={out_layout!r}: one of 'ref', 'serve', 'factored'")
    check_config(config)
    dsp.precision_of(config.matmul_precision)  # "high"/"highest" -> full f32; "default" raises
    return _build_tracked_cached((hop1, hop2, config, n_layers), batched, out_layout, device)
