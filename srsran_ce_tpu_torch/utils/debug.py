"""Numerical sanitizers of the port: `srsran_ce_tpu/utils/debug.py` in torch.

The failure modes that matter are numerical: NaN/Inf escaping a kernel,
division blowups in the virtual-pilot fit.

  checked(fn)            the callable with every output checked: a non-finite
                         value raises FloatingPointError naming the field
  assert_finite_result   host-side post-condition on an EstimateResult

The JAX module's `interpret_mode()` (every Pallas kernel through its
interpreter) has no counterpart: it would run the plain versions for CUDA
tensors, and a CUDA tensor here launches its kernel or raises, never falls
back to its plain version.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def assert_finite_result(res) -> None:
    """Host-side sanity gate on an EstimateResult (any layout)."""
    for name in ("channel_est_rg", "noise_est", "rsrp", "epre", "time_alignment"):
        a = getattr(res, name)
        a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        if not np.isfinite(a).all():
            raise FloatingPointError(f"non-finite values in {name}")
    # cfo_hz may legitimately be NaN when no hop had >= 2 DMRS symbols


def _fields(out, prefix: str = "out"):
    """(name, tensor) of every floating tensor in `out`: a tensor, a dataclass
    (its fields by name) or a tuple / list (by index), nested."""
    if torch.is_tensor(out):
        if out.is_floating_point() or out.is_complex():
            yield prefix, out
    elif dataclasses.is_dataclass(out):
        for f in dataclasses.fields(out):
            yield from _fields(getattr(out, f.name), f.name if prefix == "out" else f"{prefix}.{f.name}")
    elif isinstance(out, (tuple, list)):
        for i, v in enumerate(out):
            yield from _fields(v, f"{prefix}[{i}]")


def checked(fn, allow_nan=("cfo_hz",)):
    """`fn` with its outputs checked: the first floating output field holding
    NaN or Inf raises FloatingPointError naming it. `allow_nan` names fields
    that may be NaN (cfo_hz is NaN when no hop has two DM-RS symbols); Inf
    is never allowed."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        for name, t in _fields(out):
            bad = ~torch.isfinite(t)
            if name.split(".")[-1] in allow_nan:
                bad &= ~torch.isnan(t)
            if bool(bad.any()):
                raise FloatingPointError(f"non-finite values in {name}")
        return out

    return wrapped
