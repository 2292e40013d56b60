"""The three operations of the estimator front that need exact tie and sign
rules, with the semantics of `srsran_ce_tpu/ops/pallas/mathx.py`.

The TPU package emulates them because Mosaic cannot lower them; here they are
plain torch, and the fused front kernel (csrc/front.cu) follows the same three
rules in device code:

  atan2       — `torch.atan2` (IEEE atan2: atan2(-0.0, x<0) = -pi, (+-0, +0)
                -> +-0); never add 0.0 to an input, it would erase a signed zero;
  unwrap_last — numpy.unwrap semantics with the mathx formula: wrap each
                successive difference to [-pi, pi) by floor, map a wrapped -pi
                with positive difference to +pi (numpy's ddmod convention),
                then add the running correction;
  argmax_last — FIRST maximum along the last axis (jnp.argmax's tie rule).
"""
from __future__ import annotations

import math

import torch


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.atan2(y, x)


def unwrap_last(ph: torch.Tensor) -> torch.Tensor:
    """Phase unwrap along the last axis (period 2*pi)."""
    if ph.shape[-1] <= 1:
        return ph
    d = ph[..., 1:] - ph[..., :-1]
    dd = d - (2.0 * math.pi) * torch.floor((d + math.pi) / (2.0 * math.pi))
    dd = torch.where((dd == -math.pi) & (d > 0), torch.full_like(dd, math.pi), dd)
    corr = torch.cumsum(dd - d, dim=-1)
    return torch.cat([ph[..., :1], ph[..., 1:] + corr], dim=-1)


def argmax_last(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """First-maximum argmax along the last axis, as int64.

    torch.argmax documents no tie rule, so the first maximum is taken
    explicitly: the smallest index whose value equals the maximum."""
    m = torch.amax(x, dim=-1, keepdim=True)
    n = x.shape[-1]
    iota = torch.arange(n, device=x.device).expand_as(x)
    big = torch.full_like(iota, n)
    return torch.amin(torch.where(x == m, iota, big), dim=-1, keepdim=keepdim)
