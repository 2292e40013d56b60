"""Entry point of the port: the flagship c2 case through the batched serve estimator.

Counterpart of `__graft_entry__.entry()`: 106 PRB, 4 layers, comb 2, 30 kHz,
at matmul_precision="high", through `models.estimator.build_ri(...,
batched=True, out_layout="serve", kernels="pallas_front")`. On the card
(the default `device`) the two kernels run; with device="cpu" their plain
versions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import devices
from .models import estimator
from .utils import synthetic


def entry(device="cuda", batch: int = 8):
    """(forward, (rg_ri, pil_ri, beta)): the batched serve estimator of the c2
    case at matmul_precision="high" and the case tiled to `batch` problems, as
    float32 ri tensors on `device` (the card by default; raises when there is
    none: pass device="cpu" for the plain versions on the CPU)."""
    device = devices.resolve(device)
    case = synthetic.make_case(
        seed=0, n_prbs=106, n_layers=4, comb=2, scs_hz=30e3, snr_db=30.0
    )
    rg = estimator.split_ri(case.received_rg.astype(np.complex64))
    pil = estimator.split_ri(case.pilots.astype(np.complex64))
    rg_b = torch.as_tensor(np.broadcast_to(rg, (batch,) + rg.shape).copy(), device=device)
    pil_b = torch.as_tensor(np.broadcast_to(pil, (batch,) + pil.shape).copy(), device=device)
    beta = torch.ones(batch, dtype=torch.float32, device=device)
    cfg = dataclasses.replace(case.config, matmul_precision="high")
    forward = estimator.build_ri(
        case.hop1, case.hop2, cfg, 4, batched=True, out_layout="serve", kernels="pallas_front"
    )
    return forward, (rg_b, pil_b, beta)
