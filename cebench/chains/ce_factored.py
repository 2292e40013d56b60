"""Channel estimation served in factored form, the estimates back on the host.

A cell-slot is one UE's DM-RS on every antenna of the radio (`gen.slots.
ce_slot`): one `serving.Problem` of (n_sc, n_sym) an antenna, the UE's ports
as layers. The call is `serving.process(problems, out="factored",
matmul_precision=..., device=...)`, leaving `batch_size` and `inflight` at
the program's defaults. Judged by `reference.ce`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from cebench.gen import slots
from cebench.reference import ce as reference

make_slot = slots.ce_slot


def server(cfg: dict, pool: list, device: str):
    """`serve(slot_ids) -> [[result an antenna] a slot]` through the program."""
    from srsran_ce_tpu_torch import config as pconfig
    from srsran_ce_tpu_torch import serving

    def problems_of(s):
        hop1 = pconfig.HopConfig(**dataclasses.asdict(s.hop1))
        hop2 = None if s.hop2 is None else pconfig.HopConfig(**dataclasses.asdict(s.hop2))
        conf = pconfig.EstimatorConfig(**dataclasses.asdict(s.config))
        return [serving.Problem(np.ascontiguousarray(s.rg[r]), s.pilots, s.beta, hop1, hop2, conf)
                for r in range(s.rg.shape[0])]

    per_slot = [problems_of(s) for s in pool]
    n_rx = int(cfg["n_rx"])
    kwargs = dict(out=cfg["out"], matmul_precision=cfg["matmul_precision"], device=device)

    def serve(slot_ids):
        res = serving.process([p for i in slot_ids for p in per_slot[i]], **kwargs)
        return [res[k * n_rx:(k + 1) * n_rx] for k in range(len(slot_ids))]

    return serve
