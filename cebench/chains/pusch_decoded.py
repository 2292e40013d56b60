"""The PUSCH receive chain served to the decoded payload on the card.

A cell-slot is one UE's slot with every receive antenna (`gen.slots.
pusch_slot`): one `serving.Problem` of (n_rx, n_sc, n_sym). The call is
`serving.process(problems, out="decoded", modulation=..., coding=...,
decode_on_device=True, matmul_precision=..., device=...)`, leaving
`batch_size` and `inflight` at the program's defaults; every problem of a call
shares the configuration's one coding. Judged by `reference.pusch`.
"""
from __future__ import annotations

import dataclasses

from cebench.gen import slots
from cebench.reference import pusch as reference

make_slot = slots.pusch_slot


def server(cfg: dict, pool: list, device: str):
    """`serve(slot_ids) -> [[result] a slot]` through the program."""
    from srsran_ce_tpu_torch import config as pconfig
    from srsran_ce_tpu_torch import serving, transport
    from srsran_ce_tpu_torch.ops import nr_ldpc

    dec = cfg["decoder"]
    coding = transport.TransportCoding(
        code=nr_ldpc.nr_base_graph(int(cfg["ldpc_bg"]), int(cfg["ldpc_z"])), rate_match="nr",
        tx_bits=int(cfg["e_bits_per_block"]), crc=cfg["crc"], n_filler=int(cfg.get("n_filler", 0)),
        interleave_seed=int(cfg["interleave_seed"]), scramble_c_init=slots.scramble_c_init(cfg),
        schedule=dec["schedule"], n_iters=int(dec["n_iters"]),
        layered_group=int(dec["layered_group"]), stream_c2v_dtype=dec["c2v_dtype"],
        kernels=dec["kernels"],
    )

    def problem(s):
        hop2 = None if s.hop2 is None else pconfig.HopConfig(**dataclasses.asdict(s.hop2))
        return serving.Problem(s.rg, s.pilots, s.beta,
                               pconfig.HopConfig(**dataclasses.asdict(s.hop1)), hop2,
                               pconfig.EstimatorConfig(**dataclasses.asdict(s.config)))

    problems = [problem(s) for s in pool]
    kwargs = dict(out="decoded", modulation=cfg["modulation"], coding=coding,
                  decode_on_device=bool(cfg["decode_on_device"]),
                  matmul_precision=cfg["matmul_precision"], device=device)

    def serve(slot_ids):
        res = serving.process([problems[i] for i in slot_ids], **kwargs)
        return [[r] for r in res]

    return serve
